// Flash-attention backward over packed segments, for Hopper (sm_90a).
//
// Replaces the TPU kernels realhf_tpu/ops/flash_attention.py
// `_bwd_dq_kernel` (K2) and `_bwd_dkv_kernel` (K3), launched by
// `_flash_bwd`: the backward of the forward in flash_fwd.cu (K1). The
// probabilities are recomputed from the forward's saved log-sum-exp,
//   p  = exp(scale * q.k - lse)          where the mask allows (q, k), else 0
//   ds = p * (do.v - delta)              delta = rowsum(o * do), computed
//                                        beside the kernels (as JAX does)
//   dq = scale * sum_k ds k              (K2)
//   dv = sum_q p do,  dk = scale * sum_q ds q, each summed over every
//   q head of the KV head's GQA group    (K3)
// with the forward's mask: same non-zero segment id and, when causal,
// the key not later in the stream. A row whose lse is NEG_INF (it saw no
// valid key) contributes 0, never NaN.
//
// Layouts (row-major, contiguous): q/do/dq [B, L, nq, hd], k/v/dk/dv
// [B, L, nkv, hd], seg [B, L] int32 (0 = padding), lse/delta [B, nq, L]
// fp32. bf16 in and out; every sum is fp32.
//
// Structure: the TPU's two passes, so nothing needs atomics and every run
// gives the same bits. K2: one CTA of 4 warps per (q tile of 64 rows, q
// head, batch row), looping over the 64-key tiles up to the causal
// diagonal. K3: one CTA per (key tile of 64, KV head, batch row), looping
// over the q heads of its group and, for each, over the q tiles from the
// diagonal on; summing the group inside the CTA replaces the TPU's
// [B, nq, L, hd] fp32 per-head partials and the reduction after them.
// Each warp owns 16 rows of the CTA's tile end to end (16 q rows in K2,
// 16 key rows in K3), so only the staging of the streamed tiles needs
// block-wide barriers. The products run on the tensor cores through WMMA
// 16x16x16 bf16 fragments with fp32 accumulators; the output accumulators
// stay in registers for the whole loop; p and ds are rounded to bf16 for
// the products that consume them, as in flash-attention 2. Any L works:
// rows past L are zero-filled (0 x garbage could be NaN) and masked.
//
// What bounds it on the H100: per allowed (q, k) pair and q head K2 does
// ~6 hd FLOPs (q.k, do.v, ds.k) and K3 ~8 hd (q.k, do.v, p.do, ds.q);
// their bytes are the q/k/v/do rows of tokens with seg != 0, lse/delta
// once, and the outputs once. At the SFT shape (one ~4 k-token stream of
// 8 segments, 32 heads of 128) that is 29 GFLOP against 167 MB (K2) and
// 38 GFLOP against 201 MB (K3), under the bf16 ridge point (~295
// FLOP/byte): both are bound by bytes, at ~50-60 us. This first version
// is right and simple, not fast: it computes every tile up to the causal
// diagonal whatever its segments (~7x the allowed pairs at that shape),
// scores round-trip through shared memory and nothing overlaps the tile
// loads. Skipping the tiles of segments that cannot match, then TMA +
// wgmma with register-resident scores, are the later work, as for K1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#define NEG_INF (-1073741824.0f)  // -2^30, the JAX package's sentinel

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS_PER_WARP = 16;  // one WMMA row block

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> AFrag;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> BRowFrag;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> BColFrag;

// Padded leading dimensions: multiples of 8 (bf16) / 4 (fp32) as WMMA
// requires, and off the 128-byte period to spread shared-memory banks.
// Every region below starts on a 32-byte boundary (WMMA's alignment).
template <int HD>
struct Pad {
  static constexpr int LDB = HD + 8;  // bf16 q / k / v / do tiles
  static constexpr int LDS = 64 + 4;  // fp32 score-shaped tiles
  static constexpr int LDP = 64 + 8;  // bf16 p / ds tiles
  static constexpr int LDO = HD + 4;  // fp32 output staging
  static constexpr size_t TILE_B = sizeof(bf16) * 64 * LDB;
  static constexpr size_t TILE_S = sizeof(float) * 64 * LDS;
  static constexpr size_t TILE_P = sizeof(bf16) * 64 * LDP;
  static_assert(sizeof(float) * 64 * LDO <= 2 * TILE_S, "staging fits");
  static_assert(sizeof(float) * 64 * LDO <= 2 * TILE_B, "staging fits");
};

template <int HD>
struct DqLayout : Pad<HD> {
  using P = Pad<HD>;
  static constexpr size_t Q = 0;
  static constexpr size_t DO = Q + P::TILE_B;
  static constexpr size_t K = DO + P::TILE_B;
  static constexpr size_t V = K + P::TILE_B;
  static constexpr size_t S = V + P::TILE_B;   // then DP: staging for dq
  static constexpr size_t DP = S + P::TILE_S;
  static constexpr size_t DS = DP + P::TILE_S;
  static constexpr size_t LSE = DS + P::TILE_P;
  static constexpr size_t DELTA = LSE + sizeof(float) * BQ;
  static constexpr size_t SEGQ = DELTA + sizeof(float) * BQ;
  static constexpr size_t SEGK = SEGQ + sizeof(int) * BQ;
  static constexpr size_t TOTAL = SEGK + sizeof(int) * BK;
};

template <int HD>
struct DkvLayout : Pad<HD> {
  using P = Pad<HD>;
  static constexpr size_t K = 0;
  static constexpr size_t V = K + P::TILE_B;
  static constexpr size_t Q = V + P::TILE_B;   // then DO: staging for dv
  static constexpr size_t DO = Q + P::TILE_B;
  static constexpr size_t ST = DO + P::TILE_B;  // then DPT: staging for dk
  static constexpr size_t DPT = ST + P::TILE_S;
  static constexpr size_t PT = DPT + P::TILE_S;
  static constexpr size_t DST = PT + P::TILE_P;
  static constexpr size_t LSE = DST + P::TILE_P;
  static constexpr size_t DELTA = LSE + sizeof(float) * BQ;
  static constexpr size_t SEGQ = DELTA + sizeof(float) * BQ;
  static constexpr size_t SEGK = SEGQ + sizeof(int) * BQ;
  static constexpr size_t TOTAL = SEGK + sizeof(int) * BK;
};

// Copy rows [t0, t0 + 64) of one head of a [B, L, heads, HD] tensor into
// a padded shared tile with 16-byte loads; rows past L are zero.
template <int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, size_t row_stride,
                                           int t0, int L, int tid) {
  constexpr int CHUNKS = HD / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < 64 * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS, t = t0 + r;
    uint4 val = zero;
    if (t < L) val = *reinterpret_cast<const uint4*>(src + (size_t)t * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * Pad<HD>::LDB + c * 8) = val;
  }
}

// out[r0 .. r0+15, 0 .. 63] = A[r0 .. r0+15, :] . B[0 .. 63, :]^T over HD:
// A and B are padded bf16 row tiles, so B^T is B read column-major.
template <int HD>
__device__ __forceinline__ void rows_times_tile_t(float* out, const bf16* A, const bf16* B,
                                                  int r0) {
  constexpr int LDB = Pad<HD>::LDB, LDS = Pad<HD>::LDS;
  AccFrag acc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    AFrag a;
    wmma::load_matrix_sync(a, A + r0 * LDB + kk * 16, LDB);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      BColFrag bt;
      wmma::load_matrix_sync(bt, B + n * 16 * LDB + kk * 16, LDB);
      wmma::mma_sync(acc[n], a, bt, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(out + r0 * LDS + n * 16, acc[n], LDS, wmma::mem_row_major);
}

// acc[n] += W[r0 .. r0+15, 0 .. 63] . X[0 .. 63, n*16 .. n*16+15] for every
// n: W a padded bf16 [64 x 64] tile (p or ds), X a padded bf16 row tile.
template <int HD>
__device__ __forceinline__ void accumulate_rows(AccFrag (&acc)[HD / 16], const bf16* W,
                                                const bf16* X, int r0) {
  constexpr int LDB = Pad<HD>::LDB, LDP = Pad<HD>::LDP;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    AFrag a;
    wmma::load_matrix_sync(a, W + r0 * LDP + kk * 16, LDP);
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      BRowFrag bx;
      wmma::load_matrix_sync(bx, X + kk * 16 * LDB + n * 16, LDB);
      wmma::mma_sync(acc[n], a, bx, acc[n]);
    }
  }
}

// Write one warp's 16 accumulated rows (times `mul`) as bf16 to rows
// t0 + r0 .. of a [B, L, heads, HD] tensor, through fp32 staging.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, size_t row_stride, float* stage,
                                           AccFrag (&acc)[HD / 16], float mul, int t0,
                                           int r0, int L, int lane) {
  constexpr int LDO = Pad<HD>::LDO, CHUNKS = HD / 8;
#pragma unroll
  for (int n = 0; n < HD / 16; ++n)
    wmma::store_matrix_sync(stage + r0 * LDO + n * 16, acc[n], LDO, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < ROWS_PER_WARP * CHUNKS; i += 32) {
    const int r = r0 + i / CHUNKS, c = i % CHUNKS, t = t0 + r;
    if (t >= L) continue;
    __align__(16) bf16 vals[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) vals[e] = __float2bfloat16(stage[r * LDO + c * 8 + e] * mul);
    *reinterpret_cast<uint4*>(dst + (size_t)t * row_stride + c * 8) =
        *reinterpret_cast<const uint4*>(vals);
  }
}

// ---------------------------------------------------------------------
// K2: dq
// ---------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ seg,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, int L, int nq,
                    int nkv, float scale, int causal) {
  using LY = DqLayout<HD>;
  constexpr int LDS = LY::LDS, LDP = LY::LDP;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + LY::Q);
  bf16* DOs = reinterpret_cast<bf16*>(smem + LY::DO);
  bf16* Ks = reinterpret_cast<bf16*>(smem + LY::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + LY::V);
  float* Ss = reinterpret_cast<float*>(smem + LY::S);
  float* DPs = reinterpret_cast<float*>(smem + LY::DP);
  bf16* DSs = reinterpret_cast<bf16*>(smem + LY::DS);
  float* lse_s = reinterpret_cast<float*>(smem + LY::LSE);
  float* delta_s = reinterpret_cast<float*>(smem + LY::DELTA);
  int* segq = reinterpret_cast<int*>(smem + LY::SEGQ);
  int* segk = reinterpret_cast<int*>(smem + LY::SEGK);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (nq / nkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * ROWS_PER_WARP;

  const size_t q_row = (size_t)nq * HD;
  const size_t kv_row = (size_t)nkv * HD;
  const size_t q_off = (size_t)b * L * q_row + (size_t)h * HD;
  const bf16* kb = k + (size_t)b * L * kv_row + (size_t)kvh * HD;
  const bf16* vb = v + (size_t)b * L * kv_row + (size_t)kvh * HD;
  const int* segb = seg + (size_t)b * L;
  const size_t stat_off = ((size_t)b * nq + h) * L;

  stage_rows<HD>(Qs, q + q_off, q_row, q0, L, tid);
  stage_rows<HD>(DOs, dout + q_off, q_row, q0, L, tid);
  for (int r = tid; r < BQ; r += NTHREADS) {
    const int t = q0 + r;
    segq[r] = t < L ? segb[t] : 0;
    lse_s[r] = t < L ? lse[stat_off + t] : NEG_INF;
    delta_s[r] = t < L ? delta[stat_off + t] : 0.f;
  }

  AccFrag acc[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  const int n_tiles_all = (L + BK - 1) / BK;
  const int n_tiles = causal ? min((q0 + BQ + BK - 1) / BK, n_tiles_all) : n_tiles_all;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    stage_rows<HD>(Ks, kb, kv_row, k0, L, tid);
    stage_rows<HD>(Vs, vb, kv_row, k0, L, tid);
    for (int r = tid; r < BK; r += NTHREADS) {
      const int t = k0 + r;
      segk[r] = t < L ? segb[t] : 0;  // seg 0 never matches a valid query
    }
    __syncthreads();

    rows_times_tile_t<HD>(Ss, Qs, Ks, r0);    // S  = Q K^T
    rows_times_tile_t<HD>(DPs, DOs, Vs, r0);  // dP = dO V^T
    __syncwarp();

    // p and ds, one row at a time; lane owns columns lane, lane + 32.
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = r0 + rr;
      const int qi = q0 + r;
      const int sq = segq[r];
      const float l = lse_s[r];
      const float dl = delta_s[r];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c;
        const bool keep = sq != 0 && segk[col] == sq && (!causal || qi >= k0 + col) &&
                          l > NEG_INF / 2;
        const float p = keep ? expf(Ss[r * LDS + col] * scale - l) : 0.f;
        DSs[r * LDP + col] = __float2bfloat16(p * (DPs[r * LDS + col] - dl));
      }
    }
    __syncwarp();

    accumulate_rows<HD>(acc, DSs, Ks, r0);  // dq += dS K
  }
  __syncthreads();  // the staging below overwrites other warps' S / dP rows
  store_rows<HD>(dq + q_off, q_row, Ss, acc, scale, q0, r0, L, lane);
}

// ---------------------------------------------------------------------
// K3: dk, dv (the GQA group summed inside the CTA)
// ---------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ seg,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int L, int nq, int nkv, float scale, int causal) {
  using LY = DkvLayout<HD>;
  constexpr int LDS = LY::LDS, LDP = LY::LDP;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + LY::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + LY::V);
  bf16* Qs = reinterpret_cast<bf16*>(smem + LY::Q);
  bf16* DOs = reinterpret_cast<bf16*>(smem + LY::DO);
  float* STs = reinterpret_cast<float*>(smem + LY::ST);
  float* DPTs = reinterpret_cast<float*>(smem + LY::DPT);
  bf16* PTs = reinterpret_cast<bf16*>(smem + LY::PT);
  bf16* DSTs = reinterpret_cast<bf16*>(smem + LY::DST);
  float* lse_s = reinterpret_cast<float*>(smem + LY::LSE);
  float* delta_s = reinterpret_cast<float*>(smem + LY::DELTA);
  int* segq = reinterpret_cast<int*>(smem + LY::SEGQ);
  int* segk = reinterpret_cast<int*>(smem + LY::SEGK);

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = nq / nkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * ROWS_PER_WARP;

  const size_t q_row = (size_t)nq * HD;
  const size_t kv_row = (size_t)nkv * HD;
  const size_t kv_off = (size_t)b * L * kv_row + (size_t)kvh * HD;
  const int* segb = seg + (size_t)b * L;

  stage_rows<HD>(Ks, k + kv_off, kv_row, k0, L, tid);
  stage_rows<HD>(Vs, v + kv_off, kv_row, k0, L, tid);
  for (int r = tid; r < BK; r += NTHREADS) {
    const int t = k0 + r;
    segk[r] = t < L ? segb[t] : 0;
  }

  AccFrag dk_acc[HD / 16], dv_acc[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  const int n_q_tiles = (L + BQ - 1) / BQ;
  // The first q tile that can hold a query at or after this key tile's
  // first key: the forward's causal stop seen from the key side.
  const int start = causal ? k0 / BQ : 0;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const size_t q_off = (size_t)b * L * q_row + (size_t)h * HD;
    const size_t stat_off = ((size_t)b * nq + h) * L;
    for (int i = start; i < n_q_tiles; ++i) {
      const int q0 = i * BQ;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      stage_rows<HD>(Qs, q + q_off, q_row, q0, L, tid);
      stage_rows<HD>(DOs, dout + q_off, q_row, q0, L, tid);
      for (int r = tid; r < BQ; r += NTHREADS) {
        const int t = q0 + r;
        segq[r] = t < L ? segb[t] : 0;
        lse_s[r] = t < L ? lse[stat_off + t] : NEG_INF;
        delta_s[r] = t < L ? delta[stat_off + t] : 0.f;
      }
      __syncthreads();

      rows_times_tile_t<HD>(STs, Ks, Qs, r0);    // S^T  = K Q^T
      rows_times_tile_t<HD>(DPTs, Vs, DOs, r0);  // dP^T = V dO^T
      __syncwarp();

      // p^T and ds^T for this warp's 16 keys; lane owns q columns lane,
      // lane + 32.
      for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
        const int r = r0 + rr;
        const int kj = k0 + r;
        const int sk = segk[r];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = lane + 32 * c;
          const int sq = segq[col];
          const float l = lse_s[col];
          const bool keep = sq != 0 && sq == sk && (!causal || q0 + col >= kj) &&
                            l > NEG_INF / 2;
          const float p = keep ? expf(STs[r * LDS + col] * scale - l) : 0.f;
          PTs[r * LDP + col] = __float2bfloat16(p);
          DSTs[r * LDP + col] = __float2bfloat16(p * (DPTs[r * LDS + col] - delta_s[col]));
        }
      }
      __syncwarp();

      accumulate_rows<HD>(dv_acc, PTs, DOs, r0);  // dv += P^T dO
      accumulate_rows<HD>(dk_acc, DSTs, Qs, r0);  // dk += dS^T Q
    }
  }
  __syncthreads();  // the staging below overwrites tiles other warps read
  bf16* dkb = dk + kv_off;
  bf16* dvb = dv + kv_off;
  store_rows<HD>(dkb, kv_row, STs, dk_acc, scale, k0, r0, L, lane);
  store_rows<HD>(dvb, kv_row, reinterpret_cast<float*>(smem + LY::Q), dv_acc, 1.f, k0, r0,
                 L, lane);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* seg, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int L, int nq, int nkv,
              float scale, int causal, cudaStream_t stream) {
  const size_t smem = DqLayout<HD>::TOTAL;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + BQ - 1) / BQ, nq, B);
  flash_bwd_dq_kernel<HD><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), L, nq, nkv, scale, causal);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* seg,
               const void* dout, const void* lse, const void* delta, void* dk, void* dv,
               int B, int L, int nq, int nkv, float scale, int causal, cudaStream_t stream) {
  const size_t smem = DkvLayout<HD>::TOTAL;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + BK - 1) / BK, nkv, B);
  flash_bwd_dkv_kernel<HD><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), L, nq, nkv, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points return a cudaError_t code (0 = launched), allocate
// nothing and run on `stream` without synchronising.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* seg,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dq, int B, int L, int nq, int nkv, int hd, float scale,
                                 int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch_dq<128>(q, k, v, seg, dout, lse, delta, dq, B, L, nq, nkv, scale, causal, st);
  if (hd == 64)
    return launch_dq<64>(q, k, v, seg, dout, lse, delta, dq, B, L, nq, nkv, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* seg,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int L, int nq, int nkv, int hd,
                                  float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch_dkv<128>(q, k, v, seg, dout, lse, delta, dk, dv, B, L, nq, nkv, scale,
                           causal, st);
  if (hd == 64)
    return launch_dkv<64>(q, k, v, seg, dout, lse, delta, dk, dv, B, L, nq, nkv, scale,
                          causal, st);
  return (int)cudaErrorInvalidValue;
}
