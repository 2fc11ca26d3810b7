// Flash-attention forward over packed segments, for Hopper (sm_90a).
//
// Replaces the TPU kernel realhf_tpu/ops/flash_attention.py `_fwd_kernel`
// (launched by `_flash_fwd`, public entry `flash_attention`): tiled
// online-softmax attention (the flash-attention-2 schedule) where a
// query attends to a key iff both carry the same non-zero segment id and,
// when causal, the key is not later in the stream. GQA: q head h reads
// KV head h / (nq / nkv). Outputs o (bf16) and the per-row log-sum-exp
// (fp32, kept for the backward pass). A row that never sees a valid key
// gets o = 0 and lse = NEG_INF, never NaN.
//
// Layouts (row-major, contiguous): q/o [B, L, nq, hd], k/v [B, L, nkv, hd],
// seg [B, L] int32 (0 = padding), lse [B, nq, L].
//
// What bounds it on the H100: at the prefill shape of a LLaMA-7B layer
// (B 8, L 512, 32 heads, hd 128, causal) the work is ~17 GFLOP against
// 67 MB of q/k/v/o, i.e. ~250 FLOP/byte -- near the bf16 ridge point
// (~295), so both bounds are ~20 us. The design: one CTA of 4 warps per
// (q tile of 64 rows, q head, batch row), so any L works (the ragged last
// tile is masked here, not by a caller-side padding rule); K/V tiles of
// 64 keys are staged in shared memory with 16-byte loads and the loop
// over them stops at the causal diagonal; QK^T and PV run on the tensor
// cores through WMMA 16x16x16 bf16 fragments with fp32 accumulation; the
// softmax statistics and the output accumulator stay fp32 in shared
// memory. Each warp owns 16 query rows end to end, so only the K/V
// staging needs block-wide barriers.
//
// Later work (not needed for correctness): TMA + wgmma with a producer
// warp and a ring of K/V stages, the accumulator kept in registers, and
// skipping key tiles whose segments cannot match.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#define NEG_INF (-1073741824.0f)  // -2^30, the JAX package's sentinel

namespace {

constexpr int BQ = 64;   // query rows per CTA
constexpr int BK = 64;   // keys per staged tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS_PER_WARP = BQ / NWARPS;  // 16: one WMMA row block

template <int HD>
struct Layout {
  // Padded leading dimensions: multiples of 8 (bf16) / 4 (fp32) as WMMA
  // requires, and off the 128-byte period to spread shared-memory banks.
  static constexpr int LDB = HD + 8;  // bf16 Q, K, V tiles
  static constexpr int LDS = BK + 4;  // fp32 scores
  static constexpr int LDP = BK + 8;  // bf16 probabilities
  static constexpr int LDO = HD + 4;  // fp32 output accumulator
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + sizeof(bf16) * BQ * LDB;
  static constexpr size_t V = K + sizeof(bf16) * BK * LDB;
  static constexpr size_t S = V + sizeof(bf16) * BK * LDB;
  static constexpr size_t P = S + sizeof(float) * BQ * LDS;
  static constexpr size_t O = P + sizeof(bf16) * BQ * LDP;
  static constexpr size_t M = O + sizeof(float) * BQ * LDO;
  static constexpr size_t LSUM = M + sizeof(float) * BQ;
  static constexpr size_t ALPHA = LSUM + sizeof(float) * BQ;
  static constexpr size_t SEGQ = ALPHA + sizeof(float) * BQ;
  static constexpr size_t SEGK = SEGQ + sizeof(int) * BQ;
  static constexpr size_t TOTAL = SEGK + sizeof(int) * BK;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg,
                 bf16* __restrict__ o, float* __restrict__ lse, int L, int nq,
                 int nkv, float scale, int causal) {
  using LY = Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + LY::Q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + LY::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + LY::V);
  float* Ss = reinterpret_cast<float*>(smem + LY::S);
  bf16* Ps = reinterpret_cast<bf16*>(smem + LY::P);
  float* Os = reinterpret_cast<float*>(smem + LY::O);
  float* m_s = reinterpret_cast<float*>(smem + LY::M);
  float* l_s = reinterpret_cast<float*>(smem + LY::LSUM);
  float* a_s = reinterpret_cast<float*>(smem + LY::ALPHA);
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

  const size_t q_row = (size_t)nq * HD;   // elements between tokens of q/o
  const size_t kv_row = (size_t)nkv * HD;  // elements between tokens of k/v
  const bf16* qb = q + (size_t)b * L * q_row + (size_t)h * HD;
  const bf16* kb = k + (size_t)b * L * kv_row + (size_t)kvh * HD;
  const bf16* vb = v + (size_t)b * L * kv_row + (size_t)kvh * HD;
  const int* segb = seg + (size_t)b * L;
  constexpr int CHUNKS = HD / 8;  // 16-byte chunks per row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < BQ * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS, t = q0 + r;
    uint4 val = zero;
    if (t < L) val = *reinterpret_cast<const uint4*>(qb + (size_t)t * q_row + c * 8);
    *reinterpret_cast<uint4*>(Qs + r * LY::LDB + c * 8) = val;
  }
  for (int r = tid; r < BQ; r += NTHREADS) {
    const int t = q0 + r;
    segq[r] = t < L ? segb[t] : 0;
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  for (int i = tid; i < BQ * LY::LDO; i += NTHREADS) Os[i] = 0.f;

  const int n_tiles_all = (L + BK - 1) / BK;
  const int n_tiles = causal ? min((q0 + BQ + BK - 1) / BK, n_tiles_all) : n_tiles_all;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < BK * CHUNKS; i += NTHREADS) {
      const int r = i / CHUNKS, c = i % CHUNKS, t = k0 + r;
      uint4 kv = zero, vv = zero;  // zero rows past L: 0 * garbage could be NaN
      if (t < L) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)t * kv_row + c * 8);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)t * kv_row + c * 8);
      }
      *reinterpret_cast<uint4*>(Ks + r * LY::LDB + c * 8) = kv;
      *reinterpret_cast<uint4*>(Vs + r * LY::LDB + c * 8) = vv;
    }
    for (int r = tid; r < BK; r += NTHREADS) {
      const int t = k0 + r;
      segk[r] = t < L ? segb[t] : 0;  // seg 0 never matches a valid query
    }
    __syncthreads();

    // Scores of this warp's 16 rows against the tile: S = Q K^T.
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + r0 * LY::LDB + kk * 16, LY::LDB);
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
          // K^T as a column-major [HD, BK] operand is K row-major.
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
          wmma::load_matrix_sync(bt, Ks + n * 16 * LY::LDB + kk * 16, LY::LDB);
          wmma::mma_sync(acc[n], a, bt, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BK / 16; ++n)
        wmma::store_matrix_sync(Ss + r0 * LY::LDS + n * 16, acc[n], LY::LDS,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax, one row at a time; lane owns columns lane, lane + 32.
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = r0 + rr;
      const int qi = q0 + r;
      const int sq = segq[r];
      float s[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c;
        const bool keep = sq != 0 && segk[col] == sq && (!causal || qi >= k0 + col);
        s[c] = keep ? Ss[r * LY::LDS + col] * scale : NEG_INF;
      }
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s[0], s[1])));
      // A row that has seen no valid key keeps m == NEG_INF: its p = 1
      // garbage is wiped by alpha = 0 once a valid key arrives, or zeroed
      // in the epilogue if none ever does.
      const float p0 = expf(s[0] - m_new);
      const float p1 = expf(s[1] - m_new);
      const float psum = warp_sum(p0 + p1);
      const float alpha = expf(m_old - m_new);
      Ps[r * LY::LDP + lane] = __float2bfloat16(p0);
      Ps[r * LY::LDP + lane + 32] = __float2bfloat16(p1);
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + psum;
        a_s[r] = alpha;
      }
      __syncwarp();
    }

    // O = alpha * O + P V for this warp's rows.
    for (int i = lane; i < ROWS_PER_WARP * HD; i += 32) {
      const int rr = i / HD, c = i % HD;
      Os[(r0 + rr) * LY::LDO + c] *= a_s[r0 + rr];
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      wmma::load_matrix_sync(oacc, Os + r0 * LY::LDO + n * 16, LY::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Ps + r0 * LY::LDP + kk * 16, LY::LDP);
        wmma::load_matrix_sync(bv, Vs + kk * 16 * LY::LDB + n * 16, LY::LDB);
        wmma::mma_sync(oacc, a, bv, oacc);
      }
      wmma::store_matrix_sync(Os + r0 * LY::LDO + n * 16, oacc, LY::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncwarp();

  // Epilogue: normalise, zero rows that saw no valid key, write o and lse.
  for (int i = lane; i < ROWS_PER_WARP * CHUNKS; i += 32) {
    const int rr = i / CHUNKS, c = i % CHUNKS;
    const int r = r0 + rr, t = q0 + r;
    if (t >= L) continue;
    const float m = m_s[r], l = l_s[r];
    const bool valid = m > NEG_INF / 2;
    const float safe_l = l > 0.f ? l : 1.f;
    __align__(16) bf16 vals[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      vals[e] = __float2bfloat16(valid ? Os[r * LY::LDO + c * 8 + e] / safe_l : 0.f);
    *reinterpret_cast<uint4*>(o + ((size_t)b * L + t) * q_row + (size_t)h * HD + c * 8) =
        *reinterpret_cast<const uint4*>(vals);
  }
  if (lane < ROWS_PER_WARP) {
    const int r = r0 + lane, t = q0 + r;
    if (t < L) {
      const float m = m_s[r], l = l_s[r];
      const bool valid = m > NEG_INF / 2;
      const float safe_l = l > 0.f ? l : 1.f;
      lse[((size_t)b * nq + h) * L + t] = valid ? m + logf(safe_l) : NEG_INF;
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* seg, void* o,
           void* lse, int B, int L, int nq, int nkv, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = Layout<HD>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + BQ - 1) / BQ, nq, B);
  flash_fwd_kernel<HD><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(seg),
      static_cast<bf16*>(o), static_cast<float*>(lse), L, nq, nkv, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 = launched). Allocates nothing; runs on
// `stream` without synchronising.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              const void* seg, void* o, void* lse, int B, int L,
                              int nq, int nkv, int hd, float scale, int causal,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch<128>(q, k, v, seg, o, lse, B, L, nq, nkv, scale, causal, st);
  if (hd == 64) return launch<64>(q, k, v, seg, o, lse, B, L, nq, nkv, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
