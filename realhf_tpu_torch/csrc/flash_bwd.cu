// Flash-attention backward over packed segments, for Hopper (sm_90a).
//
// Replaces the TPU kernels realhf_tpu/ops/flash_attention.py
// `_bwd_dq_kernel:157` (K2) and `_bwd_dkv_kernel:195` (K3), launched by
// `_flash_bwd` (`:260`, `:284`): the backward of the forward in
// flash_fwd.cu (K1). The probabilities are recomputed from the forward's
// saved log-sum-exp,
//   p  = exp(scale * q.k - lse)          where the mask allows (q, k), else 0
//   ds = p * (do.v - delta)              delta = rowsum(o * do), computed
//                                        beside the kernels (as JAX does)
//   dq = scale * sum_k ds k              (K2)
//   dv = sum_q p do,  dk = scale * sum_q ds q, each summed over every
//   q head of the KV head's GQA group    (K3)
// with the forward's mask: same non-zero segment id and, when causal,
// the key not later in the stream. A row whose lse is NEG_INF (it saw no
// valid key) contributes 0, never NaN; rows of seg 0 get zero gradients.
//
// Layouts (row-major, contiguous): q/do/dq [B, L, nq, hd], k/v/dk/dv
// [B, L, nkv, hd], seg [B, L] int32 (0 = padding), lse/delta [B, nq, L]
// fp32. bf16 in and out; every sum is fp32. hd 64 or 128, any L.
//
// What bounds it on the H100: per allowed (q, k) pair and q head K2 does
// ~6 hd FLOPs (q.k, do.v, ds.k) and K3 ~8 hd (q.k, do.v, p.do, ds.q);
// their bytes are the q/k/v/do rows of tokens with seg != 0, lse/delta
// once, and the outputs once. At the SFT shape (one ~4 k-token stream of
// 8 segments, 32 heads of 128) that is 29 GFLOP against 167 MB (K2) and
// 38 GFLOP against 201 MB (K3), under the bf16 ridge point (~295
// FLOP/byte): both are bound by bytes, at ~50-60 us.
//
// Structure: the TPU's two passes, so nothing needs atomics and every run
// gives the same bits. Both kernels run on K1's tile machinery
// (attn_tile.cuh): CTAs of 256 threads, two consumer warpgroups of 64
// rows; `wgmma.mma_async` products from 128-byte-swizzled shared tiles,
// scores and gradients in registers; a two-stage ring of 64-row tiles
// filled by `cp.async` one marked tile ahead; segment-aware tile skipping.
//
// K2 (dq): a CTA owns 128 query rows of one q head (Q and dO staged once)
// and runs K1's `q_id_summary` and `mark_tiles` with K1's rule, so it
// walks exactly K1's (q tile, key tile) pairs: ranges of non-zero ids
// meet, residues mod 64 meet, and, causal, the key tile starts at or
// before the warpgroup's last row (ops/flash_attention.py
// `visited_key_tiles`). K, V and their seg ids stream through the ring
// (`load_kv_tile`, `walk_tiles`). Per marked tile a warpgroup computes
// S = Q K^T and dP = dO V^T (SS, one commit), p and ds on the accumulator
// registers with the exact per-pair mask, ds rounded to bf16 and packed as
// the register A operand, and dQ += dS K as K1's O += P V (K read
// MN-major). dQ stays in registers for the whole walk.
//
// K3 (dk, dv): the transposed walk. A CTA owns 128 key rows of one KV head
// (K and V staged once), summarises each warpgroup's 64 key ids with the
// same `q_id_summary`, and marks the 64-row q tiles a warpgroup needs:
// the ranges and residues mod 64 meet and, causal, the q tile's last row
// is at or after the warpgroup's first key. That is
// `visited_key_tiles(seg).transpose(-1, -2)` (`visited_q_tiles`), so K3
// walks the same pairs as K1 and K2. Q, dO, their seg ids, lse and delta
// stream through the ring; the walk runs over (q head of the GQA group,
// marked q tile) pairs in one sequence, so the group is summed inside the
// CTA with no partials and no bubble between heads. Per marked q tile:
// S^T = K Q^T and dP^T = V dO^T (SS, one commit), then P^T and dS^T =
// P^T (dP^T - delta) on the registers, packed to bf16 as they are made,
// then dV += P^T dO and dK += dS^T Q (RS, one commit).
//
// Registers: K3 holds dK and dV (64 + 64 fp32 a thread at hd 128); the
// fp32 S^T and dP^T tiles (32 + 32) are live together only until each
// 16-column group is turned into its two packed fragments, so the peak is
// dK + dV + S^T + dP^T = 192 plus addressing. ptxas (-Xptxas -v, nvcc
// 12.8, sm_90a): K3 244 registers at hd 128 and 184 at hd 64, K2 174 and
// 150, 0 bytes spilled by any (the WMMA version of K3 spilled 36 bytes
// at 255). Shared memory ~131 KB at hd 128 (two 128-row tiles, two
// stages of two 64-row tiles, seg / lse / delta and the bitmasks), so
// one CTA of 8 warps runs per SM.
//
// Every partial sum is taken in the order the WMMA version took it (per
// marked tile, 16 keys or queries per product), and a skipped tile only
// ever added exact zeros there: on the cases of chip_smoke.py's phase
// `kernels` this version's dq, dk and dv are bit-equal to that one's
// (scripts/torch_bwd_build_compare.py).
//
// Left for later: a TMA producer warp (the copies are issued by the
// consumer threads), a third stage, and one tile's elementwise work under
// the next tile's products (each tile waits on its own products twice).

#include "attn_tile.cuh"

namespace {

using namespace attn;

// Shared memory of both kernels, byte offsets from a 1024-byte aligned
// base. A CTA keeps 128 rows of two tensors of its own (K2: Q and dO; K3:
// K and V) and streams 64-row tiles of two others through the ring (K2: K
// and V; K3: Q and dO), with the streamed rows' seg ids and, in K3, their
// lse and delta. Every tile starts on a 1024-byte boundary.
template <int HD>
struct Layout {
  static constexpr int ROWS_BYTES = BQ * HD * 2;  // 128 rows
  static constexpr int TILE_BYTES = BK * HD * 2;  // 64 rows, one stage
  static_assert(TILE_BYTES == Smem<HD>::KV_BYTES, "load_kv_tile's stage stride");
  static constexpr int OWN_A = 0;
  static constexpr int OWN_B = OWN_A + ROWS_BYTES;
  static constexpr int RING_A = OWN_B + ROWS_BYTES;          // [STAGES] tiles
  static constexpr int RING_B = RING_A + STAGES * TILE_BYTES;  // [STAGES] tiles
  static constexpr int SEG = RING_B + STAGES * TILE_BYTES;   // [STAGES][BK] int
  static constexpr int LSE = SEG + STAGES * BK * 4;          // [STAGES][BK] float
  static constexpr int DELTA = LSE + STAGES * BK * 4;        // [STAGES][BK] float
  static constexpr int RED = DELTA + STAGES * BK * 4;        // [NWG * 2 warps][4] int
  static constexpr int MASK = RED + NWG * 2 * 4 * 4;         // [NWG][nwords] u32
};

template <int HD>
size_t layout_bytes(int n_tiles) {
  const int nwords = (n_tiles + 31) / 32;
  return 1024 + Layout<HD>::MASK + (size_t)NWG * nwords * 4;
}

// acc[64 x 64] = A[64 x HD] B[64 x HD]^T over hd: A rows wg * 64.. of a
// 128-row tile at sA, B a 64-row tile at sB, both K-major and swizzled.
// Issues the products without committing.
template <int HD>
__device__ __forceinline__ void rows_dot_tile(float (&acc)[BK / 2], uint32_t sA, int wg,
                                              uint32_t sB) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;  // 16 columns = 32 bytes into the atom
    const uint64_t da = make_desc(sA + (kk >> 2) * BQ * 128 + wg * WG_ROWS * 128 + col, 16);
    const uint64_t db = make_desc(sB + (kk >> 2) * BK * 128 + col, 16);
    wgmma_ss_m64n64k16(acc, da, db, kk > 0);
  }
}

// out[64 x HD] += W[64 x 64] X[64 x HD]: W the packed bf16 A fragments of a
// score-shaped tile, X a 64-row tile at sX read MN-major. Issues the
// products without committing.
template <int HD>
__device__ __forceinline__ void frags_times_tile(float (&out)[HD / 2],
                                                 const uint32_t (&w)[BK / 16][4], uint32_t sX) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_pv<HD>(out, w[kk], make_desc(sX + kk * 16 * 128, BK * 128));
}

// Packs the 8 values of 16-column group kk of a score-shaped accumulator
// into the A fragment of that group (the accumulator layout of S is the A
// fragment layout: columns 16 kk + 2 tq (+8) of rows r, r + 8).
__device__ __forceinline__ void pack_group(uint32_t (&a)[4], const float (&x)[8]) {
  a[0] = pack_bf16(x[0], x[1]);
  a[1] = pack_bf16(x[2], x[3]);
  a[2] = pack_bf16(x[4], x[5]);
  a[3] = pack_bf16(x[6], x[7]);
}

// Writes a thread's row of an accumulator times `mul` as bf16 at `row`
// (this thread's first column, 2 tq), from acc[4 i + OFF + {0, 1}].
template <int HD, int OFF>
__device__ __forceinline__ void store_row(bf16* row, const float (&acc)[HD / 2], float mul) {
  uint32_t* out = reinterpret_cast<uint32_t*>(row);
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
    out[4 * i] = pack_bf16(acc[4 * i + OFF] * mul, acc[4 * i + OFF + 1] * mul);
}

// ---------------------------------------------------------------------
// K2: dq
// ---------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ seg,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, int L, int nq,
                    int nkv, float scale, int causal) {
  using LY = Layout<HD>;
  extern __shared__ unsigned char smem_raw[];
  uint32_t sbase;
  unsigned char* smem = smem_base(smem_raw, sbase);
  const int* seg_s = reinterpret_cast<const int*>(smem + LY::SEG);
  int* red = reinterpret_cast<int*>(smem + LY::RED);
  uint32_t* vis = reinterpret_cast<uint32_t*>(smem + LY::MASK);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal walks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (nq / nkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int wq0 = q0 + wg * WG_ROWS;

  const size_t q_row = (size_t)nq * HD;
  const size_t kv_row = (size_t)nkv * HD;
  const size_t q_off = (size_t)b * L * q_row + (size_t)h * HD;
  const bf16* kb = k + (size_t)b * L * kv_row + (size_t)kvh * HD;
  const bf16* vb = v + (size_t)b * L * kv_row + (size_t)kvh * HD;
  const int* segb = seg + (size_t)b * L;
  const size_t stat_off = ((size_t)b * nq + h) * L;

  // --- K1's marks: the key tiles each warpgroup needs ---------------------
  int q_lo[NWG], q_hi[NWG], q_last[NWG];
  uint64_t q_bits[NWG];
  q_id_summary(segb, q0, L, tid, red, q_lo, q_hi, q_bits);
#pragma unroll
  for (int g = 0; g < NWG; ++g) q_last[g] = min(q0 + g * WG_ROWS + WG_ROWS, L) - 1;
  const int n_all = (L + BK - 1) / BK;
  const int n_tiles = causal ? min(n_all, (min(q0 + BQ, L) - 1) / BK + 1) : n_all;
  const int nwords = (n_tiles + 31) >> 5;
  const bool seg_vec = (L & 3) == 0;
  mark_tiles(n_tiles, nwords, tid, vis, [&](int j, bool (&mark)[NWG]) {
    const int k0 = j * BK;
    int lo = INT_MAX, hi = INT_MIN;
    uint64_t bits = 0ull;
    key_tile_ids(segb, k0, min(BK, L - k0), seg_vec, lo, hi, bits);
#pragma unroll
    for (int g = 0; g < NWG; ++g)
      mark[g] = lo <= q_hi[g] && hi >= q_lo[g] && (bits & q_bits[g]) != 0 &&
                (!causal || k0 <= q_last[g]);
  });

  // --- this thread's two rows (the accumulator layout) --------------------
  const int tq = lane & 3;
  const int qi0 = wq0 + (warp & 3) * 16 + (lane >> 2);
  const int qi1 = qi0 + 8;
  const float lse0 = qi0 < L ? lse[stat_off + qi0] : NEG_INF;
  const float lse1 = qi1 < L ? lse[stat_off + qi1] : NEG_INF;
  const float dl0 = qi0 < L ? delta[stat_off + qi0] : 0.f;
  const float dl1 = qi1 < L ? delta[stat_off + qi1] : 0.f;
  // a row that saw no valid key (lse NEG_INF) matches no key: id 0
  const int sq0 = qi0 < L && lse0 > NEG_INF / 2 ? segb[qi0] : 0;
  const int sq1 = qi1 < L && lse1 > NEG_INF / 2 ? segb[qi1] : 0;

  // --- the walk ------------------------------------------------------------
  const uint32_t sQ = sbase + LY::OWN_A, sDO = sbase + LY::OWN_B;
  const uint32_t sK = sbase + LY::RING_A, sV = sbase + LY::RING_B;
  const uint32_t sSeg = sbase + LY::SEG;
  auto load = [&](int j, int st) {
    load_kv_tile<HD>(sK, sV, sSeg, kb, vb, segb, kv_row, j * BK, L, st, tid);
  };

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  const int j0 = next_tile(vis, nwords, -1);
  if (j0 >= 0) {
    load_q_tile<HD>(sQ, q + q_off, q_row, q0, L, tid);
    load_q_tile<HD>(sDO, dout + q_off, q_row, q0, L, tid);
    load(j0, 0);
  }
  walk_tiles(vis, nwords, wg, j0, load, [&](int j, int st) {
    const int k0 = j * BK;
    const bool diag = causal && k0 + BK - 1 > wq0;
    const uint32_t sKt = sK + st * LY::TILE_BYTES, sVt = sV + st * LY::TILE_BYTES;
    const int* seg_tile = seg_s + st * BK;

    // S = Q K^T, dP = dO V^T
    float s[BK / 2], dp[BK / 2];
    wgmma_fence();
    rows_dot_tile<HD>(s, sQ, wg, sKt);
    rows_dot_tile<HD>(dp, sDO, wg, sVt);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    // p and ds in registers, packed to bf16 16 keys at a time
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      float x[8];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {  // column blocks i = 2 kk + h2
        const int i = 2 * kk + h2;
        const int2 ids = *reinterpret_cast<const int2*>(seg_tile + 8 * i + 2 * tq);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * i + 2 * tq + e;
          const int id = e ? ids.y : ids.x;
          const bool keep0 = sq0 != 0 && id == sq0 && (!diag || qi0 >= k0 + c);
          const bool keep1 = sq1 != 0 && id == sq1 && (!diag || qi1 >= k0 + c);
          const float p0 = keep0 ? expf(s[4 * i + e] * scale - lse0) : 0.f;
          const float p1 = keep1 ? expf(s[4 * i + 2 + e] * scale - lse1) : 0.f;
          x[4 * h2 + e] = keep0 ? p0 * (dp[4 * i + e] - dl0) : 0.f;
          x[4 * h2 + 2 + e] = keep1 ? p1 * (dp[4 * i + 2 + e] - dl1) : 0.f;
        }
      }
      pack_group(da[kk], x);
    }

    // dQ += dS K
    fence_regs(acc);
    wgmma_fence();
    frags_times_tile<HD>(acc, da, sKt);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(da[kk]);
  });

  // --- epilogue: dq = scale * acc; rows with no valid key hold 0 -----------
  bf16* out = dq + q_off + 2 * tq;
  if (qi0 < L) store_row<HD, 0>(out + (size_t)qi0 * q_row, acc, scale);
  if (qi1 < L) store_row<HD, 2>(out + (size_t)qi1 * q_row, acc, scale);
}

// ---------------------------------------------------------------------
// K3: dk, dv (the GQA group summed inside the CTA)
// ---------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ seg,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int L, int nq, int nkv, float scale, int causal) {
  using LY = Layout<HD>;
  extern __shared__ unsigned char smem_raw[];
  uint32_t sbase;
  unsigned char* smem = smem_base(smem_raw, sbase);
  const int* seg_s = reinterpret_cast<const int*>(smem + LY::SEG);
  const float* lse_s = reinterpret_cast<const float*>(smem + LY::LSE);
  const float* delta_s = reinterpret_cast<const float*>(smem + LY::DELTA);
  int* red = reinterpret_cast<int*>(smem + LY::RED);
  uint32_t* vis = reinterpret_cast<uint32_t*>(smem + LY::MASK);

  const int k0 = blockIdx.x * BQ;  // causal: the first key tiles walk the most
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = nq / nkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int wk0 = k0 + wg * WG_ROWS;  // this warpgroup's first key

  const size_t q_row = (size_t)nq * HD;
  const size_t kv_row = (size_t)nkv * HD;
  const size_t kv_off = (size_t)b * L * kv_row + (size_t)kvh * HD;
  const int* segb = seg + (size_t)b * L;

  // --- each warpgroup's range and residue set of non-zero key ids ---------
  int k_lo[NWG], k_hi[NWG];
  uint64_t k_bits[NWG];
  q_id_summary(segb, k0, L, tid, red, k_lo, k_hi, k_bits);

  // --- mark the q tiles each warpgroup needs (K1's rule, transposed) ------
  const int n_tiles = (L + BK - 1) / BK;
  const int nwords = (n_tiles + 31) >> 5;
  const bool seg_vec = (L & 3) == 0;
  mark_tiles(n_tiles, nwords, tid, vis, [&](int j, bool (&mark)[NWG]) {
    const int t0 = j * BK;
    const int last = min(t0 + BK, L) - 1;
    if (causal && last < k0) return;  // every query before every key
    int lo = INT_MAX, hi = INT_MIN;
    uint64_t bits = 0ull;
    key_tile_ids(segb, t0, min(BK, L - t0), seg_vec, lo, hi, bits);
#pragma unroll
    for (int g = 0; g < NWG; ++g)
      mark[g] = lo <= k_hi[g] && hi >= k_lo[g] && (bits & k_bits[g]) != 0 &&
                (!causal || last >= k0 + g * WG_ROWS);
  });

  // --- this thread's two key rows (the accumulator layout) ---------------
  const int tq = lane & 3;
  const int kr0 = wk0 + (warp & 3) * 16 + (lane >> 2);
  const int kr1 = kr0 + 8;
  const int sk0 = kr0 < L ? segb[kr0] : 0;
  const int sk1 = kr1 < L ? segb[kr1] : 0;

  // --- the walk over (q head of the group, marked q tile) ----------------
  const uint32_t sK = sbase + LY::OWN_A, sV = sbase + LY::OWN_B;
  const uint32_t sQ = sbase + LY::RING_A, sDO = sbase + LY::RING_B;
  const uint32_t sSeg = sbase + LY::SEG, sLse = sbase + LY::LSE, sDelta = sbase + LY::DELTA;
  auto load = [&](int g, int j, int st) {
    const int h = kvh * group + g;
    const size_t q_off = (size_t)b * L * q_row + (size_t)h * HD;
    const size_t stat_off = ((size_t)b * nq + h) * L;
    const int t0 = j * BK;
    const int r = tid & (BK - 1), t = t0 + r;
    const bool in = t < L;
    if (tid >= BK && tid < 2 * BK)  // the copies join the tile's group
      cp_async4(sLse + (st * BK + r) * 4, lse + stat_off + (in ? t : 0), in);
    else if (tid >= 2 * BK && tid < 3 * BK)
      cp_async4(sDelta + (st * BK + r) * 4, delta + stat_off + (in ? t : 0), in);
    load_kv_tile<HD>(sQ, sDO, sSeg, q + q_off, dout + q_off, segb, q_row, t0, L, st, tid);
  };

  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const int j0 = next_tile(vis, nwords, -1);
  if (j0 >= 0) {
    load_q_tile<HD>(sK, k + kv_off, kv_row, k0, L, tid);
    load_q_tile<HD>(sV, v + kv_off, kv_row, k0, L, tid);
    load(0, j0, 0);
  }
  int g = 0, j = j0, st = 0;
  while (j >= 0) {
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // tile j is in stage st; every warpgroup left stage st ^ 1
    int gn = g, jn = next_tile(vis, nwords, j);
    if (jn < 0 && g + 1 < group) {  // the group's next q head, from its first tile
      gn = g + 1;
      jn = j0;
    }
    if (jn >= 0) load(gn, jn, st ^ 1);
    if ((vis[wg * nwords + (j >> 5)] >> (j & 31)) & 1u) {
      const int q0 = j * BK;
      const bool diag = causal && q0 < wk0 + WG_ROWS - 1;
      const uint32_t sQt = sQ + st * LY::TILE_BYTES, sDOt = sDO + st * LY::TILE_BYTES;
      const int* seg_tile = seg_s + st * BK;
      const float* lse_tile = lse_s + st * BK;
      const float* delta_tile = delta_s + st * BK;

      // S^T = K Q^T, dP^T = V dO^T
      float s[BK / 2], dp[BK / 2];
      wgmma_fence();
      rows_dot_tile<HD>(s, sK, wg, sQt);
      rows_dot_tile<HD>(dp, sV, wg, sDOt);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      fence_regs(dp);

      // P^T and dS^T in registers, packed to bf16 16 queries at a time
      uint32_t pa[BK / 16][4], da[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        float xp[8], xd[8];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int i = 2 * kk + h2;
          const int c2 = 8 * i + 2 * tq;
          const int2 ids = *reinterpret_cast<const int2*>(seg_tile + c2);
          const float2 ls = *reinterpret_cast<const float2*>(lse_tile + c2);
          const float2 dls = *reinterpret_cast<const float2*>(delta_tile + c2);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qc = q0 + c2 + e;
            const int id = e ? ids.y : ids.x;
            const float l = e ? ls.y : ls.x;
            const float dl = e ? dls.y : dls.x;
            const bool ok = id != 0 && l > NEG_INF / 2;
            const bool keep0 = ok && id == sk0 && (!diag || qc >= kr0);
            const bool keep1 = ok && id == sk1 && (!diag || qc >= kr1);
            const float p0 = keep0 ? expf(s[4 * i + e] * scale - l) : 0.f;
            const float p1 = keep1 ? expf(s[4 * i + 2 + e] * scale - l) : 0.f;
            xp[4 * h2 + e] = p0;
            xp[4 * h2 + 2 + e] = p1;
            xd[4 * h2 + e] = keep0 ? p0 * (dp[4 * i + e] - dl) : 0.f;
            xd[4 * h2 + 2 + e] = keep1 ? p1 * (dp[4 * i + 2 + e] - dl) : 0.f;
          }
        }
        pack_group(pa[kk], xp);
        pack_group(da[kk], xd);
      }

      // dV += P^T dO, dK += dS^T Q
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
      frags_times_tile<HD>(dv_acc, pa, sDOt);
      frags_times_tile<HD>(dk_acc, da, sQt);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(da[kk]);
      }
    }
    g = gn;
    j = jn;
    st ^= 1;
  }

  // --- epilogue: dk = scale * dk_acc, dv; keys with no valid query hold 0 --
  bf16* dkb = dk + kv_off + 2 * tq;
  bf16* dvb = dv + kv_off + 2 * tq;
  if (kr0 < L) {
    store_row<HD, 0>(dkb + (size_t)kr0 * kv_row, dk_acc, scale);
    store_row<HD, 0>(dvb + (size_t)kr0 * kv_row, dv_acc, 1.f);
  }
  if (kr1 < L) {
    store_row<HD, 2>(dkb + (size_t)kr1 * kv_row, dk_acc, scale);
    store_row<HD, 2>(dvb + (size_t)kr1 * kv_row, dv_acc, 1.f);
  }
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
  if (B == 0 || L == 0) return (int)cudaSuccess;
  const size_t smem = layout_bytes<HD>((L + BK - 1) / BK);
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
  if (B == 0 || L == 0) return (int)cudaSuccess;
  const size_t smem = layout_bytes<HD>((L + BK - 1) / BK);
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + BQ - 1) / BQ, nkv, B);
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
