// Flash-attention forward over packed segments, for Hopper (sm_90a): K1.
//
// Replaces the TPU kernel realhf_tpu/ops/flash_attention.py `_fwd_kernel:55`
// (launched by `_flash_fwd:130`, public entry `flash_attention`): tiled
// online-softmax attention where a query attends to a key iff both carry
// the same non-zero segment id and, when causal, the key is not later in
// the stream, and with a sliding window (window >= 0; < 0 is none) less
// than `window` positions behind it. GQA: q head h reads KV head
// h / (nq / nkv). Outputs o (bf16)
// and the per-row log-sum-exp (fp32, kept for the backward pass). A row
// that never sees a valid key gets o = 0 and lse = NEG_INF, never NaN.
//
// Layouts (row-major, contiguous): q/o [B, L, nq, hd], k/v [B, L, nkv, hd],
// seg [B, L] int32 (0 = padding), lse [B, nq, L].
//
// What bounds it on the H100: the work is 4 * hd FLOPs per allowed
// (query, key) pair and head against one read of q/k/v and one write of o
// and lse. At the prefill shape of a LLaMA-7B layer (B 8, L 512, 32 heads,
// hd 128) that is ~6 GFLOP against ~67 MB (bytes bound it, ~20 us); on
// packed training streams the pairs the segments allow are few (a 4096-
// token stream of 8 documents allows ~1.2 M pairs a head, 1/7 of the
// causal triangle), so both bounds are tens of microseconds and what a
// kernel loses is the pairs it walks without need and the latency it
// does not hide. The design:
//
// 1. Segment-aware tile skipping. A CTA owns 128 query rows (two
//    warpgroups of 64) of one head of one batch row. It first reduces each
//    warpgroup's seg ids to the range [min, max] of its non-zero ids and
//    to the set of their residues mod 64 (a 64-bit word), then reads the
//    seg ids of every key tile (64 keys) up to the causal diagonal and
//    marks the tile for a warpgroup when the tile's range of non-zero ids
//    meets the warpgroup's, their residue sets meet, and, causal, the tile
//    starts at or before the warpgroup's last row, and with a window its
//    last key lies less than `window` behind the warpgroup's first row
//    (`tile_in_reach`, the rule of K6's rounds; tiles out of reach are
//    passed over before their ids are read). The marks go to two
//    bitmasks in shared memory; the CTA loads a tile either warpgroup
//    marked, and a warpgroup computes only on its own. The rule is sound
//    for any ids (a pair the mask allows has equal non-zero ids, inside
//    both ranges and with the same residue); the residues keep it tight to
//    the tile edges when the packer lays sequences out in no id order (it
//    places them longest first) as long as a stream holds fewer than 64
//    ids near each other. ops/flash_attention.py `visited_key_tiles` states
//    it in PyTorch. A warpgroup with no non-zero id, or with no marked
//    tile, writes o = 0 and lse = NEG_INF. The per-pair causal and window
//    tests run only on the tiles where they can fail (`keep_pair`): a
//    window of 4096 over an 8192-token stream leaves each row ~4096 keys,
//    and the marks cut the walk to the tiles that hold them. With no
//    window, or one of L or more, the marks and the arithmetic are the
//    windowless ones, bit for bit.
// 2. Accumulators in registers. S = Q K^T and O += P V are
//    `wgmma.mma_async` (m64n64k16 and m64n{hd}k16, bf16 in, fp32
//    accumulate), one warpgroup per 64 query rows. Q and K are read from
//    shared memory, K-major; V from shared memory with the transpose flag;
//    P, rescaled and rounded to bf16 in registers, is the register A
//    operand of the second product (the accumulator layout of S is the A
//    fragment layout). The online softmax runs on the accumulator
//    registers: the four threads of a quad hold one row and reduce it with
//    two shuffles. It takes expf of the scaled score less the row max, as
//    the plain version does, and sums each tile's row in one fixed
//    butterfly order (`tile_row_sum`). K6 (csrc/ring_attention.cu) runs
//    the same tile step, so the ctx path's c1 (this kernel) and c4 (K6)
//    log-probs differ only by the order in which tiles arrive. An exp2 in
//    the log2 domain with per-thread row sums was ~20% faster at the sft
//    shape on an H100 and as close to an fp32 reference, but rounded
//    elsewhere than K6 then did, and over 32 layers c1 drifted 4x further
//    from c4. S, P and O never touch shared memory.
// 3. An asynchronous K/V ring. Two stages of K, V (and the tile's seg
//    ids) in shared memory, filled by 16-byte `cp.async` copies one marked
//    tile ahead: the copy of the next tile is issued right after the
//    barrier that frees its stage and overlaps the current tile's two
//    products and softmax; one __syncthreads per tile. Rows past L are
//    zero-filled by the copy (source size 0), never read from memory.
//    Tiles are stored in the 128-byte swizzle that the wgmma descriptors
//    name (16-byte chunk c of row r at chunk c ^ (r % 8) of its 128-byte
//    row, hd split into 64-column atoms), so the copies and the tensor
//    cores both see conflict-free banks.
// 4. Tiles and occupancy. BQ 128 (two consumer warpgroups, 256 threads),
//    BK 64. Shared memory at hd 128: Q 32 KB + 2 stages x (K 16 KB + V
//    16 KB) + seg ids and bitmasks (~1 KB, 2 bits a key tile) + 1 KB of
//    alignment slack = ~98 KB, so two CTAs would fit an SM by shared
//    memory; the registers decide: ptxas gives ~180 a thread at hd 128
//    and ~170 at hd 64, no spills, so one CTA (8 warps) runs per SM. hd 64
//    halves Q, K and V. hd 256 (Gemma) doubles them: Q 64 KB + 2 x (32 +
//    32) KB = ~194 KB, one CTA an SM, and O takes 128 fp32 registers a
//    thread. Its O += P V is two m64n128 products over the same P
//    fragments (`wgmma_pv<256>`), so S (32) and P (16) stay beside O under
//    the 255-register cap: ptxas gives 240 (245 with a window), 0 bytes
//    spilled.
// q tiles are launched last first, so the CTAs with the longest causal
// walks start first. Points 1-3 are the tile machinery this kernel shares
// with K6, in csrc/attn_tile.cuh; the marking rule and the epilogue are
// this file's.

#include "attn_tile.cuh"

namespace {

using namespace attn;

// WIN: whether the launch has a window. A windowless launch compiles
// without the window's tests, so it runs the windowless kernel's code.
template <int HD, bool WIN>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg,
                 bf16* __restrict__ o, float* __restrict__ lse, int L, int nq,
                 int nkv, float scale, int causal, int window) {
  using SM = Smem<HD>;
  extern __shared__ unsigned char smem_raw[];
  uint32_t sbase;
  unsigned char* smem = smem_base(smem_raw, sbase);
  int* seg_s = reinterpret_cast<int*>(smem + SM::SEG);
  int* red = reinterpret_cast<int*>(smem + SM::RED);
  uint32_t* vis = reinterpret_cast<uint32_t*>(smem + SM::MASK);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (nq / nkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = tid >> 7;         // this thread's warpgroup
  const int wq0 = q0 + wg * WG_ROWS;  // its first query row

  const size_t q_row = (size_t)nq * HD;
  const size_t kv_row = (size_t)nkv * HD;
  const bf16* qb = q + (size_t)b * L * q_row + (size_t)h * HD;
  const bf16* kb = k + (size_t)b * L * kv_row + (size_t)kvh * HD;
  const bf16* vb = v + (size_t)b * L * kv_row + (size_t)kvh * HD;
  const int* segb = seg + (size_t)b * L;

  // --- 1. each warpgroup's range and residue set of non-zero q seg ids ---
  int q_lo[NWG], q_hi[NWG], q_first[NWG], q_last[NWG];
  uint64_t q_bits[NWG];
  q_id_summary(segb, q0, L, tid, red, q_lo, q_hi, q_bits);
#pragma unroll
  for (int g = 0; g < NWG; ++g) {
    q_first[g] = q0 + g * WG_ROWS;
    q_last[g] = min(q0 + g * WG_ROWS + WG_ROWS, L) - 1;
  }

  // --- 2. mark the key tiles each warpgroup needs ------------------------
  const int n_all = (L + BK - 1) / BK;
  const int n_tiles = causal ? min(n_all, (min(q0 + BQ, L) - 1) / BK + 1) : n_all;
  const int nwords = (n_tiles + 31) >> 5;
  const bool seg_vec = (L & 3) == 0;  // rows of seg 16-byte aligned
  mark_tiles(n_tiles, nwords, tid, vis, [&](int j, bool (&mark)[NWG]) {
    const int k0 = j * BK;
    const int n = min(BK, L - k0);
    bool reach[NWG], any = false;
#pragma unroll
    for (int g = 0; g < NWG; ++g) {
      reach[g] = tile_in_reach(k0, k0 + n - 1, q_first[g], q_last[g], causal,
                               WIN ? window : -1);
      any |= reach[g];
    }
    if (!any) return;
    int lo = INT_MAX, hi = INT_MIN;
    uint64_t bits = 0ull;
    key_tile_ids(segb, k0, n, seg_vec, lo, hi, bits);
#pragma unroll
    for (int g = 0; g < NWG; ++g)
      mark[g] = reach[g] && lo <= q_hi[g] && hi >= q_lo[g] && (bits & q_bits[g]) != 0;
  });

  // --- 3. the walk --------------------------------------------------------
  const uint32_t sQ = sbase + SM::Q, sK = sbase + SM::K, sV = sbase + SM::V;
  const uint32_t sSeg = sbase + SM::SEG;
  auto load = [&](int j, int st) {
    load_kv_tile<HD>(sK, sV, sSeg, kb, vb, segb, kv_row, j * BK, L, st, tid);
  };

  // This thread's two rows of its warpgroup's 64 (the accumulator layout):
  // rows wq0 + r and wq0 + r + 8, columns 8 i + 2 tq + {0, 1}.
  const int tq = lane & 3;
  const int qi0 = wq0 + (warp & 3) * 16 + (lane >> 2);
  const int qi1 = qi0 + 8;
  const int sq0 = qi0 < L ? segb[qi0] : 0;
  const int sq1 = qi1 < L ? segb[qi1] : 0;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m0 = minus_inf(), m1 = minus_inf(), l0 = 0.f, l1 = 0.f;
  const int j0 = next_tile(vis, nwords, -1);
  if (j0 >= 0) {
    load_q_tile<HD>(sQ, qb, q_row, q0, L, tid);
    load(j0, 0);
  }
  walk_tiles(vis, nwords, wg, j0, load, [&](int j, int st) {
    const int k0 = j * BK;
    // whether some pair of the tile may break causality or the window
    const bool diag = causal && k0 + BK - 1 > wq0;
    const bool wide = WIN && wq0 + WG_ROWS - 1 - k0 >= window;
    tile_step<HD>(acc, m0, m1, l0, l1, sQ, wg, sK + st * SM::KV_BYTES, sV + st * SM::KV_BYTES,
                  seg_s + st * BK, tq, scale, [&](int r, int c, int id) {
                    return keep_pair(r ? sq1 : sq0, id, (r ? qi1 : qi0) - (k0 + c), diag, wide,
                                     window);
                  });
  });

  // --- 4. epilogue: normalise, zero rows that saw no valid key ------------
  bf16* ob = o + (size_t)b * L * q_row + (size_t)h * HD + 2 * tq;
  if (qi0 < L) {
    store_o_row<HD, 0>(ob + (size_t)qi0 * q_row, acc, l0);
    if (tq == 0)
      lse[((size_t)b * nq + h) * L + qi0] = l0 > 0.f ? m0 + logf(l0) : NEG_INF;
  }
  if (qi1 < L) {
    store_o_row<HD, 2>(ob + (size_t)qi1 * q_row, acc, l1);
    if (tq == 0)
      lse[((size_t)b * nq + h) * L + qi1] = l1 > 0.f ? m1 + logf(l1) : NEG_INF;
  }
}

template <int HD, bool WIN>
int launch(const void* q, const void* k, const void* v, const void* seg, void* o,
           void* lse, int B, int L, int nq, int nkv, float scale, int causal, int window,
           cudaStream_t stream) {
  if (B == 0 || L == 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes<HD>((L + BK - 1) / BK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD, WIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + BQ - 1) / BQ, nq, B);
  flash_fwd_kernel<HD, WIN><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(seg),
      static_cast<bf16*>(o), static_cast<float*>(lse), L, nq, nkv, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              const void* seg, void* o, void* lse, int B, int L,
                              int nq, int nkv, int hd, float scale, int causal,
                              int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool win = window >= 0;
  if (hd == 128)
    return (win ? launch<128, true> : launch<128, false>)(q, k, v, seg, o, lse, B, L, nq, nkv,
                                                         scale, causal, window, st);
  if (hd == 64)
    return (win ? launch<64, true> : launch<64, false>)(q, k, v, seg, o, lse, B, L, nq, nkv,
                                                       scale, causal, window, st);
  if (hd == 256)
    return (win ? launch<256, true> : launch<256, false>)(q, k, v, seg, o, lse, B, L, nq, nkv,
                                                         scale, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
