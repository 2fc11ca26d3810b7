// Flash-attention forward over packed segments, for Hopper (sm_90a): K1.
//
// Replaces the TPU kernel realhf_tpu/ops/flash_attention.py `_fwd_kernel:55`
// (launched by `_flash_fwd:130`, public entry `flash_attention`): tiled
// online-softmax attention where a query attends to a key iff both carry
// the same non-zero segment id and, when causal, the key is not later in
// the stream. GQA: q head h reads KV head h / (nq / nkv). Outputs o (bf16)
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
//    starts at or before the warpgroup's last row. The marks go to two
//    bitmasks in shared memory; the CTA loads a tile either warpgroup
//    marked, and a warpgroup computes only on its own. The rule is sound
//    for any ids (a pair the mask allows has equal non-zero ids, inside
//    both ranges and with the same residue); the residues keep it tight to
//    the tile edges when the packer lays sequences out in no id order (it
//    places them longest first) as long as a stream holds fewer than 64
//    ids near each other. ops/flash_attention.py `visited_key_tiles` states
//    it in PyTorch. A warpgroup with no non-zero id, or with no marked
//    tile, writes o = 0 and lse = NEG_INF.
// 2. Accumulators in registers. S = Q K^T and O += P V are
//    `wgmma.mma_async` (m64n64k16 and m64n{hd}k16, bf16 in, fp32
//    accumulate), one warpgroup per 64 query rows. Q and K are read from
//    shared memory, K-major; V from shared memory with the transpose flag;
//    P, rescaled and rounded to bf16 in registers, is the register A
//    operand of the second product (the accumulator layout of S is the A
//    fragment layout). The online softmax runs on the accumulator
//    registers: the four threads of a quad hold one row and reduce it with
//    two shuffles. It takes expf of the scaled score less the row max, as
//    the plain version and K6 do, and sums each tile's row in K6's order
//    (`tile_row_sum`); with those, and the tensor cores' k16 steps in the
//    same order, it rounds as K6 does, so the ctx path's c1 (this kernel)
//    and c4 (K6) log-probs agree as closely as two runs of K6's arithmetic
//    would. An exp2 in the log2 domain with per-thread row sums was ~20%
//    faster at the sft shape on an H100 and as close to an fp32
//    reference, but rounded elsewhere than K6, and over 32 layers c1 drifted
//    4x further from c4. S, P and O never touch shared memory.
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
//    halves Q, K and V.
// q tiles are launched last first, so the CTAs with the longest causal
// walks start first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

typedef __nv_bfloat16 bf16;

#define NEG_INF (-1073741824.0f)  // -2^30, the JAX package's sentinel

namespace {

constexpr int WG_ROWS = 64;             // query rows of one warpgroup
constexpr int NWG = 2;                  // consumer warpgroups per CTA
constexpr int BQ = WG_ROWS * NWG;       // query rows per CTA
constexpr int BK = 64;                  // keys per tile
constexpr int NTHREADS = NWG * 128;
constexpr int STAGES = 2;

template <int HD>
struct Smem {
  // byte offsets from a 1024-byte aligned base; every tile starts on a
  // 1024-byte boundary, as the 128-byte swizzle's 8-row atom requires
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;
  static constexpr int Q = 0;
  static constexpr int K = Q + Q_BYTES;                 // [STAGES] tiles
  static constexpr int V = K + STAGES * KV_BYTES;       // [STAGES] tiles
  static constexpr int SEG = V + STAGES * KV_BYTES;     // [STAGES][BK] int
  static constexpr int RED = SEG + STAGES * BK * 4;     // [NWG * 2 warps][4] int
  static constexpr int MASK = RED + NWG * 2 * 4 * 4;    // [NWG][nwords] u32
};

// Byte offset of 16-byte chunk `c` (hd columns 8c..8c+7) of row `r` in a
// tile of `rows` rows stored as hd / 64 swizzled 128-byte atoms columns.
__device__ __forceinline__ uint32_t swz(int rows, int r, int c) {
  return (uint32_t)((c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Generic-proxy writes to shared memory (the copies) made visible to the
// async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an operand register
// across the asynchronous product that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (K-major: unused, 16; MN-major: stride between 64-column
// atoms), stride byte offset (between 8-row groups: 1024).
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ float minus_inf() { return __int_as_float((int)0xff800000u); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B from shared memory
// (both K-major, 128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers (the accumulator
// layout of a 64 x 16 block, packed to bf16 pairs), B from shared memory,
// MN-major (transposed), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A from registers (the accumulator
// layout of a 64 x 16 block, packed to bf16 pairs), B from shared memory,
// MN-major (transposed), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&a)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_m64n64k16(o, a, db);
}

template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_m64n128k16(o, a, db);
}

// Sum of one row's 64 probabilities of a tile, held 16 to a thread by the
// four threads of a quad (s[4 i + OFF + e] is column 8 i + 2 tq + e), taken
// in the order K6 (csrc/ring_attention.cu) takes it: columns c and c ^ 32
// first, then a butterfly over c ^ 16, ^ 8, ^ 4, ^ 2, ^ 1. Every thread of
// the quad gets the same sum.
template <int OFF>
__device__ __forceinline__ float tile_row_sum(const float (&s)[BK / 2]) {
  static_assert(BK == 64, "the order is written out for 64-key tiles");
  float c[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int j = OFF + e;
    c[e] = ((s[j] + s[16 + j]) + (s[8 + j] + s[24 + j])) +
           ((s[4 + j] + s[20 + j]) + (s[12 + j] + s[28 + j]));
    c[e] += __shfl_xor_sync(0xffffffffu, c[e], 2);
    c[e] += __shfl_xor_sync(0xffffffffu, c[e], 1);
  }
  return c[0] + c[1];
}

// One bit per id residue mod 64: two tiles that share an id share its bit.
__device__ __forceinline__ uint64_t id_bit(int id) { return 1ull << (id & 63); }

// First tile after `from` that either warpgroup marked, or -1. Every
// thread reads the same words, so the answer is uniform.
__device__ __forceinline__ int next_tile(const uint32_t* vis, int nwords, int from) {
  const int j = from + 1;
  int w = j >> 5;
  if (w >= nwords) return -1;
  uint32_t bits = (vis[w] | vis[nwords + w]) & (0xffffffffu << (j & 31));
  while (bits == 0) {
    if (++w >= nwords) return -1;
    bits = vis[w] | vis[nwords + w];
  }
  return (w << 5) + __ffs(bits) - 1;
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg,
                 bf16* __restrict__ o, float* __restrict__ lse, int L, int nq,
                 int nkv, float scale, int causal) {
  using SM = Smem<HD>;
  constexpr int CH = HD / 8;  // 16-byte chunks in a row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_addr = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t pad = ((raw_addr + 1023u) & ~1023u) - raw_addr;
  unsigned char* smem = smem_raw + pad;
  const uint32_t sbase = raw_addr + pad;
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
  if (tid < BQ) {
    const int t = q0 + tid;
    const int s = t < L ? segb[t] : 0;
    int lo = s != 0 ? s : INT_MAX, hi = s != 0 ? s : INT_MIN;
    uint64_t bits = s != 0 ? id_bit(s) : 0ull;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, d));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, d));
      bits |= __shfl_xor_sync(0xffffffffu, bits, d);
    }
    if (lane == 0) {
      red[4 * warp] = lo;
      red[4 * warp + 1] = hi;
      reinterpret_cast<uint64_t*>(red)[2 * warp + 1] = bits;
    }
  }
  __syncthreads();
  int q_lo[NWG], q_hi[NWG], q_last[NWG];
  uint64_t q_bits[NWG];
  const uint64_t* red_bits = reinterpret_cast<const uint64_t*>(red);
#pragma unroll
  for (int g = 0; g < NWG; ++g) {  // warps 2g and 2g + 1 hold its rows
    q_lo[g] = min(red[8 * g], red[8 * g + 4]);
    q_hi[g] = max(red[8 * g + 1], red[8 * g + 5]);
    q_bits[g] = red_bits[4 * g + 1] | red_bits[4 * g + 3];
    q_last[g] = min(q0 + g * WG_ROWS + WG_ROWS, L) - 1;
  }

  // --- 2. mark the key tiles each warpgroup needs ------------------------
  const int n_all = (L + BK - 1) / BK;
  const int n_tiles = causal ? min(n_all, (min(q0 + BQ, L) - 1) / BK + 1) : n_all;
  const int nwords = (n_tiles + 31) >> 5;
  const bool seg_vec = (L & 3) == 0;  // rows of seg 16-byte aligned
  for (int base = 0; base < n_tiles; base += NTHREADS) {
    const int j = base + tid;
    bool mark[NWG];
#pragma unroll
    for (int g = 0; g < NWG; ++g) mark[g] = false;
    if (j < n_tiles) {
      const int k0 = j * BK, n = min(BK, L - k0);
      int lo = INT_MAX, hi = INT_MIN;
      uint64_t bits = 0ull;
      if (seg_vec) {
        const int4* p = reinterpret_cast<const int4*>(segb + k0);
        for (int i = 0; i < n / 4; ++i) {
          const int4 x = p[i];
          const int e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (e[c] != 0) lo = min(lo, e[c]), hi = max(hi, e[c]), bits |= id_bit(e[c]);
        }
      } else {
        for (int i = 0; i < n; ++i) {
          const int e = segb[k0 + i];
          if (e != 0) lo = min(lo, e), hi = max(hi, e), bits |= id_bit(e);
        }
      }
#pragma unroll
      for (int g = 0; g < NWG; ++g)
        mark[g] = lo <= q_hi[g] && hi >= q_lo[g] && (bits & q_bits[g]) != 0 &&
                  (!causal || k0 <= q_last[g]);
    }
#pragma unroll
    for (int g = 0; g < NWG; ++g) {
      const uint32_t bits = __ballot_sync(0xffffffffu, mark[g]);
      const int w = (base >> 5) + warp;
      if (lane == 0 && w < nwords) vis[g * nwords + w] = bits;
    }
  }
  __syncthreads();

  // --- 3. the walk --------------------------------------------------------
  const uint32_t sQ = sbase + SM::Q, sK = sbase + SM::K, sV = sbase + SM::V;
  const uint32_t sSeg = sbase + SM::SEG;

  auto load_tile = [&](int j, int st) {
    const int k0 = j * BK;
    for (int i = tid; i < BK * CH; i += NTHREADS) {
      const int r = i / CH, c = i % CH, t = k0 + r;
      const bool in = t < L;
      const size_t off = (size_t)(in ? t : 0) * kv_row + c * 8;
      const uint32_t dst = st * SM::KV_BYTES + swz(BK, r, c);
      cp_async16(sK + dst, kb + off, in);
      cp_async16(sV + dst, vb + off, in);
    }
    if (tid < BK) {
      const int t = k0 + tid;
      cp_async4(sSeg + (st * BK + tid) * 4, segb + (t < L ? t : 0), t < L);
    }
    cp_async_commit();
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

  int j = next_tile(vis, nwords, -1);
  if (j >= 0) {
    for (int i = tid; i < BQ * CH; i += NTHREADS) {
      const int r = i / CH, c = i % CH, t = q0 + r;
      const bool in = t < L;
      cp_async16(sQ + swz(BQ, r, c), qb + (size_t)(in ? t : 0) * q_row + c * 8, in);
    }
    load_tile(j, 0);
  }
  int st = 0;
  while (j >= 0) {
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // tile j is in stage st; every warpgroup left stage st ^ 1
    const int jn = next_tile(vis, nwords, j);
    if (jn >= 0) load_tile(jn, st ^ 1);
    if ((vis[wg * nwords + (j >> 5)] >> (j & 31)) & 1u) {
      const int k0 = j * BK;
      // S = Q K^T over hd, 16 columns a step
      float s[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = (kk & 3) * 32;  // 16 columns = 32 bytes into the atom
        const uint64_t da = make_desc(sQ + (kk >> 2) * BQ * 128 + wg * WG_ROWS * 128 + col, 16);
        const uint64_t db =
            make_desc(sK + st * SM::KV_BYTES + (kk >> 2) * BK * 128 + col, 16);
        wgmma_ss_m64n64k16(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);

      // mask, scale, online softmax
      const int* sk = seg_s + st * BK;
      const bool diag = causal && k0 + BK - 1 > wq0;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const int2 kk2 = *reinterpret_cast<const int2*>(sk + 8 * i + 2 * tq);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kid = k0 + 8 * i + 2 * tq + e;
          const int skv = e ? kk2.y : kk2.x;
          const bool keep0 = sq0 != 0 && skv == sq0 && (!diag || qi0 >= kid);
          const bool keep1 = sq1 != 0 && skv == sq1 && (!diag || qi1 >= kid);
          s[4 * i + e] = keep0 ? s[4 * i + e] * scale : minus_inf();
          s[4 * i + 2 + e] = keep1 ? s[4 * i + 2 + e] * scale : minus_inf();
          mx0 = fmaxf(mx0, s[4 * i + e]);
          mx1 = fmaxf(mx1, s[4 * i + 2 + e]);
        }
      }
#pragma unroll
      for (int d = 1; d <= 2; d <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, d));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, d));
      }
      // a row that has seen no valid key keeps max -inf: subtract 0 then,
      // so every p is exp(-inf) = 0, never NaN
      const float base0 = mx0 == minus_inf() ? 0.f : mx0;
      const float base1 = mx1 == minus_inf() ? 0.f : mx1;
      const float alpha0 = expf(m0 - base0), alpha1 = expf(m1 - base1);
      m0 = mx0;
      m1 = mx1;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * i + e] = expf(s[4 * i + e] - base0);
          s[4 * i + 2 + e] = expf(s[4 * i + 2 + e] - base1);
        }
      }
      l0 = l0 * alpha0 + tile_row_sum<0>(s);
      l1 = l1 * alpha1 + tile_row_sum<2>(s);
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        acc[4 * i] *= alpha0;
        acc[4 * i + 1] *= alpha0;
        acc[4 * i + 2] *= alpha1;
        acc[4 * i + 3] *= alpha1;
      }

      // O += P V, 16 keys a step. P's A fragment is S's accumulator layout:
      // keys 16 kk + 2 tq (+8) of rows r, r + 8 are s[8 kk .. 8 kk + 7].
      // The fragments stay live until the products that read them are done.
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_pv<HD>(acc, pa[kk], make_desc(sV + st * SM::KV_BYTES + kk * 16 * 128, BK * 128));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
    }
    j = jn;
    st ^= 1;
  }

  // --- 4. epilogue: normalise, zero rows that saw no valid key ------------
  bf16* ob = o + (size_t)b * L * q_row + (size_t)h * HD + 2 * tq;
  if (qi0 < L) {
    uint32_t* row = reinterpret_cast<uint32_t*>(ob + (size_t)qi0 * q_row);
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      row[4 * i] = l0 > 0.f ? pack_bf16(acc[4 * i] / l0, acc[4 * i + 1] / l0) : 0u;
    if (tq == 0) lse[((size_t)b * nq + h) * L + qi0] = l0 > 0.f ? m0 + logf(l0) : NEG_INF;
  }
  if (qi1 < L) {
    uint32_t* row = reinterpret_cast<uint32_t*>(ob + (size_t)qi1 * q_row);
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      row[4 * i] = l1 > 0.f ? pack_bf16(acc[4 * i + 2] / l1, acc[4 * i + 3] / l1) : 0u;
    if (tq == 0) lse[((size_t)b * nq + h) * L + qi1] = l1 > 0.f ? m1 + logf(l1) : NEG_INF;
  }
}

template <int HD>
size_t smem_bytes(int L) {
  const int nwords = ((L + BK - 1) / BK + 31) / 32;
  return 1024 + Smem<HD>::MASK + (size_t)NWG * nwords * 4;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* seg, void* o,
           void* lse, int B, int L, int nq, int nkv, float scale, int causal,
           cudaStream_t stream) {
  if (B == 0 || L == 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes<HD>(L);
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
