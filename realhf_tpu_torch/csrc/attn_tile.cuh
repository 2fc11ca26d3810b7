// The attention tile machinery that K1 (csrc/flash_fwd.cu) and K6
// (csrc/ring_attention.cu) share, for Hopper (sm_90a).
//
// A CTA owns BQ = 128 query rows of one head of one batch row: two
// consumer warpgroups of 64 rows each. It summarises each warpgroup's
// segment ids as a range and a set of residues mod 64 (`q_id_summary`),
// marks the 64-key tiles each warpgroup needs in two shared bitmasks
// (`mark_tiles`, with the kernel's own rule), and walks the marked tiles
// (`walk_tiles`) through a two-stage ring of K, V and seg tiles filled by
// 16-byte `cp.async` copies one marked tile ahead (`load_kv_tile`). Each
// warpgroup computes only on its own marks with `tile_step`: S = Q K^T
// and O += P V as `wgmma.mma_async` (bf16 in, fp32 accumulate), the
// online softmax on the accumulator registers. S, P and O never touch
// shared memory. Tiles are stored in the 128-byte swizzle the wgmma
// descriptors name (16-byte chunk c of row r at chunk c ^ (r % 8) of its
// 128-byte row, hd split into 64-column atoms), so the copies and the
// tensor cores both see conflict-free banks.
//
// Both kernels round the same way because they run this one tile step:
// expf of the scaled score less the row max, and each tile's row sum in
// one fixed butterfly order (`tile_row_sum`). The ctx path holds K6's
// c4 log-probs against K1's c1 over 32 layers, and two copies of this
// arithmetic would drift apart with the first edit to either.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

typedef __nv_bfloat16 bf16;

#define NEG_INF (-1073741824.0f)  // -2^30, the JAX package's sentinel

namespace attn {

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

// Dynamic shared memory of a CTA whose bitmasks hold `n_tiles` key tiles,
// with the slack that aligns the base to 1024 bytes.
template <int HD>
size_t smem_bytes(int n_tiles) {
  const int nwords = (n_tiles + 31) / 32;
  return 1024 + Smem<HD>::MASK + (size_t)NWG * nwords * 4;
}

// The 1024-byte aligned base of the dynamic shared memory, as a generic
// pointer and as a shared-window address.
__device__ __forceinline__ unsigned char* smem_base(unsigned char* raw, uint32_t& saddr) {
  const uint32_t raw_addr = (uint32_t)__cvta_generic_to_shared(raw);
  const uint32_t pad = ((raw_addr + 1023u) & ~1023u) - raw_addr;
  saddr = raw_addr + pad;
  return raw + pad;
}

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
// MN-major (transposed), 128-byte swizzle. D is d[OFF .. OFF + 63] (an
// n256 accumulator takes two of these, at 0 and 64).
template <int N, int OFF = 0>
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[N],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  static_assert(OFF + 64 <= N, "D out of the accumulator");
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
        "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]), "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
        "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]),
        "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]), "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
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

// hd 256: two n128 products over the same A fragments, O's columns 0-127
// (the tile's 64-column atoms 0-1) and 128-255 (atoms 2-3, two atoms of
// BK x 128 bytes further). O's accumulator layout is that of one m64n256
// product: columns 8 i + 2 tq + {0, 1} in o[4 i ..], i < 32.
template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&o)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_m64n128k16<128, 0>(o, a, db);
  wgmma_rs_m64n128k16<128, 64>(o, a, db + (uint64_t)((2 * BK * 128) >> 4));
}

// Sum of one row's 64 probabilities of a tile, held 16 to a thread by the
// four threads of a quad (s[4 i + OFF + e] is column 8 i + 2 tq + e):
// columns c and c ^ 32 first, then a butterfly over c ^ 16, ^ 8, ^ 4,
// ^ 2, ^ 1. Every thread of the quad gets the same sum.
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

// Whether a tile of keys at global positions [kf, kl] may hold a key that
// some of the query rows [qf, ql] see, by position alone: when causal, no
// key after the last row; with a sliding window (window >= 0; < 0 is
// none), the tile's last key less than `window` behind the first row.
// K1 and K2 mark their key tiles and K6 its rounds' key tiles by it; K3
// writes the same rule out from the key side.
__device__ __forceinline__ bool tile_in_reach(int kf, int kl, int qf, int ql, int causal,
                                              int window) {
  return (!causal || kf <= ql) && (window < 0 || qf - kl < window);
}

// Whether a query row with segment id `sq` keeps a key with id `id` that
// lies `dq` = row - key positions before it: the same non-zero id, when
// causal dq >= 0, with a window dq < window. `diag` and `wide` say whether
// the tile may break causality or the window at all, so the per-pair
// comparisons run only on the tiles where they can fail.
__device__ __forceinline__ bool keep_pair(int sq, int id, int dq, bool diag, bool wide,
                                          int window) {
  return sq != 0 && id == sq && (!diag || dq >= 0) && (!wide || dq < window);
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

// Whether warpgroup `g` marked any tile.
__device__ __forceinline__ bool any_marked(const uint32_t* vis, int nwords, int g) {
  uint32_t bits = 0;
  for (int w = 0; w < nwords; ++w) bits |= vis[g * nwords + w];
  return bits != 0;
}

// Each warpgroup's range [lo, hi] and set of residues mod 64 of the
// non-zero ids among seg[q0 .. q0 + BQ) below `limit` (lo > hi and no bits
// when it has none). `red` is scratch in shared memory; ends with a
// __syncthreads.
__device__ __forceinline__ void q_id_summary(const int* seg, int q0, int limit, int tid,
                                             int* red, int (&lo)[NWG], int (&hi)[NWG],
                                             uint64_t (&bits)[NWG]) {
  const int warp = tid >> 5, lane = tid & 31;
  if (tid < BQ) {
    const int t = q0 + tid;
    const int s = t < limit ? seg[t] : 0;
    int l = s != 0 ? s : INT_MAX, h = s != 0 ? s : INT_MIN;
    uint64_t b = s != 0 ? id_bit(s) : 0ull;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      l = min(l, __shfl_xor_sync(0xffffffffu, l, d));
      h = max(h, __shfl_xor_sync(0xffffffffu, h, d));
      b |= __shfl_xor_sync(0xffffffffu, b, d);
    }
    if (lane == 0) {
      red[4 * warp] = l;
      red[4 * warp + 1] = h;
      reinterpret_cast<uint64_t*>(red)[2 * warp + 1] = b;
    }
  }
  __syncthreads();
  const uint64_t* red_bits = reinterpret_cast<const uint64_t*>(red);
#pragma unroll
  for (int g = 0; g < NWG; ++g) {  // warps 2g and 2g + 1 hold its rows
    lo[g] = min(red[8 * g], red[8 * g + 4]);
    hi[g] = max(red[8 * g + 1], red[8 * g + 5]);
    bits[g] = red_bits[4 * g + 1] | red_bits[4 * g + 3];
  }
}

// Range [lo, hi] and residue set of the non-zero ids among seg[k0 .. k0 +
// n); `vec` when seg + k0 is 16-byte aligned and n a multiple of 4 or the
// tile's end. Folds into what lo / hi / bits already hold.
__device__ __forceinline__ void key_tile_ids(const int* seg, int k0, int n, bool vec,
                                             int& lo, int& hi, uint64_t& bits) {
  if (vec) {
    const int4* p = reinterpret_cast<const int4*>(seg + k0);
    for (int i = 0; i < n / 4; ++i) {
      const int4 x = p[i];
      const int e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (e[c] != 0) lo = min(lo, e[c]), hi = max(hi, e[c]), bits |= id_bit(e[c]);
    }
  } else {
    for (int i = 0; i < n; ++i) {
      const int e = seg[k0 + i];
      if (e != 0) lo = min(lo, e), hi = max(hi, e), bits |= id_bit(e);
    }
  }
}

// Fills the two bitmasks vis[g * nwords + w] over key tiles [0, n_tiles),
// one thread per tile: mark(j, m) sets m[g] when warpgroup g needs tile j.
// Ends with a __syncthreads.
template <class Mark>
__device__ __forceinline__ void mark_tiles(int n_tiles, int nwords, int tid, uint32_t* vis,
                                           Mark mark) {
  const int warp = tid >> 5, lane = tid & 31;
  for (int base = 0; base < n_tiles; base += NTHREADS) {
    const int j = base + tid;
    bool m[NWG];
#pragma unroll
    for (int g = 0; g < NWG; ++g) m[g] = false;
    if (j < n_tiles) mark(j, m);
#pragma unroll
    for (int g = 0; g < NWG; ++g) {
      const uint32_t bits = __ballot_sync(0xffffffffu, m[g]);
      const int w = (base >> 5) + warp;
      if (lane == 0 && w < nwords) vis[g * nwords + w] = bits;
    }
  }
  __syncthreads();
}

// cp.async of the ROWS (BQ unless said) query rows q0.. of one head into
// the swizzled Q tile at sQ; rows at or past `limit` are zero-filled.
// Commits nothing: the copies join the group of the first K/V tile.
template <int HD, int ROWS = BQ>
__device__ __forceinline__ void load_q_tile(uint32_t sQ, const bf16* qb, size_t q_row, int q0,
                                            int limit, int tid) {
  constexpr int CH = HD / 8;  // 16-byte chunks in a row
  for (int i = tid; i < ROWS * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH, t = q0 + r;
    const bool in = t < limit;
    cp_async16(sQ + swz(ROWS, r, c), qb + (size_t)(in ? t : 0) * q_row + c * 8, in);
  }
}

// cp.async of the 64-key tile at key k0 (K, V of one KV head, and the
// keys' seg ids) into stage `st`, and a commit. Keys at or past `limit`
// are zero-filled (seg 0 matches no query), never read.
template <int HD>
__device__ __forceinline__ void load_kv_tile(uint32_t sK, uint32_t sV, uint32_t sSeg,
                                             const bf16* kb, const bf16* vb, const int* segb,
                                             size_t kv_row, int k0, int limit, int st,
                                             int tid) {
  constexpr int CH = HD / 8;
  for (int i = tid; i < BK * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH, t = k0 + r;
    const bool in = t < limit;
    const size_t off = (size_t)(in ? t : 0) * kv_row + c * 8;
    const uint32_t dst = st * Smem<HD>::KV_BYTES + swz(BK, r, c);
    cp_async16(sK + dst, kb + off, in);
    cp_async16(sV + dst, vb + off, in);
  }
  if (tid < BK) {
    const int t = k0 + tid;
    cp_async4(sSeg + (st * BK + tid) * 4, segb + (t < limit ? t : 0), t < limit);
  }
  cp_async_commit();
}

// Walks the marked tiles from `j` (the first, already requested into
// stage 0): waits for tile j, requests the next marked tile into the other
// stage with load(jn, stage), and runs step(j, stage) on the warpgroups
// that marked j. One __syncthreads per tile.
template <class Load, class Step>
__device__ __forceinline__ void walk_tiles(const uint32_t* vis, int nwords, int wg, int j,
                                           Load load, Step step) {
  int st = 0;
  while (j >= 0) {
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // tile j is in stage st; every warpgroup left stage st ^ 1
    const int jn = next_tile(vis, nwords, j);
    if (jn >= 0) load(jn, st ^ 1);
    if ((vis[wg * nwords + (j >> 5)] >> (j & 31)) & 1u) step(j, st);
    j = jn;
    st ^= 1;
  }
}

// One 64-key tile (stage tiles sK / sV / seg_tile) against warpgroup wg's
// 64 query rows of the Q tile at sQ, all in registers: S = Q K^T, the
// scores kept by keep(row, col, id) (row 0 or 1 of the thread's two, key
// column col of the tile with seg id `id`) and scaled, the rest -inf; the
// row max, expf of each score less it, the row sum, the rescale of l and
// O by alpha, and O += P V. The online-softmax state is the thread's two
// rows of its warpgroup's 64 (the accumulator layout): rows r and r + 8
// with max m0 / m1 and sum l0 / l1 (-inf and 0 before any valid key), O
// columns 8 i + 2 tq + {0, 1} in acc[4 i + {0, 1}] and acc[4 i + {2, 3}].
// (Kept in plain references: as a struct the same arithmetic ran ~3%
// slower at the sft shape on an H100.)
template <int HD, class Keep>
__device__ __forceinline__ void tile_step(float (&acc)[HD / 2], float& m0, float& m1,
                                          float& l0, float& l1, uint32_t sQ, int wg,
                                          uint32_t sK, uint32_t sV, const int* seg_tile,
                                          int tq, float scale, Keep keep) {
  // S = Q K^T over hd, 16 columns a step
  float s[BK / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;  // 16 columns = 32 bytes into the atom
    const uint64_t da = make_desc(sQ + (kk >> 2) * BQ * 128 + wg * WG_ROWS * 128 + col, 16);
    const uint64_t db = make_desc(sK + (kk >> 2) * BK * 128 + col, 16);
    wgmma_ss_m64n64k16(s, da, db, kk > 0);
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(s);

  // mask, scale, online softmax
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    const int2 kk2 = *reinterpret_cast<const int2*>(seg_tile + 8 * i + 2 * tq);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * i + 2 * tq + e;
      const int skv = e ? kk2.y : kk2.x;
      const bool keep0 = keep(0, c, skv);
      const bool keep1 = keep(1, c, skv);
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
    wgmma_pv<HD>(acc, pa[kk], make_desc(sV + kk * 16 * 128, BK * 128));
  wgmma_commit();
  wgmma_wait0();
  fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
}

// Writes a thread's row of O, normalised by l (0 when the row saw no valid
// key), as bf16 at `row` (this thread's first column, 2 tq), from acc[4 i +
// OFF + {0, 1}].
template <int HD, int OFF>
__device__ __forceinline__ void store_o_row(bf16* row, const float (&acc)[HD / 2], float l) {
  uint32_t* out = reinterpret_cast<uint32_t*>(row);
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
    out[4 * i] = l > 0.f ? pack_bf16(acc[4 * i + OFF] / l, acc[4 * i + OFF + 1] / l) : 0u;
}

}  // namespace attn
