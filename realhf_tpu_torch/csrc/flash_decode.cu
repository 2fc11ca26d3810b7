// Flash-decode attention against a head-major KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernels realhf_tpu/ops/decode_attention.py
// `_layer_kernel:114` / `_layer_kernel_stats:124` (via
// `flash_decode_attention`) and `_stacked_kernel:135` /
// `_stacked_kernel_stats:148` (via `flash_decode_attention_stacked`), which
// share the body `_decode_body:69`: one new query token per stream attends
// over its cache slots with an online softmax. Slot s of stream b is kept
// iff valid[b, s] and, with a window, slot[b] - s < window. A stream with
// no kept slot gets 0. Optionally writes the softmax statistics (m, l) per
// query head, with the reference's contract for masked slots: they score
// NEG_INF, so an empty stream reports m = NEG_INF and l = S.
//
// The cache is addressed by pointer plus strides, cache element
// (b, h, s, d) at base[b * sb + h * sh + s * ss + d], so the stacked-cache
// entry is the same launch at layer l's offset of the [nl, B, nkv, S, hd]
// cache, with no copy of the layer.
//
// What bounds it on the H100: bytes. At B 8, S 640, 32 KV heads, hd 128
// one layer's K and V are 84 MB, of which the gen path keeps ~45% (left
// padding, slots not yet written); against ~0.04 GFLOP the floor is the
// kept bytes over 3.35 TB/s, ~11 us. The design:
//
// - One 128-thread CTA per (stream, KV head): grid (1, nkv, B). It scans
//   the stream's `valid` bytes into a bitmask of kept slots (16-byte
//   loads, several in flight a thread, so a long cache costs one round
//   trip and not one a word) and lists the 64-slot tiles that hold a kept
//   slot. Tiles outside the kept range and interior tiles with no kept
//   slot are never loaded. An empty stream writes 0, m = NEG_INF, l = S
//   and loads nothing.
// - Each of the 4 warps owns 16 slots of every listed tile and runs its
//   own online softmax: its K/V sub-tiles come through a private ring of
//   STAGES buffers filled by 16-byte `cp.async` copies STAGES - 1
//   sub-tiles ahead (slots past S zero-filled), so the warps never wait
//   for each other inside the walk. Scores and P V are
//   `mma.sync` m16n8k16 (bf16 in, fp32 accumulate) with the query group
//   padded to 16 rows: the score accumulator is reused as the A operand of
//   P V (p rounded to bf16, as the reference feeds PV), so no lane idles at
//   G = 1 and nothing but the K/V tiles touches shared memory. The tiles
//   sit in the 128-byte swizzle of csrc/attn_tile.cuh (`swz`), so the
//   copies and `ldmatrix` see conflict-free banks.
// - The merge is the flash merge of the JAX package's sequence split
//   (`sharded_decode_attention_seqsplit`, decode_attention.py:488-498):
//   m = max m_i, l = sum l_i exp(m_i - m), out = sum acc_i exp(m_i - m) / l,
//   over the 4 warp partials: each warp leaves its fp32 partial (m, l, acc
//   for the group's G rows) in its own ring, and after one barrier the CTA
//   merges them and writes out, m and l. One launch a call, no workspace,
//   no atomics: two launches give the same bits.
//
// A stream is not split over several CTAs. A split over a thread-block
// cluster of 2-8 CTAs, merged through distributed shared memory, read
// slower on the H100 at every decode cache the port runs (S 640, 256-512
// (stream, KV head) pairs; PERF.md's K4 findings): each CTA's fixed cost,
// the scan of `valid` and its first tile's latency, weighs as much as the
// walk it would save.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8): 194 registers at hd 128 and 121
// at hd 64, 0 bytes spilled, no static shared memory; dynamic shared
// memory 98,304 bytes (hd 128; 49,152 at hd 64) of rings plus 16 + 4
// (S / 32 + S / 64) for the scan, 98,440 at S 640: two CTAs an SM at
// hd 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_tile.cuh"

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int TS = 64;            // cache slots per tile
constexpr int WS = TS / NWARPS;   // slots of each tile one warp owns
constexpr int MAXG = 16;          // most query heads per KV head (mma rows)
constexpr int STAGES = 3;         // a warp's ring: 2 sub-tiles in flight
constexpr int SMEM_LIMIT = 232448;

template <int HD>
struct Layout {
  // byte offsets into the dynamic shared memory
  static constexpr int SUB = WS * HD * 2;              // one warp's K (or V) sub-tile
  static constexpr int WARP_RING = STAGES * 2 * SUB;   // K and V per stage
  static constexpr int RING = NWARPS * WARP_RING;
  // After the walk each warp leaves its partial in its own ring: acc
  // [MAXG][HD] fp32, then m [MAXG], l [MAXG].
  static constexpr int WACC = 0;
  static constexpr int WM = MAXG * HD * 4;
  static constexpr int WL = WM + MAXG * 4;
  static constexpr int WEND = WL + MAXG * 4;
  // The merge weights of the NWARPS partials and the rows' denominators,
  // behind warp 0's partial in its ring.
  static constexpr int WGT = WEND;
  static constexpr int DEN = WGT + NWARPS * MAXG * 4;
  static_assert(DEN + MAXG * 4 <= WARP_RING, "a warp's partial and the merge must fit its ring");
  // Read during the walk, so never inside a ring: the count of marked
  // tiles, the kept-slot bits, the marked tiles' list.
  static constexpr int INFO = RING;
  static constexpr int KEEP = INFO + 16;
};

template <int HD>
size_t smem_bytes(int S) {
  const int nwords = (S + 31) / 32, n_tiles = (S + TS - 1) / TS;
  return (size_t)Layout<HD>::KEEP + 4 * (size_t)(nwords + n_tiles);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// D[16 x 8] += A[16 x 16] * B[16 x 8], bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Keep bits of the 16 slots s0.. whose `valid` bytes are `v`: bit k set
// iff byte k is not 0 and slot s0 + k lies in the window.
__device__ __forceinline__ uint32_t keep_bits16(uint4 v, int s0, int window, int slot_b) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t bits = 0u;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const bool on = ((w[k >> 2] >> (8 * (k & 3))) & 0xffu) != 0u;
    bits |= (uint32_t)(on && (window <= 0 || slot_b - (s0 + k) < window)) << k;
  }
  return bits;
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                    const bf16* __restrict__ vc, const uint8_t* __restrict__ valid,
                    const int* __restrict__ slot, int window, bf16* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ l_out, int nq, int nkv,
                    int S, long long sb, long long sh, long long ss, float scale,
                    int drop_warp) {
  using L = Layout<HD>;
  constexpr int CH = HD / 8;  // 16-byte chunks in a cache row
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = nq / nkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nwords = (S + 31) / 32, n_tiles = (S + TS - 1) / TS;
  uint32_t* keepw = reinterpret_cast<uint32_t*>(smem + L::KEEP);
  int* tiles = reinterpret_cast<int*>(smem + L::KEEP + 4 * nwords);
  int* info = reinterpret_cast<int*>(smem + L::INFO);
  const size_t q_base = ((size_t)b * nq + (size_t)kvh * G) * HD;

  // The query rows as mma A fragments (rows past G zero), requested
  // before the scan so their latency hides under it.
  const int g0 = lane >> 2, g1 = g0 + 8, kq = 2 * (lane & 3);
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const bf16* r0 = q + q_base + (size_t)g0 * HD + kk * 16 + kq;
    const bf16* r1 = q + q_base + (size_t)g1 * HD + kk * 16 + kq;
    qa[kk][0] = g0 < G ? ld_pair(r0) : 0u;
    qa[kk][1] = g1 < G ? ld_pair(r1) : 0u;
    qa[kk][2] = g0 < G ? ld_pair(r0 + 8) : 0u;
    qa[kk][3] = g1 < G ? ld_pair(r1 + 8) : 0u;
  }

  // Kept slots as bits, 32 a word. Where the rows allow 16-byte loads
  // (S a multiple of 16), 16 slots a lane and 4 loads a thread in
  // flight, two lanes' halves joined into a word: one round trip covers
  // 8192 slots. Else one byte a lane, one warp ballot a word.
  {
    const uint8_t* vb = valid + (size_t)b * S;
    const int slot_b = window > 0 ? slot[b] : 0;
    if ((S & 15) == 0 && (reinterpret_cast<uintptr_t>(vb) & 15) == 0) {
      constexpr int VEC = 4;
      const int nchunks = S / 16;
      for (int base = 0; base < nchunks; base += NTHREADS * VEC) {  // uniform
        uint4 v[VEC];
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          const int c = base + u * NTHREADS + tid;
          v[u] = c < nchunks ? reinterpret_cast<const uint4*>(vb)[c] : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          const int c = base + u * NTHREADS + tid;  // even on even lanes
          const uint32_t bits = keep_bits16(v[u], c * 16, window, slot_b);
          const uint32_t hi = __shfl_down_sync(0xffffffffu, bits, 1);
          if ((lane & 1) == 0 && c < nchunks) keepw[c / 2] = bits | (hi << 16);
        }
      }
    } else {
      for (int w0 = warp; w0 < nwords; w0 += 4 * NWARPS) {
        uint8_t v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int s = (w0 + u * NWARPS) * 32 + lane;
          v[u] = s < S ? vb[s] : (uint8_t)0;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int w = w0 + u * NWARPS;
          if (w < nwords) {  // warp-uniform
            const int s = w * 32 + lane;
            const bool kept = v[u] != 0 && (window <= 0 || slot_b - s < window);
            const uint32_t bits = __ballot_sync(0xffffffffu, kept);
            if (lane == 0) keepw[w] = bits;
          }
        }
      }
    }
  }
  __syncthreads();
  // The tiles that hold a kept slot, in order (warp 0).
  if (warp == 0) {
    int count = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const int t = t0 + lane;
      bool marked = false;
      if (t < n_tiles)
        marked = (keepw[2 * t] | (2 * t + 1 < nwords ? keepw[2 * t + 1] : 0u)) != 0u;
      const uint32_t bal = __ballot_sync(0xffffffffu, marked);
      if (marked) tiles[count + __popc(bal & ((1u << lane) - 1u))] = t;
      count += __popc(bal);
    }
    if (lane == 0) info[0] = count;
  }
  __syncthreads();
  const int n_sub = info[0];

  if (n_sub == 0) {
    // Empty stream: every in-cache slot scores NEG_INF in the reference,
    // so p = 1 for each: l = S.
    for (int e = tid; e < G * HD; e += NTHREADS) out[q_base + e] = __float2bfloat16(0.f);
    if (m_out != nullptr && tid < G) {
      const size_t row = (size_t)b * nq + (size_t)kvh * G + tid;
      m_out[row] = NEG_INF;
      l_out[row] = (float)S;
    }
    return;
  }

  // Each warp walks its 16 slots of every marked tile.
  const bf16* kb = kc + b * sb + kvh * sh;
  const bf16* vb = vc + b * sb + kvh * sh;
  const uint32_t ring = sbase + warp * L::WARP_RING;

  auto load = [&](int j, int st) {
    const int s0 = tiles[j] * TS + warp * WS;
    const uint32_t sk = ring + st * 2 * L::SUB, sv = sk + L::SUB;
#pragma unroll
    for (int it = 0; it < WS * CH / 32; ++it) {
      const int i = lane + 32 * it, r = i / CH, c = i % CH, s = s0 + r;
      const bool in = s < S;
      const size_t off = (size_t)(in ? s : 0) * ss + c * 8;
      const uint32_t dst = attn::swz(WS, r, c);
      attn::cp_async16(sk + dst, kb + off, in);
      attn::cp_async16(sv + dst, vb + off, in);
    }
  };

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < n_sub) load(p, p);
    attn::cp_async_commit();
  }
  for (int i = 0; i < n_sub; ++i) {
    __syncwarp();  // every lane is done with the stage refilled below
    if (i + STAGES - 1 < n_sub) load(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    attn::cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();  // the sub-tile's copies by every lane have landed

    const int st = i % STAGES;
    const uint32_t sk = ring + st * 2 * L::SUB, sv = sk + L::SUB;
    const int s0 = tiles[i] * TS + warp * WS;

    // S^T for the warp's 16 slots: two 8-slot column blocks.
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    {
      const int r = (lane & 7) + ((lane >> 4) << 3);
      const int cc = (lane >> 3) & 1;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t kf[4];
        ldsm_x4(kf, sk + attn::swz(WS, r, 2 * kk + cc));
        mma16816(sc[0], qa[kk], kf[0], kf[1]);
        mma16816(sc[1], qa[kk], kf[2], kf[3]);
      }
    }
    // Mask: kept slots score q.k * scale, masked ones NEG_INF (as in the
    // reference), slots past the cache -inf (p = 0 exactly).
    const uint32_t bits = (s0 >> 5) < nwords ? (keepw[s0 >> 5] >> (s0 & 31)) & 0xffffu : 0u;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int off = 8 * j + kq + e;
        const bool kept = (bits >> off) & 1u;
        const float fill = s0 + off < S ? NEG_INF : attn::minus_inf();
        sc[j][e] = kept ? sc[j][e] * scale : fill;
        sc[j][2 + e] = kept ? sc[j][2 + e] * scale : fill;
      }
    }
    // Online softmax on rows g0 (values 0, 1) and g1 (values 2, 3); a
    // row's 16 slots live in one quad of lanes.
    float mx0 = fmaxf(fmaxf(sc[0][0], sc[0][1]), fmaxf(sc[1][0], sc[1][1]));
    float mx1 = fmaxf(fmaxf(sc[0][2], sc[0][3]), fmaxf(sc[1][2], sc[1][3]));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m_run[0], mx0), mn1 = fmaxf(m_run[1], mx1);
    const float al0 = expf(m_run[0] - mn0), al1 = expf(m_run[1] - mn1);
    m_run[0] = mn0;
    m_run[1] = mn1;
    float p[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      p[j][0] = expf(sc[j][0] - mn0);
      p[j][1] = expf(sc[j][1] - mn0);
      p[j][2] = expf(sc[j][2] - mn1);
      p[j][3] = expf(sc[j][3] - mn1);
    }
    l_run[0] = l_run[0] * al0 + ((p[0][0] + p[0][1]) + (p[1][0] + p[1][1]));
    l_run[1] = l_run[1] * al1 + ((p[0][2] + p[0][3]) + (p[1][2] + p[1][3]));
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }
    // The score accumulator is the A fragment of P V (slots as k).
    const uint32_t pa[4] = {attn::pack_bf16(p[0][0], p[0][1]), attn::pack_bf16(p[0][2], p[0][3]),
                            attn::pack_bf16(p[1][0], p[1][1]), attn::pack_bf16(p[1][2], p[1][3])};
    {
      const int r = (lane & 7) + (((lane >> 3) & 1) << 3);
      const int cc = lane >> 4;
#pragma unroll
      for (int n2 = 0; n2 < HD / 16; ++n2) {
        uint32_t vf[4];
        ldsm_x4_t(vf, sv + attn::swz(WS, r, 2 * n2 + cc));
        mma16816(o[2 * n2], pa, vf[0], vf[1]);
        mma16816(o[2 * n2 + 1], pa, vf[2], vf[3]);
      }
    }
  }
  attn::cp_async_wait_all();
  __syncwarp();

  // Each warp leaves its partial (the group's G rows) in its own ring.
  {
    unsigned char* wbase = smem + warp * L::WARP_RING;
    float* wacc = reinterpret_cast<float*>(wbase + L::WACC);
    float* wm = reinterpret_cast<float*>(wbase + L::WM);
    float* wl = reinterpret_cast<float*>(wbase + L::WL);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int d = 8 * n + kq;
      if (g0 < G) *reinterpret_cast<float2*>(wacc + g0 * HD + d) = make_float2(o[n][0], o[n][1]);
      if (g1 < G) *reinterpret_cast<float2*>(wacc + g1 * HD + d) = make_float2(o[n][2], o[n][3]);
    }
    if ((lane & 3) == 0) {
      wm[g0] = m_run[0];
      wm[g1] = m_run[1];
      wl[g0] = l_run[0];
      wl[g1] = l_run[1];
    }
  }
  __syncthreads();  // every warp's partial is written

  // One merge of the NWARPS partials. `drop_warp` (>= 0 only in a
  // planted-fault check) leaves that warp's partial out.
  float* wgt = reinterpret_cast<float*>(smem + L::WGT);
  float* den = reinterpret_cast<float*>(smem + L::DEN);
  if (tid < G) {
    float mi[NWARPS], li[NWARPS], m = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      mi[w] = reinterpret_cast<const float*>(smem + w * L::WARP_RING + L::WM)[tid];
      li[w] = reinterpret_cast<const float*>(smem + w * L::WARP_RING + L::WL)[tid];
      if (w != drop_warp) m = fmaxf(m, mi[w]);
    }
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float a = w != drop_warp ? expf(mi[w] - m) : 0.f;
      wgt[w * MAXG + tid] = a;
      l += li[w] * a;
    }
    // a row that saw no kept slot gives 0, as in the reference
    den[tid] = m > NEG_INF / 2 ? (l > 0.f ? l : 1.f) : 0.f;
    if (m_out != nullptr) {
      const size_t row = (size_t)b * nq + (size_t)kvh * G + tid;
      m_out[row] = m;
      l_out[row] = l;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * HD; e += NTHREADS) {
    const int g = e / HD, d = e % HD;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w)
      acc += reinterpret_cast<const float*>(smem + w * L::WARP_RING + L::WACC)[g * HD + d] *
             wgt[w * MAXG + g];
    out[q_base + (size_t)g * HD + d] = __float2bfloat16(den[g] > 0.f ? acc / den[g] : 0.f);
  }
}

// The shared-memory attribute is set on every launch: it holds for the
// current device only, and a process may decode on several.
template <int HD>
int launch(const void* q, const void* k, const void* v, const void* valid, const void* slot,
           int window, void* out, void* m, void* l, int B, int nq, int nkv, int S, long long sb,
           long long sh, long long ss, float scale, int drop_warp, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>(S);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_decode_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_decode_kernel<HD><<<dim3(1, nkv, B), NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(slot), window,
      static_cast<bf16*>(out), static_cast<float*>(m), static_cast<float*>(l), nq, nkv, S, sb, sh,
      ss, scale, drop_warp);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 = launched). `valid` is the [B, S] bool
// mask as bytes; `slot` ([B] int32) is read only when `window` > 0. `m`
// and `l` may both be null (no statistics). `drop_warp` is -1 except in a
// planted-fault check. Allocates nothing; runs on `stream` without
// synchronising.
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v, const void* valid,
                                 const void* slot, int window, void* out, void* m, void* l, int B,
                                 int nq, int nkv, int S, int hd, long long sb, long long sh,
                                 long long ss, float scale, int drop_warp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nq % nkv != 0 || nq / nkv > MAXG || S < 1) return (int)cudaErrorInvalidValue;
  if (window > 0 && slot == nullptr) return (int)cudaErrorInvalidValue;
  if (hd == 128)
    return launch<128>(q, k, v, valid, slot, window, out, m, l, B, nq, nkv, S, sb, sh, ss, scale,
                       drop_warp, st);
  if (hd == 64)
    return launch<64>(q, k, v, valid, slot, window, out, m, l, B, nq, nkv, S, sb, sh, ss, scale,
                      drop_warp, st);
  return (int)cudaErrorInvalidValue;
}
