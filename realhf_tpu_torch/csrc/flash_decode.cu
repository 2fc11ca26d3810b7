// Flash-decode attention against a head-major KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernels realhf_tpu/ops/decode_attention.py
// `_layer_kernel` / `_layer_kernel_stats` (via `flash_decode_attention`)
// and `_stacked_kernel` / `_stacked_kernel_stats` (via
// `flash_decode_attention_stacked`), which share the body `_decode_body`:
// one new query token per stream attends over its cache slots with an
// online softmax; slot s is kept iff keep[b, s] > 0 (validity AND any
// sliding window, computed by the caller). A stream with no kept slot
// gets 0. Optionally writes the softmax statistics (m, l) per query head.
//
// The cache is addressed by pointer plus strides, cache element
// (b, h, s, d) at base[b * sb + h * sh + s * ss + d], so the stacked-cache
// entry is the same launch at layer l's offset of the [nl, B, nkv, S, hd]
// cache -- no copy of the layer and no scalar-prefetch machinery.
//
// What bounds it on the H100: bytes. At B 8, S 640, 32 KV heads, hd 128
// one layer's K and V are 84 MB against ~0.3 GFLOP, so the floor is
// ~25 us at 3.35 TB/s. The design: one CTA per (KV head, stream) serving
// every query head of its GQA group from each staged K/V tile, so each
// cache byte is read from device memory once; 64-slot tiles are loaded
// with 16-byte coalesced reads into shared memory whose rows are padded
// to an odd number of 32-bit words, so the per-slot dot products and the
// per-column PV sums read it without bank conflicts. Scores, softmax
// statistics and the output accumulator are fp32.
//
// Later work: split S across CTAs (and merge the parts with the same
// (m, l) rule) so that small batches fill all 132 SMs -- at B 8 with
// 32 KV heads the grid is 256 CTAs, one wave; double-buffer the tile
// loads (cp.async or TMA) to overlap them with the arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define NEG_INF (-1073741824.0f)  // -2^30, the JAX package's sentinel

namespace {

constexpr int NTHREADS = 128;
constexpr int TS = 64;     // cache slots per staged tile (two per lane)
constexpr int MAXG = 16;   // most query heads per KV head served

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
flash_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                    const bf16* __restrict__ vc, const int* __restrict__ keep,
                    bf16* __restrict__ out, float* __restrict__ m_out,
                    float* __restrict__ l_out, int nq, int nkv, int S,
                    long long sb, long long sh, long long ss, float scale) {
  constexpr int LDK = HD + 2;       // bf16 row stride: HD/2 + 1 words (odd)
  constexpr int HALF = HD / 2;      // bf16 pairs per row
  constexpr int CHUNKS = HD / 8;    // 16-byte chunks per row
  constexpr int ITEMS = (MAXG * HALF + NTHREADS - 1) / NTHREADS;
  __shared__ __align__(16) bf16 Ks[TS * LDK];
  __shared__ __align__(16) bf16 Vs[TS * LDK];
  __shared__ float qs[MAXG * HD];
  __shared__ float ps[MAXG * TS];
  __shared__ float m_s[MAXG], l_s[MAXG], a_s[MAXG];
  __shared__ int keep_s[TS];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = nq / nkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const bf16* kb = kc + b * sb + kvh * sh;
  const bf16* vb = vc + b * sb + kvh * sh;
  const int* keepb = keep + (size_t)b * S;
  const size_t q_base = ((size_t)b * nq + (size_t)kvh * G) * HD;

  for (int i = tid; i < G * HD; i += NTHREADS)
    qs[i] = __bfloat162float(q[q_base + i]) * scale;
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float2 acc[ITEMS];
#pragma unroll
  for (int n = 0; n < ITEMS; ++n) acc[n] = make_float2(0.f, 0.f);

  for (int t0 = 0; t0 < S; t0 += TS) {
    __syncthreads();  // previous tile fully consumed (and q staged)
    for (int i = tid; i < TS * CHUNKS; i += NTHREADS) {
      const int r = i / CHUNKS, c = i % CHUNKS, s = t0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;  // zero slots past S
      if (s < S) {
        kv = *reinterpret_cast<const uint4*>(kb + s * ss + c * 8);
        vv = *reinterpret_cast<const uint4*>(vb + s * ss + c * 8);
      }
      uint32_t* kd = reinterpret_cast<uint32_t*>(Ks + r * LDK + c * 8);
      uint32_t* vd = reinterpret_cast<uint32_t*>(Vs + r * LDK + c * 8);
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
    }
    for (int r = tid; r < TS; r += NTHREADS) {
      const int s = t0 + r;
      keep_s[r] = s < S ? (keepb[s] > 0 ? 1 : 0) : -1;  // -1: past the cache
    }
    __syncthreads();

    // Scores: item (g, slot); neighbouring threads take neighbouring slots.
    for (int i = tid; i < G * TS; i += NTHREADS) {
      const int g = i / TS, r = i % TS;
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(Ks + r * LDK);
      const float* qg = qs + g * HD;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HALF; ++d) {
        const float2 kf = __bfloat1622float2(k2[d]);
        dot = fmaf(qg[2 * d], kf.x, dot);
        dot = fmaf(qg[2 * d + 1], kf.y, dot);
      }
      const int kp = keep_s[r];
      // Slots past the cache contribute exactly nothing (p = 0 even for
      // an empty stream); masked slots take NEG_INF like the reference.
      ps[g * TS + r] = kp > 0 ? dot : (kp == 0 ? NEG_INF : -INFINITY);
    }
    __syncthreads();

    // Online softmax update, one warp per query head of the group.
    for (int g = warp; g < G; g += NTHREADS / 32) {
      const float s0 = ps[g * TS + lane], s1 = ps[g * TS + lane + 32];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      // An empty stream keeps m == NEG_INF; its p = 1 garbage is
      // zeroed in the epilogue.
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float psum = warp_sum(p0 + p1);
      // p feeds PV in the cache's dtype, as in the reference kernel.
      ps[g * TS + lane] = __bfloat162float(__float2bfloat16(p0));
      ps[g * TS + lane + 32] = __bfloat162float(__float2bfloat16(p1));
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + psum;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V; item (g, column pair).
#pragma unroll
    for (int n = 0; n < ITEMS; ++n) {
      const int j = tid + n * NTHREADS;
      if (j < G * HALF) {
        const int g = j / HALF, dp = j % HALF;
        const float a = a_s[g];
        float2 o = acc[n];
        o.x *= a;
        o.y *= a;
        const float* pg = ps + g * TS;
#pragma unroll 8
        for (int r = 0; r < TS; ++r) {
          const float2 vf = __bfloat1622float2(
              reinterpret_cast<const __nv_bfloat162*>(Vs + r * LDK)[dp]);
          o.x = fmaf(pg[r], vf.x, o.x);
          o.y = fmaf(pg[r], vf.y, o.y);
        }
        acc[n] = o;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int n = 0; n < ITEMS; ++n) {
    const int j = tid + n * NTHREADS;
    if (j < G * HALF) {
      const int g = j / HALF, dp = j % HALF;
      const float m = m_s[g], l = l_s[g];
      const bool valid = m > NEG_INF / 2;
      const float safe_l = l > 0.f ? l : 1.f;
      const float2 o = acc[n];
      reinterpret_cast<__nv_bfloat162*>(out + q_base + (size_t)g * HD)[dp] =
          __floats2bfloat162_rn(valid ? o.x / safe_l : 0.f, valid ? o.y / safe_l : 0.f);
    }
  }
  if (m_out != nullptr && tid < G) {
    const size_t row = (size_t)b * nq + (size_t)kvh * G + tid;
    m_out[row] = m_s[tid];
    l_out[row] = l_s[tid];
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* keep, void* out,
           void* m, void* l, int B, int nq, int nkv, int S, long long sb,
           long long sh, long long ss, float scale, cudaStream_t stream) {
  dim3 grid(nkv, B);
  flash_decode_kernel<HD><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(keep),
      static_cast<bf16*>(out), static_cast<float*>(m), static_cast<float*>(l), nq,
      nkv, S, sb, sh, ss, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 = launched). `m` and `l` may both be
// null (no statistics). Allocates nothing; runs on `stream` without
// synchronising.
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* keep, void* out, void* m, void* l,
                                 int B, int nq, int nkv, int S, int hd, long long sb,
                                 long long sh, long long ss, float scale,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nq % nkv != 0 || nq / nkv > MAXG) return (int)cudaErrorInvalidValue;
  if (hd == 128)
    return launch<128>(q, k, v, keep, out, m, l, B, nq, nkv, S, sb, sh, ss, scale, st);
  if (hd == 64)
    return launch<64>(q, k, v, keep, out, m, l, B, nq, nkv, S, sb, sh, ss, scale, st);
  return (int)cudaErrorInvalidValue;
}
