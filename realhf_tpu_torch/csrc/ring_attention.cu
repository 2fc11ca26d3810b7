// Ring attention for Hopper (sm_90a): K6, one round of one member, and
// the push that moves the KV halves one member along the ring.
//
// Replaces the TPU kernel realhf_tpu/ops/ring_attention_fused.py
// `_ring_kernel:103` (launched by `_fused_local:343`, public entry
// `ring_attention_fused:417`). There one Pallas kernel per chip owns the
// whole ring: its grid walks the rounds in order, carries the fp32
// online-softmax state across them in HBM slabs, and moves the KV halves
// with remote DMAs fenced by semaphores. On the H100 the CTAs of a launch
// run in no order, so the ring becomes a sequence of launches, one
// `ring_round` per member per round on the member's compute stream and
// one `ring_push` per member per round but the last on its comm stream;
// the Python wrapper (ops/ring_attention_fused.py) orders them with CUDA
// events, the TPU kernel's slot handshake with events in place of
// semaphores. No kernel waits on another member's flag.
//
// ring_round: member `my` accumulates its q shard [B, lc, nq, hd] against
// the KV halves it holds this round, one per direction: direction 0 holds
// the [0, lch) half of shard (my - r) mod n, direction 1 the [lch, lc)
// half of shard (my + r) mod n (a unidirectional ring holds whole shards
// in direction 0). A query attends to a key iff both carry the same
// non-zero segment id and, on GLOBAL stream positions (q_off + row,
// k_off + key), the key is not later (causal) and less than `window`
// behind (sliding window, window < 0 = none). GQA: q head h reads KV head
// h / (nq / nkv). The fp32 state m / l / acc of each row lives in a
// per-member buffer between rounds: round 0 (`first`) starts it, the last
// round (`last`) normalises into o (bf16) and writes a row that saw no
// valid key as 0, never NaN; the rounds between load and store it.
//
// Layouts (row-major, contiguous): q/o [B, lc, nq, hd], segq [B, lc]
// int32; each direction's k/v [B, lch, nkv, hd] and seg [B, lch]; state
// m/l [B, nq, lc] and acc [B, nq, lc, hd] fp32.
//
// What bounds it on the H100: for one LLaMA-7B layer over a 32768-token
// stream of 5 documents on 4 members (the ctx-7b-c4 path) the allowed
// (query, key) pairs are ~132 M per head, ~2.2e12 FLOPs in all: 2.2 ms
// of tensor-core time on one card, against ~0.3 ms for the ~1.1 GB of
// q/k/v/o, so operations bound it. On four cards the FLOPs split (the
// member holding the stream's end does the most) and each member also
// sends its two KV halves (k and v, 67 MB a half) on three times, ~400 MB
// out of each card, ~0.9 ms at NVLink's 450 GB/s each way. The design
// is K1's (csrc/flash_fwd.cu): one CTA of 4 warps per (q tile of 64 rows,
// q head, batch row), 64-key tiles staged in shared memory with 16-byte
// loads, QK^T and PV through WMMA 16x16x16 bf16 fragments with fp32
// accumulation, the softmax statistics and output accumulator fp32 in
// shared memory. The one shortcut: a key tile that causality masks for
// every row of the q tile is not visited. Every tile before it is, however
// its segments fall, so on a packed stream the kernel does several times
// the allowed work; skipping tiles by segment, TMA + wgmma and keeping the
// state in registers across rounds are later work.
//
// ring_push: a grid-stride copy of up to six contiguous byte ranges (k, v
// and seg of each direction) from this member's current slot into its
// neighbours' other slot, written through the peer pointer when the
// neighbour is another card (peer access enabled by ring_enable_peer) and
// as a device-local copy when it shares this card.

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
constexpr int MAX_COPIES = 6;

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
ring_round_kernel(const bf16* __restrict__ q, const int* __restrict__ segq,
                  const bf16* __restrict__ k0, const bf16* __restrict__ v0,
                  const int* __restrict__ sk0, const bf16* __restrict__ k1,
                  const bf16* __restrict__ v1, const int* __restrict__ sk1,
                  float* __restrict__ m_st, float* __restrict__ l_st,
                  float* __restrict__ acc_st, bf16* __restrict__ o, int lc, int lch,
                  int nq, int nkv, int q_off, int k_off0, int k_off1, int n_dirs,
                  int first, int last, float scale, int causal, int window) {
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
  int* segq_s = reinterpret_cast<int*>(smem + LY::SEGQ);
  int* segk_s = reinterpret_cast<int*>(smem + LY::SEGK);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (nq / nkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * ROWS_PER_WARP;

  const size_t q_row = (size_t)nq * HD;    // elements between tokens of q/o
  const size_t kv_row = (size_t)nkv * HD;  // elements between tokens of k/v
  const bf16* qb = q + (size_t)b * lc * q_row + (size_t)h * HD;
  const int* segqb = segq + (size_t)b * lc;
  const size_t st0 = ((size_t)b * nq + h) * lc;  // (b, h, token 0) in m/l
  constexpr int CHUNKS = HD / 8;   // 16-byte chunks of a bf16 row
  constexpr int CHUNKS4 = HD / 4;  // 16-byte chunks of an fp32 row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < BQ * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS, t = q0 + r;
    uint4 val = zero;
    if (t < lc) val = *reinterpret_cast<const uint4*>(qb + (size_t)t * q_row + c * 8);
    *reinterpret_cast<uint4*>(Qs + r * LY::LDB + c * 8) = val;
  }
  // This round's starting state: fresh in round 0, else the last round's.
  for (int r = tid; r < BQ; r += NTHREADS) {
    const int t = q0 + r;
    const bool in = t < lc;
    segq_s[r] = in ? segqb[t] : 0;
    m_s[r] = (first || !in) ? NEG_INF : m_st[st0 + t];
    l_s[r] = (first || !in) ? 0.f : l_st[st0 + t];
  }
  for (int i = tid; i < BQ * CHUNKS4; i += NTHREADS) {
    const int r = i / CHUNKS4, c = i % CHUNKS4, t = q0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!first && t < lc)
      val = *reinterpret_cast<const float4*>(acc_st + (st0 + t) * HD + c * 4);
    *reinterpret_cast<float4*>(Os + r * LY::LDO + c * 4) = val;
  }

  const int q_hi = q_off + q0 + BQ - 1;  // the tile's last global q position
  for (int d = 0; d < n_dirs; ++d) {
    const size_t half = (size_t)b * lch * kv_row + (size_t)kvh * HD;
    const bf16* kb = (d ? k1 : k0) + half;
    const bf16* vb = (d ? v1 : v0) + half;
    const int* skb = (d ? sk1 : sk0) + (size_t)b * lch;
    const int k_off = d ? k_off1 : k_off0;
    int n_tiles = (lch + BK - 1) / BK;
    if (causal) {  // tiles wholly after the q tile's last row are masked
      const int reach = q_hi - k_off + 1;  // keys [0, reach) may be seen
      n_tiles = reach <= 0 ? 0 : min(n_tiles, (reach + BK - 1) / BK);
    }

    for (int j = 0; j < n_tiles; ++j) {
      const int k0t = j * BK;
      __syncthreads();  // every warp is done with the previous K/V tile
      for (int i = tid; i < BK * CHUNKS; i += NTHREADS) {
        const int r = i / CHUNKS, c = i % CHUNKS, t = k0t + r;
        uint4 kv = zero, vv = zero;  // zero rows past lch: 0 * garbage could be NaN
        if (t < lch) {
          kv = *reinterpret_cast<const uint4*>(kb + (size_t)t * kv_row + c * 8);
          vv = *reinterpret_cast<const uint4*>(vb + (size_t)t * kv_row + c * 8);
        }
        *reinterpret_cast<uint4*>(Ks + r * LY::LDB + c * 8) = kv;
        *reinterpret_cast<uint4*>(Vs + r * LY::LDB + c * 8) = vv;
      }
      for (int r = tid; r < BK; r += NTHREADS) {
        const int t = k0t + r;
        segk_s[r] = t < lch ? skb[t] : 0;  // seg 0 never matches a valid query
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

      // Online softmax on global positions; lane owns columns lane, lane + 32.
      for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
        const int r = r0 + rr;
        const int qg = q_off + q0 + r;
        const int sq = segq_s[r];
        float s[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = lane + 32 * c;
          const int kg = k_off + k0t + col;
          const bool keep = sq != 0 && segk_s[col] == sq && (!causal || qg >= kg) &&
                            (window < 0 || qg - kg < window);
          s[c] = keep ? Ss[r * LY::LDS + col] * scale : NEG_INF;
        }
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(s[0], s[1])));
        // A row that has seen no valid key keeps m == NEG_INF: its p = 1
        // garbage is wiped by alpha = 0 once a valid key arrives (in this
        // round or a later one), or zeroed when the last round finalises.
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
  }
  __syncthreads();  // the state loaded above is read below, tiles or none

  // Epilogue, per warp over its own rows: the last round normalises and
  // writes o (0 for a row that saw no valid key); the others store the
  // state for the next round.
  if (last) {
    for (int i = lane; i < ROWS_PER_WARP * CHUNKS; i += 32) {
      const int rr = i / CHUNKS, c = i % CHUNKS;
      const int r = r0 + rr, t = q0 + r;
      if (t >= lc) continue;
      const float m = m_s[r], l = l_s[r];
      const bool valid = m > NEG_INF / 2;
      const float safe_l = l > 0.f ? l : 1.f;
      __align__(16) bf16 vals[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        vals[e] = __float2bfloat16(valid ? Os[r * LY::LDO + c * 8 + e] / safe_l : 0.f);
      *reinterpret_cast<uint4*>(o + ((size_t)b * lc + t) * q_row + (size_t)h * HD + c * 8) =
          *reinterpret_cast<const uint4*>(vals);
    }
  } else {
    for (int i = lane; i < ROWS_PER_WARP * CHUNKS4; i += 32) {
      const int rr = i / CHUNKS4, c = i % CHUNKS4;
      const int r = r0 + rr, t = q0 + r;
      if (t >= lc) continue;
      *reinterpret_cast<float4*>(acc_st + (st0 + t) * HD + c * 4) =
          *reinterpret_cast<const float4*>(Os + r * LY::LDO + c * 4);
    }
    if (lane < ROWS_PER_WARP) {
      const int r = r0 + lane, t = q0 + r;
      if (t < lc) {
        m_st[st0 + t] = m_s[r];
        l_st[st0 + t] = l_s[r];
      }
    }
  }
}

struct PushArgs {
  const void* src[MAX_COPIES];
  void* dst[MAX_COPIES];
  long long words[MAX_COPIES];  // 4-byte words of each range
};

// One range per blockIdx.y; 16-byte moves where both ends and the length
// allow, 4-byte ones otherwise (a seg half of an odd length).
__global__ void ring_push_kernel(PushArgs a) {
  const int c = blockIdx.y;
  const long long n = a.words[c];
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uintptr_t ends = reinterpret_cast<uintptr_t>(a.src[c]) |
                         reinterpret_cast<uintptr_t>(a.dst[c]);
  if (ends % 16 == 0 && n % 4 == 0) {
    const uint4* s = static_cast<const uint4*>(a.src[c]);
    uint4* d = static_cast<uint4*>(a.dst[c]);
    for (long long i = first; i < n / 4; i += step) d[i] = s[i];
  } else {
    const uint32_t* s = static_cast<const uint32_t*>(a.src[c]);
    uint32_t* d = static_cast<uint32_t*>(a.dst[c]);
    for (long long i = first; i < n; i += step) d[i] = s[i];
  }
}

// Launches on `device`, whatever device the caller's thread has current,
// and puts the caller's back.
struct DeviceGuard {
  int prev = -1, dev;
  explicit DeviceGuard(int d) : dev(d) {
    cudaGetDevice(&prev);
    if (prev != dev) cudaSetDevice(dev);
  }
  ~DeviceGuard() {
    if (prev >= 0 && prev != dev) cudaSetDevice(prev);
  }
};

template <int HD>
int launch_round(const void* q, const void* segq, const void* k0, const void* v0,
                 const void* sk0, const void* k1, const void* v1, const void* sk1,
                 void* m, void* l, void* acc, void* o, int B, int lc, int lch, int nq,
                 int nkv, int q_off, int k_off0, int k_off1, int n_dirs, int first,
                 int last, float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = Layout<HD>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(
      ring_round_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((lc + BQ - 1) / BQ, nq, B);
  ring_round_kernel<HD><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const int*>(segq),
      static_cast<const bf16*>(k0), static_cast<const bf16*>(v0),
      static_cast<const int*>(sk0), static_cast<const bf16*>(k1),
      static_cast<const bf16*>(v1), static_cast<const int*>(sk1),
      static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(acc),
      static_cast<bf16*>(o), lc, lch, nq, nkv, q_off, k_off0, k_off1, n_dirs, first,
      last, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry returns a cudaError_t code (0 = launched), allocates nothing
// and runs on `stream` (a stream of `device`) without synchronising.
extern "C" int ring_round_bf16(const void* q, const void* segq, const void* k0,
                               const void* v0, const void* sk0, const void* k1,
                               const void* v1, const void* sk1, void* m, void* l,
                               void* acc, void* o, int B, int lc, int lch, int nq,
                               int nkv, int hd, int q_off, int k_off0, int k_off1,
                               int n_dirs, int first, int last, float scale, int causal,
                               int window, int device, void* stream) {
  DeviceGuard guard(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch_round<128>(q, segq, k0, v0, sk0, k1, v1, sk1, m, l, acc, o, B, lc, lch,
                             nq, nkv, q_off, k_off0, k_off1, n_dirs, first, last, scale,
                             causal, window, st);
  if (hd == 64)
    return launch_round<64>(q, segq, k0, v0, sk0, k1, v1, sk1, m, l, acc, o, B, lc, lch,
                            nq, nkv, q_off, k_off0, k_off1, n_dirs, first, last, scale,
                            causal, window, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ring_push(const void* const* srcs, void* const* dsts,
                         const long long* bytes, int count, int device, void* stream) {
  if (count < 1 || count > MAX_COPIES) return (int)cudaErrorInvalidValue;
  PushArgs a = {};
  for (int i = 0; i < count; ++i) {
    if (bytes[i] % 4) return (int)cudaErrorInvalidValue;
    a.src[i] = srcs[i];
    a.dst[i] = dsts[i];
    a.words[i] = bytes[i] / 4;
  }
  DeviceGuard guard(device);
  ring_push_kernel<<<dim3(264, count), 256, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Lets kernels on `device` write to `peer`'s memory. Returns 0 when they
// can (already could), -1 when the two cards have no peer path, else the
// cudaError_t.
extern "C" int ring_enable_peer(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return -1;
  DeviceGuard guard(device);
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the sticky "already enabled"
    return 0;
  }
  return (int)err;
}
