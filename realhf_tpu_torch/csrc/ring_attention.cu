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
// semaphores. No kernel waits on another member's flag: members that
// share a card would spin on every SM and starve the push they wait for,
// so the state stays in HBM between a member's rounds.
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
// per-member buffer between rounds; round 0 (`first`) starts it and the
// last round (`last`) normalises into o (bf16), a row that saw no valid
// key as 0, never NaN. Given an `lse` buffer [B, nq, lc] fp32, the last
// round also writes each row's log-sum-exp in K1's convention (the max of
// the scaled scores plus the log of the row sum, NEG_INF for a row that
// saw no valid key), which the ring's backward hands K2 and K3 (one
// launch per non-skipped round, ops/ring_attention_fused.py
// `RingAttentionFn`). A launch without it (`lse` null) runs the same
// arithmetic and writes the same o as before the buffer existed.
//
// Layouts (row-major, contiguous): q/o [B, lc, nq, hd], segq [B, lc]
// int32; each direction's k/v [B, lch, nkv, hd] and seg [B, lch]; state
// m/l [B, nq, lc] and acc [B, nq, lc, hd] fp32.
//
// What bounds it on the H100: over a 32768-token stream of 5 documents
// on 4 members (the ctx-7b-c4 path, one LLaMA-7B layer, 32 heads, hd
// 128) the mask allows ~132 M (query, key) pairs per head, ~2.2e12
// FLOPs: 2.2 ms of tensor-core time on one card against ~0.3 ms for the
// q/k/v/o bytes, so operations bound it. At the ppo_ctx shards (6400
// tokens of 16 sequences, lc 1600, halves of 800) the pairs are few and
// the bytes of q/k/v/o bound it (~0.06 ms). What a kernel loses is the
// pairs it walks without need, the tensor cores it leaves idle, and the
// fp32 state it moves between rounds. The design (K1's, csrc/flash_fwd.cu,
// through the tile machinery both share in csrc/attn_tile.cuh):
//
// 1. Tile skipping on global offsets. A CTA owns 128 query rows (two
//    warpgroups of 64) of one head of one batch row and reduces each
//    warpgroup's non-zero q ids to a range and a residue set mod 64. Over
//    one tile index space, direction 0's 64-key tiles then direction 1's,
//    it marks a tile for a warpgroup when the ranges and the residue sets
//    meet, (causal) the tile's first global key is at or before the
//    warpgroup's last global row, and (window) the tile's last global key
//    is less than `window` behind the warpgroup's first global row.
//    Inside a visited tile the mask is the exact per-pair test.
//    ops/flash_attention.py `visited_key_tiles` (with seg_k, q_off, k_off
//    and window) states the rule in PyTorch. Tiles are walked in order,
//    direction 0 then 1, ascending within a half.
// 2. K1's tile step: S = Q K^T and O += P V as wgmma with S, P and O in
//    registers, the online softmax on the accumulators, a two-stage
//    `cp.async` ring of K/V/seg tiles in the 128-byte swizzle; keys past
//    lch are zero-filled by the copy, never read. Both kernels run the one
//    `tile_step`, so c4 (this kernel) and c1 (K1) round alike and differ
//    only in the order the tiles arrive.
// 3. State traffic only where a round has work. The state of a row with
//    no valid key yet is m = NEG_INF, l = 0 and acc unwritten. A
//    warpgroup that marked no tile this round, in a round neither first
//    nor last, leaves its rows' state untouched (a CTA where neither did
//    exits at once). Round 0 writes m and l for every row and acc only for
//    rows that saw a valid key; a later round loads acc only for rows
//    whose stored m is above NEG_INF / 2 and starts the others at 0, so
//    memory the first round did not write never enters the arithmetic.
// 4. Tiles and occupancy as K1: 256 threads, ~98 KB of shared memory at
//    hd 128, one CTA per SM by registers; hd 64 halves Q, K and V. hd 256
//    (Gemma at c > 1) is K1's hd 256 tile step (`wgmma_pv<256>`: two
//    m64n128 products over one set of P fragments): Q 64 KB + 2 x (K 32 +
//    V 32) KB = ~194 KB, one CTA an SM, O in 128 fp32 registers a thread.
//    The state rows load into and store from those same registers
//    (`load_row` / `store_row` walk O's layout), so the state path adds
//    addresses and no array; the fp32 acc state is [B, nq, lc, 256], twice
//    hd 128's bytes per round.
//
// ring_push: a grid-stride copy of up to six contiguous byte ranges (k, v
// and seg of each direction) from this member's current slot into its
// neighbours' other slot, written through the peer pointer when the
// neighbour is another card (peer access enabled by ring_enable_peer) and
// as a device-local copy when it shares this card.

#include "attn_tile.cuh"

namespace {

using namespace attn;

constexpr int MAX_COPIES = 6;

// A thread's row `OFF / 2` (0: qi, 1: qi + 8) of the state: loaded from
// m/l/acc when the stored m says the row has seen a valid key, else left
// as cleared.
template <int HD, int OFF>
__device__ __forceinline__ void load_row(const float* m_st, const float* l_st,
                                         const float* acc_st, size_t t, int tq,
                                         float& m, float& l, float (&acc)[HD / 2]) {
  const float mv = m_st[t];
  if (!(mv > NEG_INF / 2)) return;
  m = mv;
  l = l_st[t];
  const float* a = acc_st + t * HD + 2 * tq;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const float2 x = *reinterpret_cast<const float2*>(a + 8 * i);
    acc[4 * i + OFF] = x.x;
    acc[4 * i + OFF + 1] = x.y;
  }
}

// The inverse: m and l (from the quad's first thread), and acc only for a
// row that has seen a valid key.
template <int HD, int OFF>
__device__ __forceinline__ void store_row(float* m_st, float* l_st, float* acc_st, size_t t,
                                          int tq, float m, float l,
                                          const float (&acc)[HD / 2]) {
  const bool seen = l > 0.f;
  if (tq == 0) {
    m_st[t] = seen ? m : NEG_INF;
    l_st[t] = seen ? l : 0.f;
  }
  if (!seen) return;
  float* a = acc_st + t * HD + 2 * tq;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
    *reinterpret_cast<float2*>(a + 8 * i) = make_float2(acc[4 * i + OFF], acc[4 * i + OFF + 1]);
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
ring_round_kernel(const bf16* __restrict__ q, const int* __restrict__ segq,
                  const bf16* __restrict__ k0, const bf16* __restrict__ v0,
                  const int* __restrict__ sk0, const bf16* __restrict__ k1,
                  const bf16* __restrict__ v1, const int* __restrict__ sk1,
                  float* __restrict__ m_st, float* __restrict__ l_st,
                  float* __restrict__ acc_st, bf16* __restrict__ o,
                  float* __restrict__ lse, int lc, int lch,
                  int nq, int nkv, int q_off, int k_off0, int k_off1, int n_dirs,
                  int first, int last, float scale, int causal, int window) {
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
  const int wg = tid >> 7;            // this thread's warpgroup
  const int wq0 = q0 + wg * WG_ROWS;  // its first query row (local)

  const size_t q_row = (size_t)nq * HD;
  const size_t kv_row = (size_t)nkv * HD;
  const bf16* qb = q + (size_t)b * lc * q_row + (size_t)h * HD;
  const int* segqb = segq + (size_t)b * lc;
  const size_t half = (size_t)b * lch * kv_row + (size_t)kvh * HD;
  const bf16* kb0 = k0 + half;
  const bf16* vb0 = v0 + half;
  const bf16* kb1 = k1 + half;
  const bf16* vb1 = v1 + half;
  const int* sb0 = sk0 + (size_t)b * lch;
  const int* sb1 = sk1 + (size_t)b * lch;

  // --- 1. each warpgroup's range and residue set of non-zero q ids, and
  // its first and last global rows --------------------------------------
  int q_lo[NWG], q_hi[NWG], q_first[NWG], q_last[NWG];
  uint64_t q_bits[NWG];
  q_id_summary(segqb, q0, lc, tid, red, q_lo, q_hi, q_bits);
#pragma unroll
  for (int g = 0; g < NWG; ++g) {
    q_first[g] = q_off + q0 + g * WG_ROWS;
    q_last[g] = q_off + min(q0 + g * WG_ROWS + WG_ROWS, lc) - 1;
  }

  // --- 2. mark the key tiles each warpgroup needs: direction 0's half,
  // then direction 1's, in one index space --------------------------------
  const int nth = (lch + BK - 1) / BK;  // tiles of one half
  const int n_tiles = n_dirs * nth;
  const int nwords = (n_tiles + 31) >> 5;
  const bool vec0 = (lch & 3) == 0 && (reinterpret_cast<uintptr_t>(sb0) & 15) == 0;
  const bool vec1 = (lch & 3) == 0 && (reinterpret_cast<uintptr_t>(sb1) & 15) == 0;
  mark_tiles(n_tiles, nwords, tid, vis, [&](int j, bool (&mark)[NWG]) {
    const int d = j >= nth;
    const int kl = (j - d * nth) * BK;      // first key of the tile in its half
    const int n = min(BK, lch - kl);
    const int kg = (d ? k_off1 : k_off0) + kl;  // ... and in the stream
    bool reach[NWG], any = false;
#pragma unroll
    for (int g = 0; g < NWG; ++g) {
      reach[g] = tile_in_reach(kg, kg + n - 1, q_first[g], q_last[g], causal, window);
      any |= reach[g];
    }
    if (!any) return;
    int lo = INT_MAX, hi = INT_MIN;
    uint64_t bits = 0ull;
    key_tile_ids(d ? sb1 : sb0, kl, n, d ? vec1 : vec0, lo, hi, bits);
#pragma unroll
    for (int g = 0; g < NWG; ++g)
      mark[g] = reach[g] && lo <= q_hi[g] && hi >= q_lo[g] && (bits & q_bits[g]) != 0;
  });

  // A CTA with no tile this round, in a round neither first nor last,
  // leaves its rows' state as the last round stored it.
  const int j0 = next_tile(vis, nwords, -1);
  if (j0 < 0 && !first && !last) return;

  // --- 3. the walk, the state loaded while the first tile is in flight --
  const uint32_t sQ = sbase + SM::Q, sK = sbase + SM::K, sV = sbase + SM::V;
  const uint32_t sSeg = sbase + SM::SEG;
  auto load = [&](int j, int st) {
    const int d = j >= nth;
    load_kv_tile<HD>(sK, sV, sSeg, d ? kb1 : kb0, d ? vb1 : vb0, d ? sb1 : sb0, kv_row,
                     (j - d * nth) * BK, lch, st, tid);
  };
  if (j0 >= 0) {
    load_q_tile<HD>(sQ, qb, q_row, q0, lc, tid);
    load(j0, 0);
  }

  // This thread's two rows of its warpgroup's 64 (the accumulator layout):
  // local rows qi0 and qi0 + 8, columns 8 i + 2 tq + {0, 1}.
  const int tq = lane & 3;
  const int qi0 = wq0 + (warp & 3) * 16 + (lane >> 2);
  const int qi1 = qi0 + 8;
  const int sq0 = qi0 < lc ? segqb[qi0] : 0;
  const int sq1 = qi1 < lc ? segqb[qi1] : 0;
  const int qg0 = q_off + qi0, qg1 = q_off + qi1;
  const size_t s0 = ((size_t)b * nq + h) * lc;  // (b, h, row 0) in m/l
  // this warpgroup reads and writes the state only in a round where it
  // has work, and in the first and last
  const bool touch = first || last || any_marked(vis, nwords, wg);

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m0 = minus_inf(), m1 = minus_inf(), l0 = 0.f, l1 = 0.f;
  if (!first && touch) {
    if (qi0 < lc) load_row<HD, 0>(m_st, l_st, acc_st, s0 + qi0, tq, m0, l0, acc);
    if (qi1 < lc) load_row<HD, 2>(m_st, l_st, acc_st, s0 + qi1, tq, m1, l1, acc);
  }

  walk_tiles(vis, nwords, wg, j0, load, [&](int j, int st) {
    const int d = j >= nth;
    const int kg = (d ? k_off1 : k_off0) + (j - d * nth) * BK;
    // whether some pair of the tile may break causality or the window;
    // the per-pair tests run only then
    const bool diag = causal && kg + BK - 1 > q_off + wq0;
    const bool wide = window >= 0 && q_off + wq0 + WG_ROWS - 1 - kg >= window;
    tile_step<HD>(acc, m0, m1, l0, l1, sQ, wg, sK + st * SM::KV_BYTES, sV + st * SM::KV_BYTES,
                  seg_s + st * BK, tq, scale, [&](int r, int c, int id) {
                    const int sq = r ? sq1 : sq0;
                    const int dq = (r ? qg1 : qg0) - (kg + c);  // global distance
                    return keep_pair(sq, id, dq, diag, wide, window);
                  });
  });

  // --- 4. epilogue: the last round normalises into o (0 for a row that
  // saw no valid key); the others store the state for the next ----------
  if (last) {
    bf16* ob = o + (size_t)b * lc * q_row + (size_t)h * HD + 2 * tq;
    if (qi0 < lc) store_o_row<HD, 0>(ob + (size_t)qi0 * q_row, acc, l0);
    if (qi1 < lc) store_o_row<HD, 2>(ob + (size_t)qi1 * q_row, acc, l1);
    if (lse != nullptr && tq == 0) {
      if (qi0 < lc) lse[s0 + qi0] = l0 > 0.f ? m0 + logf(l0) : NEG_INF;
      if (qi1 < lc) lse[s0 + qi1] = l1 > 0.f ? m1 + logf(l1) : NEG_INF;
    }
  } else if (touch) {
    if (qi0 < lc) store_row<HD, 0>(m_st, l_st, acc_st, s0 + qi0, tq, m0, l0, acc);
    if (qi1 < lc) store_row<HD, 2>(m_st, l_st, acc_st, s0 + qi1, tq, m1, l1, acc);
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
                 void* m, void* l, void* acc, void* o, void* lse, int B, int lc, int lch,
                 int nq, int nkv, int q_off, int k_off0, int k_off1, int n_dirs, int first,
                 int last, float scale, int causal, int window, cudaStream_t stream) {
  if (B == 0 || lc == 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes<HD>(n_dirs * ((lch + BK - 1) / BK));
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
      static_cast<bf16*>(o), static_cast<float*>(lse), lc, lch, nq, nkv, q_off, k_off0,
      k_off1, n_dirs, first, last, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry returns a cudaError_t code (0 = launched), allocates nothing
// and runs on `stream` (a stream of `device`) without synchronising. `lse`
// may be null; given, the last round also writes the rows' lse
// [B, nq, lc].
extern "C" int ring_round_bf16(const void* q, const void* segq, const void* k0,
                               const void* v0, const void* sk0, const void* k1,
                               const void* v1, const void* sk1, void* m, void* l,
                               void* acc, void* o, void* lse, int B, int lc, int lch,
                               int nq, int nkv, int hd, int q_off, int k_off0, int k_off1,
                               int n_dirs, int first, int last, float scale, int causal,
                               int window, int device, void* stream) {
  DeviceGuard guard(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch_round<128>(q, segq, k0, v0, sk0, k1, v1, sk1, m, l, acc, o, lse, B, lc,
                             lch, nq, nkv, q_off, k_off0, k_off1, n_dirs, first, last, scale,
                             causal, window, st);
  if (hd == 64)
    return launch_round<64>(q, segq, k0, v0, sk0, k1, v1, sk1, m, l, acc, o, lse, B, lc,
                            lch, nq, nkv, q_off, k_off0, k_off1, n_dirs, first, last, scale,
                            causal, window, st);
  if (hd == 256)
    return launch_round<256>(q, segq, k0, v0, sk0, k1, v1, sk1, m, l, acc, o, lse, B, lc,
                             lch, nq, nkv, q_off, k_off0, k_off1, n_dirs, first, last, scale,
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
