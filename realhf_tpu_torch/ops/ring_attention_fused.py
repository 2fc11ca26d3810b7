"""Ring attention with the hand-written Hopper kernel K6.

``ring_attention_fused`` takes one shard per context-parallel member, q
``[B, lc, nq, hd]``, k/v ``[B, lc, nkv, hd]`` and seg ``[B, lc]``, member
``i`` holding tokens ``[i * lc, (i + 1) * lc)`` of every stream, and
returns each member's attention output over the whole stream. Members
are whatever devices their tensors lie on: distinct cards, one card
listed several times, or the CPU.

Members on the CPU run the plain ring (``ops/ring_attention.py``). CUDA
members run K6 (``csrc/ring_attention.cu``) or the wrapper raises; it
never falls back. The JAX package's ring (``ring_attention_fused.py``)
is one Pallas kernel per chip whose grid walks the rounds; here one
process drives the members, so the ring is a sequence of launches: per
round, each member's ``ring_push`` sends the KV halves it holds on to its
neighbours' other slot (direction 0 to the right, direction 1 to the
left, on the member's comm stream, issued before the round's compute)
and its ``ring_round`` accumulates its q shard against them (on its
compute stream). CUDA events order the members: a round's compute waits
for the pushes into its slot, and a push into a neighbour's slot waits
for the neighbour's compute and push of the round before, which read
that slot. The host never synchronises per round. The same schedule runs
across cards (the push writes through the peer pointer) and among members
that share a card (a device-local copy).

Like the JAX kernel it is a forward: its output carries no gradient, and
CUDA inputs that ask for one are refused (the differentiable ring on
CUDA is a later slice). ``ring_round_plain`` is the round kernel's
function in plain PyTorch; ``_run_ring`` takes it for CPU members, which
the tests use to hold the schedule itself against the JAX kernel.
"""

import contextlib
import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from realhf_tpu_torch.ops import _build
from realhf_tpu_torch.ops.ring_attention import (
    NEG_INF,
    _combine,
    _fit_block,
    _partial_attention,
    finalize,
    ring_attention_plain,
)

#: the least tile a shard (or a half of one) must have, as in the JAX kernel
MIN_TILE = 8
#: kernel launches of the round kernel (one per member per round) and of
#: the push kernel (one per member per round but the last); reset them to
#: 0 to count the launches of one run
round_launches = 0
push_launches = 0
_fns = {}
#: (device index, member, 0 compute / 1 comm) -> stream, made once
_streams: Dict[Tuple[int, int, int], "torch.cuda.Stream"] = {}
#: (device, peer) pairs whose peer access is on
_peers = set()


def _plan_dirs(lc: int, block_k: int, want_bidir: bool):
    """(n_dirs, lch, bk): split the local shard across both ring
    directions when each half still tiles; else one direction."""
    if want_bidir and lc % 2 == 0 and lc // 2 >= MIN_TILE:
        try:
            return 2, lc // 2, _fit_block(lc // 2, block_k, MIN_TILE)
        except ValueError:
            pass  # the half has no tileable block; the full shard may
    return 1, lc, _fit_block(lc, block_k, MIN_TILE)


def round_key_offsets(member: int, rnd: int, n: int, lc: int, lch: int,
                      n_dirs: int) -> List[int]:
    """Global stream offsets of the KV halves ``member`` holds in round
    ``rnd``, one per direction: direction 0 the first ``lch`` tokens of
    shard (member - rnd) % n, direction 1 the half from ``lch`` of shard
    (member + rnd) % n (a unidirectional ring: whole shards, lch = lc)."""
    return [((member - rnd) % n) * lc,
            ((member + rnd) % n) * lc + lch][:n_dirs]


# ----------------------------------------------------------------------
# The round and the push: plain versions and launches
# ----------------------------------------------------------------------
def ring_round_plain(q, seg_q, kv, m, l_sum, acc, o, *, q_off: int,
                     k_offs: Sequence[int], scale: float, causal: bool,
                     sliding_window: Optional[int], first: bool,
                     last: bool):
    """The round kernel's function in plain PyTorch: q [B, lc, nq, hd]
    against each direction's (k, v, seg_k) half at global offsets
    ``q_off`` and ``k_offs[d]``, merged into the fp32 state m/l
    [B, nq, lc], acc [B, nq, lc, hd] (started fresh when ``first``);
    the state is updated in place, or, when ``last``, normalised into o
    [B, lc, nq, hd] (a row with no valid key 0)."""
    b, lc, nq, hd = q.shape
    if first:
        state = (torch.full((b, nq, lc), NEG_INF, device=q.device),
                 torch.zeros((b, nq, lc), device=q.device),
                 torch.zeros((b, nq, lc, hd), device=q.device))
    else:
        state = (m, l_sum, acc)
    for (k, v, seg_k), k_off in zip(kv, k_offs):
        state = _combine(state, _partial_attention(
            q, k, v, seg_q, seg_k, q_off, k_off, scale, causal,
            sliding_window))
    if last:
        o.copy_(finalize(*state, o.dtype))
    else:
        for dst, src in zip((m, l_sum, acc), state):
            dst.copy_(src)


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library("ring_attention"), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {
            # 12 pointers; B, lc, lch, nq, nkv, hd, q_off, k_off0,
            # k_off1, n_dirs, first, last; scale; causal, window,
            # device; stream
            "ring_round_bf16": [p] * 12 + [i] * 12 + [ctypes.c_float]
                               + [i] * 3 + [p],
            "ring_push": [p, p, p, i, i, p],
            "ring_enable_peer": [i, i],
        }[name]
        fn.restype = i
        _fns[name] = fn
    return fn


def _launch_round(q, seg_q, kv, m, l_sum, acc, o, *, q_off: int,
                  k_offs: Sequence[int], scale: float, causal: bool,
                  sliding_window: Optional[int], first: bool, last: bool):
    """One round of one member: the kernel on the current stream of q's
    card, the plain version for CPU tensors."""
    if not q.is_cuda:
        ring_round_plain(q, seg_q, kv, m, l_sum, acc, o, q_off=q_off,
                         k_offs=k_offs, scale=scale, causal=causal,
                         sliding_window=sliding_window, first=first,
                         last=last)
        return
    (k0, v0, s0), (k1, v1, s1) = kv[0], kv[-1]
    b, lc, nq, hd = q.shape
    lch, nkv = k0.shape[1], k0.shape[2]
    dev = q.device
    code = _kernel("ring_round_bf16")(
        *(t.data_ptr() for t in (q, seg_q, k0, v0, s0, k1, v1, s1, m, l_sum,
                                 acc, o)),
        b, lc, lch, nq, nkv, hd, q_off, k_offs[0], k_offs[-1], len(kv),
        int(first), int(last), scale, int(causal),
        -1 if sliding_window is None else int(sliding_window), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "ring_round_bf16")
    global round_launches
    round_launches += 1


def _launch_push(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
    """Copy each contiguous src into its dst of the same shape: one
    kernel on the current stream of the sources' card (a dst may lie on
    another card), plain copies for CPU tensors."""
    src0 = pairs[0][0]
    if not src0.is_cuda:
        for src, dst in pairs:
            dst.copy_(src)
        return
    n = len(pairs)
    srcs = (ctypes.c_void_p * n)(*(s.data_ptr() for s, _ in pairs))
    dsts = (ctypes.c_void_p * n)(*(d.data_ptr() for _, d in pairs))
    nbytes = (ctypes.c_longlong * n)(*(s.numel() * s.element_size()
                                       for s, _ in pairs))
    dev = src0.device
    code = _kernel("ring_push")(srcs, dsts, nbytes, n, dev.index,
                                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "ring_push")
    global push_launches
    push_launches += 1


def _enable_peer(dev: torch.device, peer: torch.device):
    """Let kernels on ``dev`` write to ``peer``'s memory; raises when the
    two cards have no peer path."""
    key = (dev.index, peer.index)
    if key in _peers:
        return
    code = _kernel("ring_enable_peer")(dev.index, peer.index)
    if code == -1:
        raise RuntimeError(
            f"{dev} cannot access {peer} (cudaDeviceCanAccessPeer is "
            "false): ring neighbours on distinct cards need a peer path.")
    _build.check(code, "ring_enable_peer")
    _peers.add(key)


def _member_stream(dev: torch.device, member: int, kind: int):
    key = (dev.index, member, kind)
    s = _streams.get(key)
    if s is None:
        s = _streams[key] = torch.cuda.Stream(dev)
    return s


class _Schedule:
    """The streams and events of one ring call over CUDA members: a
    compute and a comm stream per member, both first waiting for every
    member card's current stream; each step records an event under its
    key, and ``finish`` makes every member card's current stream wait for
    the given keys."""

    def __init__(self, devs: Sequence[torch.device]):
        self.devs = list(devs)
        self.streams = [(_member_stream(d, j, 0), _member_stream(d, j, 1))
                        for j, d in enumerate(self.devs)]
        self.events = {}
        starts = []
        for d in dict.fromkeys(self.devs):
            e = torch.cuda.Event()
            e.record(torch.cuda.current_stream(d))
            starts.append(e)
        for pair in self.streams:
            for s in pair:
                for e in starts:
                    s.wait_event(e)

    @contextlib.contextmanager
    def step(self, member: int, comm: bool, waits, key):
        s = self.streams[member][int(comm)]
        for w in waits:
            s.wait_event(self.events[w])
        with torch.cuda.device(self.devs[member]), torch.cuda.stream(s):
            yield
            e = torch.cuda.Event()
            e.record(s)
        self.events[key] = e

    def finish(self, keys):
        for d in dict.fromkeys(self.devs):
            cur = torch.cuda.current_stream(d)
            for key in keys:
                cur.wait_event(self.events[key])


def _run_ring(qs, ks, vs, segs, *, n_dirs: int, lch: int, scale: float,
              causal: bool, sliding_window: Optional[int]
              ) -> List[torch.Tensor]:
    """The ring's schedule over the members (CUDA streams and events for
    CUDA members; in order on the CPU, where each step runs at once).

    Each member has two slots per direction for the KV halves it holds
    (k/v ``[2, n_dirs, B, lch, nkv, hd]``, seg ``[2, n_dirs, B, lch]``) and
    its fp32 state. Slot 0 starts with its own halves. In round r it
    holds slot r % 2 and, before computing, pushes it into the other slot
    of its neighbours: direction 0 goes right (shard (my - r) % n arrives
    in direction 0), direction 1 left (shard (my + r) % n in direction 1).
    Event keys: ("c", j, r) member j's compute of round r (r = -1: its
    slot 0 filled), ("p", j, r) its push of round r."""
    n = len(qs)
    b, lc, nq, hd = qs[0].shape
    nkv = ks[0].shape[2]
    devs = [q.device for q in qs]
    sched = _Schedule(devs) if devs[0].type == "cuda" else None
    if sched is not None:
        for j, d in enumerate(devs):
            for nb in {(j - 1) % n, (j + 1) % n}:
                if devs[nb] != d:
                    _enable_peer(d, devs[nb])

    def step(member, comm, waits, key):
        if sched is None:
            return contextlib.nullcontext()
        return sched.step(member, comm, waits, key)

    kslot = [torch.empty((2, n_dirs, b, lch, nkv, hd), dtype=k.dtype,
                         device=k.device) for k in ks]
    vslot = [torch.empty_like(t) for t in kslot]
    sslot = [torch.empty((2, n_dirs, b, lch), dtype=torch.int32,
                         device=s.device) for s in segs]
    ms = [torch.empty((b, nq, lc), dtype=torch.float32, device=d)
          for d in devs]
    ls = [torch.empty_like(t) for t in ms]
    accs = [torch.empty((b, nq, lc, hd), dtype=torch.float32, device=d)
            for d in devs]
    outs = [torch.empty_like(q) for q in qs]

    for j in range(n):
        with step(j, False, (), ("c", j, -1)):
            kslot[j][0].copy_(ks[j].reshape(b, n_dirs, lch, nkv, hd)
                              .transpose(0, 1))
            vslot[j][0].copy_(vs[j].reshape(b, n_dirs, lch, nkv, hd)
                              .transpose(0, 1))
            sslot[j][0].copy_(segs[j].reshape(b, n_dirs, lch)
                              .transpose(0, 1))

    for r in range(n):
        cur, nxt = r % 2, 1 - r % 2
        for j in range(n):
            left, right = (j - 1) % n, (j + 1) % n
            # what arrived in slot `cur` last round (both directions)
            arrived = [] if r == 0 else [("p", left, r - 1),
                                         ("p", right, r - 1)]
            if r < n - 1:
                # round 0 sends what the compute stream put in slot 0;
                # later, the neighbours' slot `nxt` was read by their
                # compute and push of round r - 1
                freed = ([("c", j, -1)] if r == 0 else
                         [("c", left, r - 1), ("c", right, r - 1)])
                with step(j, True, arrived + freed, ("p", j, r)):
                    pairs = []
                    for d, nb in enumerate((right, left)[:n_dirs]):
                        for slot in (kslot, vslot, sslot):
                            pairs.append((slot[j][cur, d], slot[nb][nxt, d]))
                    _launch_push(pairs)
            with step(j, False, arrived, ("c", j, r)):
                kv = [(kslot[j][cur, d], vslot[j][cur, d], sslot[j][cur, d])
                      for d in range(n_dirs)]
                _launch_round(qs[j], segs[j], kv, ms[j], ls[j], accs[j],
                              outs[j], q_off=j * lc,
                              k_offs=round_key_offsets(j, r, n, lc, lch,
                                                       n_dirs),
                              scale=scale, causal=causal,
                              sliding_window=sliding_window, first=r == 0,
                              last=r == n - 1)
    if sched is not None:
        sched.finish([("c", j, n - 1) for j in range(n)]
                     + [("p", j, n - 2) for j in range(n) if n > 1])
    return outs


# ----------------------------------------------------------------------
# Entry
# ----------------------------------------------------------------------
def _check_members(qs, ks, vs, segs):
    n = len(qs)
    if not n or not (len(ks) == len(vs) == len(segs) == n):
        raise ValueError("ring_attention_fused needs one q, k, v and seg "
                         "shard per member")
    b, lc, nq, hd = qs[0].shape
    nkv = ks[0].shape[2]
    if nq % nkv:
        raise ValueError(f"nq={nq} is not a multiple of nkv={nkv}")
    for j, (q, k, v, s) in enumerate(zip(qs, ks, vs, segs)):
        if (tuple(q.shape) != (b, lc, nq, hd)
                or tuple(k.shape) != (b, lc, nkv, hd)
                or tuple(v.shape) != (b, lc, nkv, hd)
                or tuple(s.shape) != (b, lc)):
            raise ValueError(
                f"member {j}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                f"v {tuple(v.shape)}, seg {tuple(s.shape)} differ from "
                f"member 0's {(b, lc, nq, hd)}, {(b, lc, nkv, hd)}, {(b, lc)}")
        if len({t.device for t in (q, k, v, s)}) != 1:
            raise ValueError(f"member {j}: q, k, v and seg lie on "
                             "different devices")
    if len({q.is_cuda for q in qs}) != 1:
        raise ValueError("ring members lie on the CPU and on CUDA at once")


def _check_cuda_members(qs, ks, vs, segs):
    if torch.is_grad_enabled() and any(
            t.requires_grad for group in (qs, ks, vs) for t in group):
        raise RuntimeError(
            "ring_attention_fused's kernel output carries no gradient: the "
            "differentiable ring on CUDA is a later slice of the port; "
            "run inference forwards under torch.no_grad / inference_mode.")
    hd = qs[0].shape[-1]
    if hd not in (64, 128):
        raise ValueError(f"ring attention kernel supports hd 64 or 128, "
                         f"got {hd}")
    for j, member in enumerate(zip(qs, ks, vs, segs)):
        for name, t in zip(("q", "k", "v", "seg"), member):
            if not t.is_contiguous():
                raise ValueError(f"member {j}: {name} must be contiguous")
            if t.data_ptr() % 16:
                raise ValueError(f"member {j}: {name} must be 16-byte "
                                 "aligned")
            want = torch.int32 if name == "seg" else torch.bfloat16
            if t.dtype != want:
                raise TypeError(f"member {j}: ring attention kernel takes "
                                f"{want} {name}, got {t.dtype}")


def ring_attention_fused(qs: Sequence[torch.Tensor],
                         ks: Sequence[torch.Tensor],
                         vs: Sequence[torch.Tensor],
                         segs: Sequence[torch.Tensor], *,
                         causal: bool = True, scale: Optional[float] = None,
                         sliding_window: Optional[int] = None,
                         block_q: int = 256, block_k: int = 512,
                         bidirectional: bool = True) -> List[torch.Tensor]:
    """Attention over the stream the members' shards make up -> one
    output shard ``[B, lc, nq, hd]`` per member, on its device.

    CPU members run ``ring_attention_plain``; CUDA members (bf16 q/k/v,
    int32 seg, hd 64 or 128, contiguous) launch K6 or raise. ``block_q``
    and ``block_k`` are tile hints, as in the JAX package: the shard must
    have a tile of 8 or more dividing it (``_fit_block``). The plain
    ring tiles by them; on CUDA they only validate the shard, the
    kernel's own tiles being 64 rows with a masked ragged edge. ``bidirectional``
    splits each shard into two halves that counter-rotate, falling back
    to one direction when a half would not tile. One member is the JAX
    package's ``n == 1`` case: attention over its own shard (a single
    round on CUDA)."""
    _check_members(qs, ks, vs, segs)
    n = len(qs)
    scale = float(scale) if scale is not None else qs[0].shape[-1] ** -0.5
    on_cuda = qs[0].is_cuda
    if on_cuda:
        _check_cuda_members(qs, ks, vs, segs)
    kw = dict(causal=causal, scale=scale, sliding_window=sliding_window)
    lc = qs[0].shape[1]
    if n == 1:
        if not on_cuda:
            return ring_attention_plain(qs, ks, vs, segs, **kw)
        return _run_ring(qs, ks, vs, segs, n_dirs=1, lch=lc, **kw)
    bq = _fit_block(lc, block_q, MIN_TILE)
    n_dirs, lch, bk = _plan_dirs(lc, block_k, bidirectional)
    if not on_cuda:
        return ring_attention_plain(qs, ks, vs, segs, block_q=bq,
                                    block_k=bk, **kw)
    return _run_ring(qs, ks, vs, segs, n_dirs=n_dirs, lch=lch, **kw)
