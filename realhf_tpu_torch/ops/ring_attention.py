"""Ring attention in plain PyTorch: context parallelism over members.

The counterpart of the JAX package's ``ops/ring_attention.py``. Each
member holds a contiguous shard of ``lc = L / n`` tokens of every
stream: q ``[B, lc, nq, hd]``, k/v ``[B, lc, nkv, hd]``, seg ``[B, lc]``
(0 = padding), member ``i`` holding tokens ``[i * lc, (i + 1) * lc)``.
Over n rounds member ``idx`` meets the KV shard of member
``src = (idx - r) % n`` and merges the partial result into its
online-softmax state; the segment, causal and sliding-window masks are
taken on GLOBAL positions (``q_off = idx * lc``, ``k_off = src * lc``),
so the result is attention over the whole stream.

JAX rotates the shards with ``ppermute`` inside ``shard_map``; here one
process drives the members, so round ``r`` of member ``idx`` reads
member ``src``'s shard directly (moved to ``idx``'s device when the two
differ). Every function is differentiable by autograd.

``ring_attention_plain`` is the path for members that lie on the CPU,
and the yardstick of the ring kernel (K6, ``ops/ring_attention_fused.py``)
on the card. With ``return_lse`` it also gives each member's log-sum-exp
``[B, nq, lc]`` in the flash kernels' convention (K1's: the max of the
scaled scores plus the log of the row sum, NEG_INF for a row with no
valid key).

``ring_attention_bwd`` is the ring's backward schedule
(``ops/ring_attention_fused.RingAttentionFn`` runs it on CUDA and CPU
members alike): from each member's final o and lse and delta =
rowsum(do * o), one round per (member i, key shard src = (i - r) mod n)
at global offsets, in a fixed order (``ring_bwd_rounds``: rounds in
order, members in order within a round, rounds out of reach by position
skipped); round (i, src) gives a partial of dq_i and partials of
dk_src / dv_src, all summed in fp32 and rounded once. The round itself
is the caller's: K2/K3, whose wrappers take their plain arithmetic on
CPU tensors.
"""

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from realhf_tpu_torch.ops.flash_attention import attention_delta

NEG_INF = -2.0 ** 30


def _fit_block(lc: int, block: int, min_tile: int = 1) -> int:
    """Largest divisor of lc that is <= block; refuses a shard whose
    largest such divisor is below ``min_tile``."""
    b = min(block, lc)
    while lc % b:
        b -= 1
    if b < min_tile:
        raise ValueError(
            f"local context shard of {lc} tokens has no >={min_tile} tile "
            f"divisor <= {block}; pad the sequence or adjust the "
            "ctx degree for ring_attention_fused.")
    return b


def _partial_attention(q, k, v, seg_q, seg_k, q_off: int, k_off: int,
                       scale: float, causal: bool,
                       sliding_window: Optional[int] = None):
    """q [B, Lq, nq, hd] against k/v [B, Lk, nkv, hd] at global offsets
    -> (m [B, nq, Lq], l, acc [B, nq, Lq, hd]), fp32 and unnormalised.
    A row with no valid key has m = NEG_INF (its l and acc are
    discarded by whoever finalises)."""
    b, lq, nq, hd = q.shape
    lk, nkv = k.shape[1], k.shape[2]
    group = nq // nkv
    qg = (q * scale).reshape(b, lq, nkv, group, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                     k.to(torch.float32)).reshape(b, nq, lq, lk)
    mask = (seg_q[:, :, None] == seg_k[:, None, :]) & (seg_q[:, :, None] != 0)
    qi = q_off + torch.arange(lq, device=q.device)
    ki = k_off + torch.arange(lk, device=q.device)
    if causal:
        mask = mask & (qi[:, None] >= ki[None, :])[None]
    if sliding_window is not None:
        mask = mask & ((qi[:, None] - ki[None, :]) < sliding_window)[None]
    s = torch.where(mask[:, None], s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l_sum = p.sum(-1)
    pv = p.reshape(b, nkv, group, lq, lk)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", pv, v.to(torch.float32))
    return m, l_sum, acc.reshape(b, nq, lq, hd)


def _combine(state, new):
    """Merge two online-softmax partials (m, l, acc)."""
    m0, l0, a0 = state
    m1, l1, a1 = new
    m = torch.maximum(m0, m1)
    w0 = torch.exp(m0 - m)
    w1 = torch.exp(m1 - m)
    return m, l0 * w0 + l1 * w1, a0 * w0[..., None] + a1 * w1[..., None]


def _partial_attention_blockwise(q, k, v, seg_q, seg_k, q_off: int,
                                 k_off: int, scale: float, causal: bool,
                                 sliding_window: Optional[int], bq: int,
                                 bk: int):
    """``_partial_attention`` over [bq, bk] tiles: the scores exist only
    one tile at a time. bq and bk divide Lq and Lk."""
    b, lq, nq, hd = q.shape
    lk = k.shape[1]
    ms, ls, accs = [], [], []
    for i in range(0, lq, bq):
        state = (torch.full((b, nq, bq), NEG_INF, device=q.device),
                 torch.zeros((b, nq, bq), device=q.device),
                 torch.zeros((b, nq, bq, hd), device=q.device))
        for j in range(0, lk, bk):
            part = _partial_attention(
                q[:, i:i + bq], k[:, j:j + bk], v[:, j:j + bk],
                seg_q[:, i:i + bq], seg_k[:, j:j + bk], q_off + i, k_off + j,
                scale, causal, sliding_window)
            state = _combine(state, part)
        ms.append(state[0])
        ls.append(state[1])
        accs.append(state[2])
    return torch.cat(ms, -1), torch.cat(ls, -1), torch.cat(accs, -2)


def finalize(m, l_sum, acc, dtype) -> torch.Tensor:
    """Normalise an online-softmax state [B, nq, Lq(, hd)] -> o
    [B, Lq, nq, hd] in ``dtype``; a row with no valid key is 0."""
    safe = torch.where(l_sum > 0, l_sum, torch.ones_like(l_sum))
    out = torch.where((m > NEG_INF / 2)[..., None], acc / safe[..., None],
                      0.0)
    return out.transpose(1, 2).to(dtype)


def state_lse(m: torch.Tensor, l_sum: torch.Tensor) -> torch.Tensor:
    """The log-sum-exp of a finished online-softmax state [B, nq, Lq]:
    m + log(l), NEG_INF for a row with no valid key."""
    safe = torch.where(l_sum > 0, l_sum, torch.ones_like(l_sum))
    return torch.where(m > NEG_INF / 2, m + torch.log(safe), NEG_INF)


def ring_attention_plain(qs: Sequence[torch.Tensor],
                         ks: Sequence[torch.Tensor],
                         vs: Sequence[torch.Tensor],
                         segs: Sequence[torch.Tensor], *,
                         causal: bool = True, scale: Optional[float] = None,
                         sliding_window: Optional[int] = None,
                         block_q: int = 512, block_k: int = 512,
                         return_lse: bool = False):
    """Attention over the stream the members' shards make up: one
    output shard ``[B, lc, nq, hd]`` per member, on the member's device
    and in its q's dtype (with ``return_lse``: and each member's lse
    ``[B, nq, lc]`` fp32). Shards of ``lc`` tokens are taken in tiles of
    the largest divisors of ``lc`` not above ``block_q`` / ``block_k``."""
    n = len(qs)
    lc = qs[0].shape[1]
    scale = float(scale) if scale is not None else qs[0].shape[-1] ** -0.5
    bq, bk = _fit_block(lc, block_q), _fit_block(lc, block_k)
    outs, lses = [], []
    for idx, (q, seg) in enumerate(zip(qs, segs)):
        b, _, nq, hd = q.shape
        dev = q.device
        state = (torch.full((b, nq, lc), NEG_INF, device=dev),
                 torch.zeros((b, nq, lc), device=dev),
                 torch.zeros((b, nq, lc, hd), device=dev))
        for r in range(n):
            src = (idx - r) % n
            k, v, seg_k = (t.to(dev) for t in (ks[src], vs[src], segs[src]))
            part = _partial_attention_blockwise(
                q, k, v, seg, seg_k, idx * lc, src * lc, scale, causal,
                sliding_window, bq, bk)
            state = _combine(state, part)
        outs.append(finalize(*state, q.dtype))
        lses.append(state_lse(state[0], state[1]))
    return (outs, lses) if return_lse else outs


# ----------------------------------------------------------------------
# The backward
# ----------------------------------------------------------------------
def round_out_of_reach(i: int, src: int, lc: int, causal: bool,
                       sliding_window: Optional[int]) -> bool:
    """Whether member ``i``'s queries can see no key of shard ``src`` by
    position alone: causal and every key after every query, or a window
    and every key at least ``sliding_window`` behind every query."""
    if causal and src * lc > i * lc + lc - 1:
        return True
    return (sliding_window is not None
            and i * lc - (src * lc + lc - 1) >= sliding_window)


def ring_bwd_rounds(n: int, lc: int, causal: bool,
                    sliding_window: Optional[int]
                    ) -> List[Tuple[int, int, int]]:
    """(round r, member i, key shard src) of every round the backward
    runs, in its order: rounds in order, members in order within a
    round, ``round_out_of_reach`` pairs left out. Causal without a
    window that is n (n + 1) / 2 rounds of n * n."""
    return [(r, i, (i - r) % n) for r in range(n) for i in range(n)
            if not round_out_of_reach(i, (i - r) % n, lc, causal,
                                      sliding_window)]


#: round_fn(q_i, k_src, v_src, seg_i, seg_src, do_i, lse_i, delta_i,
#: q_off, k_off) -> fp32 partials (dq_i, dk_src, dv_src) on q_i's device
RoundFn = Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def ring_attention_bwd(qs, ks, vs, segs, outs, lses, dos, *, causal: bool,
                       sliding_window: Optional[int], round_fn: RoundFn):
    """The ring's backward schedule -> (dqs, dks, dvs), each member's on
    its device in its input's dtype. Per member delta_i = rowsum(do_i *
    o_i); then ``round_fn`` per ``ring_bwd_rounds`` entry, its dq
    partial added into member i's fp32 sum and its dk / dv partials moved
    to shard src's device and added into that shard's, in the order of
    the rounds; each sum is rounded once at the end."""
    n = len(qs)
    lc = qs[0].shape[1]
    deltas = [attention_delta(o, do) for o, do in zip(outs, dos)]
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
          for q in qs]
    dk = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
          for k in ks]
    dv = [torch.zeros(v.shape, dtype=torch.float32, device=v.device)
          for v in vs]
    for _, i, src in ring_bwd_rounds(n, lc, causal, sliding_window):
        dev = qs[i].device
        pq, pk, pv = round_fn(
            qs[i], ks[src].to(dev), vs[src].to(dev), segs[i],
            segs[src].to(dev), dos[i], lses[i], deltas[i], i * lc,
            src * lc)
        dq[i] += pq
        dk[src] += pk.to(dk[src].device)
        dv[src] += pv.to(dv[src].device)
    return ([g.to(q.dtype) for g, q in zip(dq, qs)],
            [g.to(k.dtype) for g, k in zip(dk, ks)],
            [g.to(v.dtype) for g, v in zip(dv, vs)])

