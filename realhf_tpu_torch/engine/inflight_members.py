"""The serving engine's device pieces over the members of a ``dNtM``
layout (``models/sharding.MemberParams``), for
``engine/inflight.InflightBatchingGenerator``.

Slot ``s`` belongs to the data group whose rows ``transformer.data_rows(
n_slots, d)`` give it, the split ``decode_step`` at members uses for a
batch of ``n_slots`` rows, so a decode step over every slot is
``transformer.decode_step`` on the member caches: each member runs K4
over its own KV heads (or, where t does not divide the KV heads, the
"seq" route: every head over its slice of the slots). Everything else
works on one group's members:

- a fill runs the prompt on the owning group's t members alone
  (``transformer.prefill(..., group=g)``) and writes their caches;
- ``extend_rows`` is ``inflight._extend_rows`` over a group's members:
  q/k/v of each member's own heads, plain attention over its cache (on
  the "seq" route over its slice, the slices' partials merged by
  ``ops/decode_attention.seqsplit_merge``), the row-parallel ``wo`` and
  MLP sums through ``transformer._add_reduced`` / ``_mlp_members`` and
  MoE through the call's ``MoEShards``;
- the paged pool (``engine/kv_pool.KVPool`` built with the layout's
  devices) keeps an arena per member over its KV heads (every head on
  the "seq" route, where each member gathers its slice of a window and
  written rows go to every member's arena); one allocator serves all
  groups and a block aliased into another group's slot is copied into
  that group's arenas first (``copy_blocks``).

The per-slot bookkeeping (``emitted``, ``out_tokens``, ``active``, ...)
and the paged write indices live on the first member's device, where
``transformer.lm_logits`` gathers the logits of every slot.
"""

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from realhf_tpu_torch.base.safetensors_io import tensor_to_numpy
from realhf_tpu_torch.engine import kv_pool as _kvp
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.sharding import MemberParams
from realhf_tpu_torch.ops import decode_attention as _decode
from realhf_tpu_torch.ops.attention import kv_replicated
from realhf_tpu_torch.ops.sampling import NEG_INF
from realhf_tpu_torch.parallel import collectives as C


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a generator's slots and cache slots live: data group g holds
    slots ``rows[g]``; member ``g * t + j`` of ``devices`` holds
    ``heads`` KV heads over ``s_loc`` cache slots starting at slot
    ``offset(j)``."""
    d: int
    t: int
    devices: Tuple[torch.device, ...]
    rows: Tuple[Tuple[int, int], ...]
    seq: bool
    slots: int          # cache slots of a slot row (every member's total)
    heads: int          # KV heads a member holds
    ep: bool = False    # the expert leaves split over the data index

    @property
    def s_loc(self) -> int:
        return self.slots // self.t if self.seq else self.slots

    def offset(self, i: int) -> int:
        return (i % self.t) * self.s_loc if self.seq else 0

    def group_of(self, slot: int) -> Tuple[int, int]:
        """(data group, row within the group's caches) of ``slot``."""
        for g, (r0, r1) in enumerate(self.rows):
            if r0 <= slot < r1:
                return g, slot - r0
        raise IndexError(f"slot {slot} out of range")

    def members(self, g: int) -> range:
        return range(g * self.t, (g + 1) * self.t)


def seq_slots(n: int, t: int) -> int:
    """The "seq" route's cache length for ``n`` slots: the fixed point of
    the rounding ``transformer.prefill`` applies to a ``total_len``."""
    while True:
        m = _decode.seq_cache_len(T.round_cache_len(n), t)
        if m == n:
            return n
        n = m


def check_layout(mp: MemberParams):
    if mp.p > 1 or mp.c > 1:
        raise ValueError(
            f"the serving engine over a p{mp.p} c{mp.c} layout: generation "
            "runs on the engine's decode view (Engine.decode_engine), as "
            "batch generation does.")


def layout_of(cfg, mp: MemberParams, n_slots: int, cache_len: int) -> Layout:
    check_layout(mp)
    T.check_layout(cfg, mp.t)
    seq = kv_replicated(cfg.n_kv_heads, mp.t)
    slots = seq_slots(cache_len, mp.t) if seq else cache_len
    if seq:
        _decode.choose_decode_route(cfg.n_kv_heads, slots, mp.t)
    return Layout(mp.d, mp.t, tuple(mp.devices),
                  tuple(T.data_rows(n_slots, mp.d)), seq, slots,
                  cfg.n_kv_heads if seq else cfg.n_kv_heads // mp.t, mp.ep)


def member_view(mp: MemberParams) -> MemberParams:
    """The weights a generator runs on: sequence parallelism splits a
    training step's residual stream and changes no value, so decoding
    runs without it."""
    return dataclasses.replace(mp, sp=False) if mp.sp else mp


def fits(mp: MemberParams, lay: Layout) -> bool:
    """Whether ``mp`` holds weights laid out as ``lay`` wants them."""
    return ((mp.d, mp.t, mp.p, mp.c, mp.ep) == (lay.d, lay.t, 1, 1, lay.ep)
            and tuple(mp.devices) == lay.devices)


# ----------------------------------------------------------------------
# state
# ----------------------------------------------------------------------
def init_caches(cfg, lay: Layout, dtype) -> List[Optional[dict]]:
    """Zero member caches (None for the members of a group without
    slots)."""
    out = []
    for i, dev in enumerate(lay.devices):
        r0, r1 = lay.rows[i // lay.t]
        if r1 == r0:
            out.append(None)
            continue
        shape = (cfg.n_layers, r1 - r0, lay.heads, lay.s_loc, cfg.head_dim)
        c = dict(k=torch.zeros(shape, dtype=dtype, device=dev),
                 v=torch.zeros(shape, dtype=dtype, device=dev),
                 valid=torch.zeros((r1 - r0, lay.s_loc), dtype=torch.bool,
                                   device=dev),
                 length=torch.zeros((r1 - r0,), dtype=torch.int32,
                                    device=dev))
        if lay.seq:
            c["offset"] = lay.offset(i)
        out.append(c)
    return out


def init_hidden(cfg, lay: Layout, dtype) -> T.MemberHidden:
    hs = []
    for g, (r0, r1) in enumerate(lay.rows):
        hs.append(None if r1 == r0 else [
            torch.zeros((r1 - r0, cfg.hidden_dim), dtype=dtype, device=dev)
            for dev in lay.devices[g * lay.t:(g + 1) * lay.t]])
    return T.MemberHidden(hs, list(lay.rows))


def set_hidden(state, lay: Layout, slot: int, hs: List[torch.Tensor]):
    """Slot ``slot``'s last hidden state from its group's members' rows
    ``hs`` ([..., H] each, the last position taken)."""
    g, r = lay.group_of(slot)
    for dst, h in zip(state["last_hidden"].hs[g], hs):
        dst[r] = h.reshape(-1, h.shape[-1])[-1]


def lengths(lay: Layout, caches) -> torch.Tensor:
    """Every slot's write index, on the first member's device."""
    return torch.cat([caches[g * lay.t]["length"].to(lay.devices[0])
                      for g, (r0, r1) in enumerate(lay.rows) if r1 > r0])


def total_slots(lay: Layout, caches) -> int:
    """The cache slots of a slot row in ``caches`` (the slot caches, or a
    paged window's): a member's, times t on the "seq" route."""
    c = next(x for x in caches if x is not None)
    return c["valid"].shape[1] * (lay.t if lay.seq else 1)


def group_rows(lay: Layout):
    """(g, r0, r1) of every data group that holds slots."""
    return [(g, r0, r1) for g, (r0, r1) in enumerate(lay.rows) if r1 > r0]


# ----------------------------------------------------------------------
# fills
# ----------------------------------------------------------------------
def prefill_into_slot(cfg, mp, lay: Layout, state, slot: int, ids, seg, pos):
    """The dense fill: the bucketed prompt through the owning group's
    members (K1 on each), their caches written into the slot's row.
    Returns the group's last hidden rows."""
    g, r = lay.group_of(slot)
    hidden, pcaches = T.prefill(cfg, mp, ids, seg, pos, total_len=lay.slots,
                                group=g)
    for i in lay.members(g):
        c, pc = state["cache"][i], pcaches[i]
        for name in ("k", "v"):
            c[name][:, r] = pc[name][:, 0]
        c["valid"][r] = pc["valid"][0]
        c["length"][r] = ids.shape[1]  # write index
    return hidden.hs[g]


def write_donor(cfg, lay: Layout, caches, slot: int, donor_k, donor_v, c: int):
    """Clear ``slot``'s row in its group's caches and seed slots [0, c)
    with the host prefix KV (``[nl, nkv, >= c, hd]``): each member its own
    heads (on the "seq" route every head over its slice)."""
    g, r = lay.group_of(slot)
    for i in lay.members(g):
        cache = caches[i]
        dev, kdt = cache["k"].device, cache["k"].dtype
        h0 = 0 if lay.seq else (i % lay.t) * lay.heads
        lo = lay.offset(i)
        hi = min(lo + lay.s_loc, c)
        for name, src in (("k", donor_k), ("v", donor_v)):
            cache[name][:, r] = 0
            if hi > lo:
                cache[name][:, r, :, :hi - lo] = src[
                    :, h0:h0 + lay.heads, lo:hi].to(dev, kdt)
        cache["valid"][r] = False
        if hi > lo:
            cache["valid"][r, :hi - lo] = True


def set_valid(lay: Layout, caches, slot: int, start: int, mask: torch.Tensor):
    """Mark slots ``[start, start + len(mask))`` of ``slot``'s row valid
    where ``mask``, on each member's part of them."""
    g, r = lay.group_of(slot)
    n = mask.shape[0]
    for i in lay.members(g):
        cache = caches[i]
        lo = lay.offset(i)
        a, b = max(start, lo), min(start + n, lo + lay.s_loc)
        if b > a:
            cache["valid"][r, a - lo:b - lo] = mask[a - start:b - start].to(
                cache["valid"].device)


def row_views(lay: Layout, caches, slot: int):
    """The member caches narrowed to ``slot``'s row (views: writes land
    in the caches)."""
    g, r = lay.group_of(slot)
    out = [None] * len(caches)
    for i in lay.members(g):
        c = caches[i]
        out[i] = dict(c, k=c["k"][:, r:r + 1], v=c["v"][:, r:r + 1],
                      valid=c["valid"][r:r + 1],
                      length=c["length"][r:r + 1])
    return out


# ----------------------------------------------------------------------
# the extended forward (its one-member pieces serve the one-device
# ``inflight._extend_rows`` too)
# ----------------------------------------------------------------------
#: ``_extend_rows`` writes up to this many lanes one lane at a time (in
#: lane order); wider calls write in one indexed put (suffix prefill,
#: whose kept rows are distinct)
_SEQUENTIAL_LANES = 16


def write_rows(cache_l: torch.Tensor, rows: torch.Tensor,
               new: torch.Tensor, keep: torch.Tensor):
    """Write ``new`` [B, m, nkv, hd] at rows ``rows`` [B, m] of one
    layer's cache [B, nkv, S, hd] where ``keep`` [B, m]; masked lanes
    leave their row as it is. Narrow calls write lane by lane in lane
    order, so a masked lane clamped onto a kept lane's row never undoes
    that write; wide calls write once (their kept rows are distinct and
    their masked lanes write only rows no kept lane writes)."""
    b, m = rows.shape
    barr = torch.arange(b, device=rows.device)
    new = new.to(cache_l.dtype)
    if m <= _SEQUENTIAL_LANES:
        for j in range(m):
            r = rows[:, j].long()
            cache_l[barr, :, r] = torch.where(
                keep[:, j, None, None], new[:, j], cache_l[barr, :, r])
        return
    r = rows.long()
    cache_l[barr[:, None], :, r] = torch.where(
        keep[:, :, None, None], new, cache_l[barr[:, None], :, r])


def query_mask(cfg, cache, rows, tok_mask):
    """[B, m, s_loc]: the slots each new token attends on a member (valid
    before the call, plus the new rows of lanes up to its own)."""
    valid0 = cache["valid"]
    s_loc = valid0.shape[1]
    sidx = cache.get("offset", 0) + torch.arange(s_loc, device=valid0.device)
    written = (rows[:, :, None] == sidx[None, None]) & tok_mask[:, :, None]
    upto = torch.cumsum(written.to(torch.int32), dim=1) > 0
    qmask = valid0[:, None, :] | upto
    if cfg.sliding_window is not None:
        qmask = qmask & ((rows[:, :, None] - sidx[None, None])
                         < cfg.sliding_window)
    return qmask


def _write(cache_l, rows, new, keep, offset, seq):
    """New rows into one layer's member cache [B, nkv, s_loc, hd]; on the
    "seq" route only the rows inside the member's slice, and only kept
    lanes (masked lanes write nothing)."""
    if not seq:
        write_rows(cache_l, rows, new, keep)
        return
    s_loc = cache_l.shape[2]
    loc = rows.long() - offset
    keep = keep & (loc >= 0) & (loc < s_loc)
    bi, li = keep.nonzero(as_tuple=True)
    if bi.numel():
        cache_l[bi, :, loc[bi, li]] = new[bi, li].to(cache_l.dtype)


def _partial(q, k, v, mask, scale, n_kv):
    """Plain attention of q [B, m, nq, hd] over one slice of the slots
    (k/v [B, nkv, s, hd], mask [B, m, s]) -> (out [B, m, nq, hd], row max
    m, row sum l [B, m, nq]), as K4 with statistics returns them."""
    b, m, nq, hd = q.shape
    qg = q.reshape(b, m, n_kv, nq // n_kv, hd).to(torch.float32)
    scores = torch.einsum("bmhgd,bhsd->bmhgs", qg,
                          k.to(torch.float32)) * scale
    scores = torch.where(mask[:, :, None, None, :], scores, NEG_INF)
    mx = scores.amax(-1)
    p = torch.exp(scores - mx[..., None])
    l = p.sum(-1)
    out = torch.einsum("bmhgs,bhsd->bmhgd", (p / l[..., None]).to(v.dtype), v)
    return (out.reshape(b, m, nq, hd), mx.reshape(b, m, nq),
            l.reshape(b, m, nq))


def attend(cfg, li, q, cache, mask):
    """One member's (or one device's) attention of its own heads over its
    whole cache: fp32 scores masked per query, as the JAX package
    computes it with an einsum outside any Pallas kernel."""
    k_l, v_l = cache["k"][li], cache["v"][li]
    b, m, nq, hd = q.shape
    n_kv = k_l.shape[1]
    qg = q.reshape(b, m, n_kv, nq // n_kv, hd)
    scores = torch.einsum("bmhgd,bhsd->bmhgs", qg.to(torch.float32),
                          k_l.to(torch.float32)) * T._attn_scale(cfg, li)
    scores = torch.where(mask[:, :, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bmhgs,bhsd->bmhgd", probs.to(v_l.dtype), v_l)


def _seq_attend(cfg, li, qs, caches, masks, devs, dtype):
    """The "seq" route: q of every member's heads gathered, each member's
    slice attended (``_partial``), the partials merged on the first
    member's device (``seqsplit_merge``) and the merge on every member."""
    q = torch.cat([x.to(devs[0]) for x in qs], dim=2)
    parts = []
    for c, mask in zip(caches, masks):
        dev = c["k"].device
        res = _partial(q.to(dev), c["k"][li], c["v"][li], mask,
                       T._attn_scale(cfg, li), cfg.n_kv_heads)
        parts.append(tuple(x.to(devs[0]) for x in res))
    return C.broadcast(_decode.seqsplit_merge(parts, dtype), devs)


def extend_rows(cfg, mp: MemberParams, lay: Layout, caches, tokens, positions,
                rows, tok_mask, groups, n_tokens: int) -> T.MemberHidden:
    """``inflight._extend_rows`` over members: token rows ``[r0, r1)`` of
    ``tokens``/``positions``/``rows``/``tok_mask`` ([B, m], on any
    device) run on data group g's members for each ``(g, r0, r1)`` of
    ``groups``, against ``caches[i]`` (member i's cache over exactly
    those rows), written in place. ``n_tokens`` is the token count the
    MoE capacity is taken over (the call's whole batch). Returns the
    final hidden states [rows, m, H] of each listed group's members."""
    moe = T._moe_shards(cfg, mp, n_tokens)
    starts = mp.vocab_starts(cfg)
    hs = [None] * lay.d
    hrows = [(0, 0)] * lay.d
    for g, r0, r1 in groups:
        trees, devs = mp.group(g)
        cs = [caches[i] for i in lay.members(g)]
        tok_m = C.broadcast(tokens[r0:r1], devs)
        pos_m = C.broadcast(positions[r0:r1], devs)
        rows_m = C.broadcast(rows[r0:r1], devs)
        keep_m = C.broadcast(tok_mask[r0:r1], devs)
        xs = T._embed_members(cfg, trees, devs, tok_m, pos_m, starts)
        tables = [T._rotary_tables(cfg, p) for p in pos_m]
        masks = [query_mask(cfg, c, rw, km)
                 for c, rw, km in zip(cs, rows_m, keep_m)]
        layers = [T.layer_views(tr["blocks"], cfg.n_layers) for tr in trees]
        for li in range(cfg.n_layers):
            lps = [lv[li] for lv in layers]
            qs = []
            for lp, x, (cos, sin), c, rw, km in zip(lps, xs, tables, cs,
                                                    rows_m, keep_m):
                q, k, v = T._attn_in(cfg, lp, x, cos, sin)
                for name, new in (("k", k), ("v", v)):
                    _write(c[name][li], rw, new, km, c.get("offset", 0),
                           lay.seq)
                qs.append(q)
            if lay.seq:
                merged = _seq_attend(cfg, li, qs, cs, masks, devs, xs[0].dtype)
                per = cfg.n_q_heads // lay.t
                attn = [o[:, :, j * per:(j + 1) * per]
                        for j, o in enumerate(merged)]
            else:
                attn = [attend(cfg, li, q, c, mask)
                        for q, c, mask in zip(qs, cs, masks)]
            parts = [a.reshape(*x.shape[:-1], -1).to(x.dtype)
                     @ lp["attn"]["wo"].to(x.dtype)
                     for a, x, lp in zip(attn, xs, lps)]
            xs = T._add_reduced(xs, parts, [lp["attn"].get("bo")
                                            for lp in lps], devs)
            xs = T._mlp_members(cfg, lps, devs, xs, T._call, False, None,
                                None if moe is None else (moe, li, (g, 0)))
        hs[g] = [T._norm(cfg, x, tr["ln_f"]["scale"], tr["ln_f"].get("bias"))
                 for tr, x in zip(trees, xs)]
        hrows[g] = (r0, r1)
    return T.MemberHidden(hs, hrows)


def commit(lay: Layout, caches, kept: torch.Tensor, n_emit: torch.Tensor):
    """After a verify round: slots ``kept`` [n_slots, total_slots] become
    valid and each write index moves by ``n_emit``."""
    for i, c in enumerate(caches):
        if c is None:
            continue
        r0, r1 = lay.rows[i // lay.t]
        dev = c["valid"].device
        lo = c.get("offset", 0)
        c["valid"] |= kept[r0:r1, lo:lo + c["valid"].shape[1]].to(dev)
        c["length"] += n_emit[r0:r1].to(dev, torch.int32)


def select_hidden(lay: Layout, hidden: T.MemberHidden, idx: torch.Tensor,
                  live: torch.Tensor, last: T.MemberHidden) -> T.MemberHidden:
    """Each live slot's hidden state at lane ``idx`` (the last emitted),
    the old one elsewhere."""
    hs = []
    for g, (r0, r1) in enumerate(lay.rows):
        if r1 == r0:
            hs.append(None)
            continue
        out = []
        for h, old in zip(hidden.hs[g], last.hs[g]):
            dev = h.device
            sel = h[torch.arange(r1 - r0, device=dev),
                    idx[r0:r1].to(dev).long()]
            out.append(torch.where(live[r0:r1, None].to(dev), sel, old))
        hs.append(out)
    return T.MemberHidden(hs, list(lay.rows))


def export_dense_kv(lay: Layout, caches, slots: Sequence[int]):
    """Each finished slot's valid rows of every KV head, in token order:
    ``(k, v)`` host arrays [nl, nkv, len, hd], the layout of a one-device
    export."""
    out = []
    dev0 = lay.devices[0]
    for slot in slots:
        g, r = lay.group_of(slot)
        cs = [caches[i] for i in lay.members(g)]
        axis = 2 if lay.seq else 1
        kv = [torch.cat([c[name][:, r].to(dev0) for c in cs], dim=axis)
              for name in ("k", "v")]
        valid = (torch.cat([c["valid"][r].to(dev0) for c in cs]) if lay.seq
                 else cs[0]["valid"][r].to(dev0))
        idx = valid.nonzero()[:, 0]
        out.append(tuple(np.ascontiguousarray(tensor_to_numpy(
            x.index_select(2, idx))) for x in kv))
    return out


# ----------------------------------------------------------------------
# the paged pool
# ----------------------------------------------------------------------
def check_pool(pool, lay: Layout):
    if pool.t != lay.t or list(pool.devices) != list(lay.devices):
        raise ValueError(
            f"KV pool over t={pool.t} on {list(map(str, pool.devices))}, "
            f"generator over t={lay.t} on "
            f"{list(map(str, lay.devices))}")


def _slice_rows(bt, lay: Layout, i: int, win: int, blen: int):
    """(window positions, flat pool rows [B, ...]) member ``i`` gathers
    of a window of ``win`` rows: all of them, or on the "seq" route its
    slice of ``seq_slots(win)``; positions past the block table read the
    last column (they lie past every valid row)."""
    if not lay.seq:
        pos = torch.arange(win, dtype=torch.int32, device=bt.device)
    else:
        s_loc = seq_slots(win, lay.t) // lay.t
        pos = (i % lay.t) * s_loc + torch.arange(s_loc, dtype=torch.int32,
                                                 device=bt.device)
    cols = (pos // blen).clamp(max=bt.shape[1] - 1).long()
    return pos, bt[:, cols].long() * blen + (pos % blen)[None, :]


def paged_window(cfg, meta, pool, lay: Layout, bt, win: int, length):
    """Every member's dense cache over the window: its heads (its slice
    on the "seq" route) of the slots' first ``win`` rows, gathered from
    its arena; row ``j < length`` valid."""
    cdt = T.dtype_of(cfg.compute_dtype)
    caches = []
    for i, dev in enumerate(lay.devices):
        g = i // lay.t
        r0, r1 = lay.rows[g]
        if r1 == r0:
            caches.append(None)
            continue
        pos, rows = _slice_rows(bt[r0:r1], lay, i, win, meta.block_len)
        k, v = _kvp.pool_gather(meta, pool.member_arrays(i), rows.to(dev),
                                cdt)
        ln = length[r0:r1].to(dev)
        c = dict(k=k, v=v, valid=pos.to(dev)[None, :] < ln[:, None],
                 length=ln.clone())
        if lay.seq:
            c["offset"] = int(pos[0])
        caches.append(c)
    return caches


def _owned_rows(lay: Layout, cs, want):
    """The K/V of window rows ``want`` [B, m] from a group's member
    caches ``cs`` -> per member [(k, v)] [nl, B, heads, m, hd], each on
    its member's device: its own rows, or on the "seq" route the rows
    whichever member's slice holds them (the same values for all)."""
    if not lay.seq:
        out = []
        for c in cs:
            nl, b, nkv, _, hd = c["k"].shape
            idx = want.to(c["k"].device).long()[None, :, None, :, None]
            idx = idx.expand(nl, b, nkv, want.shape[1], hd)
            out.append((c["k"].gather(3, idx), c["v"].gather(3, idx)))
        return out
    dev0 = cs[0]["k"].device
    acc = None
    for c in cs:
        nl, b, nkv, s_loc, hd = c["k"].shape
        dev = c["k"].device
        loc = want.to(dev).long() - c["offset"]
        own = (loc >= 0) & (loc < s_loc)
        idx = loc.clamp(0, s_loc - 1)[None, :, None, :, None].expand(
            nl, b, nkv, want.shape[1], hd)
        got = [torch.where(own[None, :, None, :, None], c[w].gather(3, idx),
                           0).to(dev0) for w in ("k", "v")]
        acc = got if acc is None else [a + x for a, x in zip(acc, got)]
    return [tuple(x.to(c["k"].device) for x in acc) for c in cs]


def scatter_rows(meta, pool, lay: Layout, g: int, cs, want, flat, mask):
    """Write window rows ``want`` [B, m] of group g's member caches ``cs``
    to pool rows ``flat`` [B, m] where ``mask``: each member into its
    arena (every member on the "seq" route)."""
    for i, (k, v) in zip(lay.members(g), _owned_rows(lay, cs, want)):
        dev = k.device
        _kvp.pool_scatter(meta, pool.member_arrays(i), flat.to(dev), k, v,
                          mask.to(dev))


def scatter_written(meta, pool, lay: Layout, caches, bt, win: int, len0,
                    m: int, mask_extra):
    """``inflight._scatter_written`` over members: rows ``[len0, len0 +
    m)`` of each slot, masked to ``mask_extra`` and to the window."""
    j = torch.arange(m, dtype=torch.int32, device=len0.device)[None, :]
    want = len0[:, None] + j
    wrows = want.clamp(0, win - 1)
    mask = (want < win) & mask_extra
    blen = meta.block_len
    flat = (bt.long().gather(1, (wrows // blen).long()) * blen
            + (wrows % blen))
    for g, r0, r1 in group_rows(lay):
        scatter_rows(meta, pool, lay, g,
                     [caches[i] for i in lay.members(g)], wrows[r0:r1],
                     flat[r0:r1], mask[r0:r1])


def full_rows(lay: Layout, pcaches, g: int):
    """A group's prefill caches -> each member's K/V over every cache slot
    of the row ([nl, 1, heads, S, hd]): its own, or on the "seq" route
    the slices joined."""
    cs = [pcaches[i] for i in lay.members(g)]
    if not lay.seq:
        return [(c["k"], c["v"]) for c in cs]
    return [tuple(torch.cat([x[w].to(c["k"].device) for x in cs], dim=3)
                  for w in ("k", "v")) for c in cs]


def paged_prefill(cfg, meta, mp, pool, lay: Layout, slot: int, ids, seg, pos,
                  bt_row, n: int):
    """``inflight._paged_prefill`` on the owning group's members: the
    left padding stripped, window row p holding token p. Returns the
    group's last hidden rows."""
    g, _ = lay.group_of(slot)
    hidden, pcaches = T.prefill(cfg, mp, ids, seg, pos, group=g)
    lp = ids.shape[1]
    blen = meta.block_len
    warange = torch.arange(lp, dtype=torch.int32, device=bt_row.device)
    rows = (bt_row[(warange // blen).long()].long() * blen
            + warange % blen)[None, :]
    keep = (warange < n)[None, :]
    for i, (k, v) in zip(lay.members(g), full_rows(lay, pcaches, g)):
        dev = k.device
        src = (warange + (lp - n)).clamp(0, k.shape[3] - 1).long().to(dev)
        _kvp.pool_scatter(meta, pool.member_arrays(i), rows.to(dev),
                          k[:, 0].index_select(2, src)[:, None],
                          v[:, 0].index_select(2, src)[:, None],
                          keep.to(dev))
    return hidden.hs[g]


def paged_prefill_suffix(cfg, meta, mp, pool, lay: Layout, slot: int, bt_row,
                         c: int, c_b: int, ids, seg, pos, s: int):
    """``inflight._paged_prefill_suffix`` on the owning group's members:
    the aliased donor rows [0, c) gathered into a local window per
    member, the suffix run by ``extend_rows`` at window rows [c, c + s)
    and those rows scattered into the arenas. Returns the group's last
    hidden rows."""
    g, _ = lay.group_of(slot)
    s_b = ids.shape[1]
    win = c_b + s_b
    blen = meta.block_len
    cdt = T.dtype_of(cfg.compute_dtype)
    bt = bt_row[None, :]
    local = [None] * len(lay.devices)
    for i in lay.members(g):
        dev = lay.devices[i]
        wpos, rows = _slice_rows(bt, lay, i, win, blen)
        k, v = _kvp.pool_gather(meta, pool.member_arrays(i), rows.to(dev),
                                cdt)
        donor = (wpos < c_b).to(dev)[None, None, None, :, None]
        local[i] = dict(k=torch.where(donor, k, 0), v=torch.where(donor, v, 0),
                        valid=(wpos < c).to(dev)[None, :])
        if lay.seq:
            local[i]["offset"] = int(wpos[0])
    dev0 = ids.device
    lane = torch.arange(s_b, dtype=torch.int32, device=dev0)
    wrow = (c + lane - (s_b - s)).clamp(0, win - 1)[None, :]
    tok_mask = seg != 0
    hidden = extend_rows(cfg, mp, lay, local, ids, pos, wrow, tok_mask,
                         [(g, 0, 1)], s_b)
    flat = bt_row[(wrow[0] // blen).long()].long() * blen + wrow[0] % blen
    scatter_rows(meta, pool, lay, g, [local[i] for i in lay.members(g)], wrow,
                 flat[None, :], tok_mask)
    return hidden.hs[g]


def copy_blocks(pool, lay: Layout, blocks: Sequence[int], src: int, dst: int):
    """Copy pool ``blocks``' rows from data group ``src``'s arenas into
    group ``dst``'s, member j to member j."""
    blen = pool.block_len
    rows = torch.as_tensor(np.concatenate(
        [np.arange(b * blen, (b + 1) * blen) for b in blocks]))
    for j in range(lay.t):
        a = pool.member_arrays(src * lay.t + j)
        b = pool.member_arrays(dst * lay.t + j)
        for name, arr in b.items():
            r = rows.to(arr.device)
            arr.index_copy_(2, r, a[name].index_select(
                2, rows.to(a[name].device)).to(arr.device))


def export_pool_kv(pool, lay: Layout, slot: int, flat_rows: np.ndarray):
    """A slot's pool rows (token order) of every KV head, dequantized:
    host arrays ``(k, v)`` [nl, nkv, len, hd] from its group's arenas."""
    g, _ = lay.group_of(slot)
    members = [g * lay.t] if lay.seq else list(lay.members(g))
    out = []
    for name in ("k", "v"):
        parts = []
        for i in members:
            arr = pool.member_arrays(i)
            rows = torch.as_tensor(flat_rows.astype(np.int64)).to(
                arr[name].device)
            x = arr[name].index_select(2, rows)
            if pool.meta.quant:
                x = x.to(torch.float32) * arr[f"{name}_scale"].index_select(
                    2, rows)[..., None]
            parts.append(tensor_to_numpy(x))
        out.append(np.ascontiguousarray(np.concatenate(parts, axis=1)))
    return tuple(out)
