"""Mixture-of-experts layer: routing, dispatch, expert GEMMs, losses.

The counterpart of the JAX package's ``ops/moe.py``, function for
function. Three dispatch modes, chosen by the config as there:

- ``capacity_factor=None`` + ``use_grouped_gemm`` (the default): RAGGED
  mode. The (token, k) pairs are sorted by expert (a stable sort, as
  ``jnp.argsort`` is), each expert's contiguous slice of them goes
  through its three projections as one ``torch.matmul`` each (JAX's
  ``jax.lax.ragged_dot``, an XLA op and not a Pallas kernel), and the
  gate-weighted outputs are added back onto their tokens. Exact top-k
  MoE. The slice bounds come to the host once per call
  (``host_reads``).
- ``capacity_factor=None`` + ``use_grouped_gemm=False``: dense mode,
  every expert over every token, weighted by its gate (E / top_k times
  the FLOPs; the correctness reference).
- ``capacity_factor=c``: capacity dispatch, each expert takes at most
  ``c * T * top_k / E`` tokens and drops the overflow (Switch/GShard).

The router's product runs in fp32 whatever the compute dtype, as the
JAX package's does: a TF32 or bf16 router would send near-tie tokens to
other experts.

Over the members of a layout (``models/transformer.py``) one batch is
routed as several token shards, data groups of contiguous rows and
context shards that interleave row by row, while the JAX package routes
the whole ``[B * L]`` token set at once under GSPMD. ``MoEShards`` keeps
what makes the shards one set: the global token count the capacity is
taken over, each shard's per-row expert counts (so a shard's queue
positions start after every token before it in JAX's flat order), and
each shard's router sums, from which ``MoEShards.losses`` forms the
load-balancing and z losses of the whole batch. With expert parallelism
(``MoEConfig.expert_parallel``) a member holds ``E / d`` experts: the
``[E, C, H]`` buffer of a shard goes to the experts' owners by
``parallel/collectives.all_to_all`` and their outputs come back.
"""

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from realhf_tpu_torch.models.config import MoEConfig, TransformerConfig
from realhf_tpu_torch.parallel import collectives as C

#: group-size reads to the host made by the ragged dispatch, one per
#: call; reset it to 0 to count the reads of one run
host_reads = 0


def router_probs(cfg_moe: MoEConfig, logits: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[T, E] logits -> (top-k probs [T, k] fp32, indices [T, k]).

    Default (aux_loss / none): softmax over all experts, top-k,
    renormalised with a 1e-9 floor (Mixtral). Sinkhorn routing picks the
    indices from the sinkhorn-normalised logits with no gradient; the
    gates come from the raw logits (sigmoid for k = 1, a softmax over the
    selected logits for k > 1)."""
    logits = logits.to(torch.float32)
    if cfg_moe.routing_type == "sinkhorn":
        _, top_idx = torch.topk(sinkhorn(logits.detach()), cfg_moe.top_k,
                                dim=-1)
        sel = torch.gather(logits, -1, top_idx)
        if cfg_moe.top_k == 1:
            return torch.sigmoid(sel), top_idx
        return torch.softmax(sel, dim=-1), top_idx
    probs = torch.softmax(logits, dim=-1)
    top_probs, top_idx = torch.topk(probs, cfg_moe.top_k, dim=-1)
    top_probs = top_probs / top_probs.sum(-1, keepdim=True).clamp_min(1e-9)
    return top_probs, top_idx


def sinkhorn(logits: torch.Tensor, n_iters: int = 8) -> torch.Tensor:
    """Sinkhorn normalisation of routing logits, a fixed 8 iterations."""
    cost = torch.exp(logits)
    t, e = cost.shape
    d0 = torch.ones(t, dtype=torch.float32, device=cost.device)
    d1 = torch.ones(e, dtype=torch.float32, device=cost.device)
    for _ in range(n_iters):
        d0 = 1.0 / (t * (cost @ d1) + 1e-8)
        d1 = 1.0 / (e * (d0 @ cost) + 1e-8)
    return torch.log(d1[None, :] * cost * d0[:, None] + 1e-20)


def load_balancing_loss(probs: torch.Tensor, top_idx: torch.Tensor,
                        n_experts: int, top_k: int,
                        valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Switch-transformer auxiliary loss over the valid tokens."""
    t = probs.shape[0]
    if valid is None:
        valid = torch.ones(t, dtype=torch.float32, device=probs.device)
    n = valid.sum().clamp_min(1.0)
    counts = torch.zeros(n_experts, dtype=torch.float32,
                         device=probs.device).index_add(
        0, top_idx.reshape(-1), valid.repeat_interleave(top_idx.shape[1]))
    fraction_tokens = counts / (n * top_k)
    fraction_probs = (probs * valid[:, None]).sum(0) / n
    return n_experts * (fraction_tokens * fraction_probs).sum()


def z_loss(logits: torch.Tensor,
           valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Router z-loss: the squared log-sum-exp of the logits, averaged
    over the valid tokens."""
    z = torch.logsumexp(logits.to(torch.float32), dim=-1) ** 2
    if valid is None:
        return z.mean()
    return (z * valid).sum() / valid.sum().clamp_min(1.0)


def _expert_ffn(cfg: TransformerConfig, m: Dict, xs: torch.Tensor
                ) -> torch.Tensor:
    """Batched expert MLP: xs [E, C, H] -> [E, C, H] through the stacked
    [E, H, F] / [E, F, H] weights, one batched product a projection."""
    from realhf_tpu_torch.models.transformer import _activation
    cdt = xs.dtype
    gate = torch.matmul(xs, m["wg"].to(cdt))
    up = torch.matmul(xs, m["wu"].to(cdt))
    return torch.matmul(_activation(cfg, gate) * up, m["wd"].to(cdt))


def ragged_dispatch_enabled(cfg: TransformerConfig) -> bool:
    """Whether this config runs the grouped-GEMM (ragged) dispatch."""
    return (cfg.mlp_type == "moe" and cfg.moe is not None
            and cfg.moe.capacity_factor is None
            and cfg.moe.use_grouped_gemm)


def _ragged_moe(cfg: TransformerConfig, m: Dict, xt: torch.Tensor,
                top_probs: torch.Tensor, top_idx: torch.Tensor
                ) -> torch.Tensor:
    """Grouped-GEMM dispatch -> [T, H] fp32: the (token, k) pairs sorted
    by expert, each expert's slice through its projections, the
    gate-weighted rows added back onto their tokens."""
    from realhf_tpu_torch.models.transformer import _activation
    global host_reads
    t, h = xt.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    cdt = xt.dtype
    flat_expert = top_idx.reshape(-1)                       # [T*k]
    order = torch.argsort(flat_expert, stable=True)         # by expert
    tok_idx = order // k
    xs = xt[tok_idx]                                        # [T*k, H]
    sizes: List[int] = torch.bincount(flat_expert, minlength=e).tolist()
    host_reads += 1
    wg, wu, wd = (m[name].to(cdt).unbind(0) for name in ("wg", "wu", "wd"))
    outs, lo = [], 0
    for j, n in enumerate(sizes):
        if n:
            xe = xs[lo:lo + n]
            act = _activation(cfg, xe @ wg[j]) * (xe @ wu[j])
            outs.append(act @ wd[j])
        lo += n
    down = torch.cat(outs) if outs else xs.new_zeros((0, h))
    gates_sorted = top_probs.reshape(-1)[order]
    weighted = down.to(torch.float32) * gates_sorted[:, None]
    # each token receives top_k adds onto 0; fp32 addition commutes, so
    # for top_k <= 2 the order of the CUDA atomics cannot change a bit.
    # With top_k > 2 it can, as XLA's scatter-add order can in JAX.
    return torch.zeros((t, h), dtype=torch.float32,
                       device=xt.device).index_add(0, tok_idx, weighted)


def router_stats(probs_full: torch.Tensor, top_idx: torch.Tensor,
                 logits: torch.Tensor, valid: torch.Tensor, n_experts: int
                 ) -> Dict[str, torch.Tensor]:
    """One token shard's sums that the router losses are formed from:
    the valid-weighted expert counts (no gradient), the valid-weighted
    probability sums, the valid count and the valid-weighted squared
    log-sum-exp of the logits."""
    counts = torch.zeros(n_experts, dtype=torch.float32,
                         device=probs_full.device).index_add(
        0, top_idx.reshape(-1), valid.repeat_interleave(top_idx.shape[1]))
    z = torch.logsumexp(logits.to(torch.float32), dim=-1) ** 2
    return dict(counts=counts.detach(),
                probs=(probs_full * valid[:, None]).sum(0),
                n=valid.sum(), z=(z * valid).sum())


def router_losses(moe: MoEConfig, st: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """``load_balancing_loss`` and ``z_loss`` (times their coefficients)
    from ``router_stats`` summed over the shards of a batch."""
    n = st["n"].clamp_min(1.0)
    losses = {}
    if moe.routing_type == "aux_loss" and moe.aux_loss_coeff:
        frac_tokens = st["counts"] / (n * moe.top_k)
        losses["moe_aux_loss"] = moe.aux_loss_coeff * (
            moe.num_experts * (frac_tokens * (st["probs"] / n)).sum())
    if moe.z_loss_coeff:
        losses["moe_z_loss"] = moe.z_loss_coeff * (st["z"] / n)
    return losses


class MoEShards:
    """The token shards of one batch that the JAX package routes as one
    set. A shard is keyed ``(g, c)``: data group g's rows (contiguous
    blocks of streams, in order) and context shard c of each of those
    rows (contiguous columns, in order). JAX's flat token order is row
    by row, so a shard's row r comes after every row of the groups
    before g, after rows < r of its group in every context shard, and
    after row r of the context shards before c.

    ``n_tokens`` is the token count JAX's capacity is taken over (the
    unpadded ``B * L``). Each MoE layer call of a shard registers its
    per-row expert counts (``register``) and reads its queue offsets
    (``base``); all context shards of a group register before any of
    them reads (``transformer.forward_ctx`` routes them once first).
    ``record`` keeps the model member 0 router sums of each (layer,
    shard), ``losses`` forms the batch's losses from them. Registering
    again (a checkpointed block's recompute) overwrites with equal
    values. ``experts``, set for expert parallelism, maps (c, j) to each
    layer's (layer view, device) of every data index's member.
    ``layer_sums`` hands a pipeline stage's recorded sums to its caller
    (``transformer._stage_step``)."""

    def __init__(self, n_tokens: int, n_ctx: int, device: torch.device,
                 experts=None):
        self.n_tokens = n_tokens
        self.n_ctx = n_ctx
        self.device = device
        self.experts = experts
        self._counts: Dict[tuple, torch.Tensor] = {}
        self._stats: Dict[tuple, Dict[str, torch.Tensor]] = {}

    def register(self, layer: int, key, counts: torch.Tensor):
        self._counts[(layer, *key)] = counts.to(self.device, torch.int64)

    def base(self, layer: int, key) -> torch.Tensor:
        """[rows, E] int64: per row of shard ``key``, the tokens of each
        expert's queue that come before the row in JAX's order."""
        g, c = key
        mine = [self._counts[(layer, g, ci)] for ci in range(self.n_ctx)]
        rows = sum(mine)
        out = torch.cumsum(rows, 0) - rows + sum(mine[:c])
        for (li, gi, _), v in self._counts.items():
            if li == layer and gi < g:
                out = out + v.sum(0)
        return out

    def record(self, layer: int, key, stats: Dict[str, torch.Tensor]):
        self._stats[(layer, *key)] = stats

    def layer_sums(self, layers, key) -> Dict[str, torch.Tensor]:
        """The router sums recorded for shard ``key`` at ``layers``,
        keyed ``"layer/name"``."""
        return {f"{li}/{name}": v for li in layers
                for name, v in self._stats[(li, *key)].items()}

    def losses(self, moe: MoEConfig) -> Dict[str, torch.Tensor]:
        """Each router loss of the batch, summed over the layers: per
        layer from the router sums of every shard."""
        out: Dict[str, torch.Tensor] = {}
        for layer in sorted({k[0] for k in self._stats}):
            keys = sorted(k for k in self._stats if k[0] == layer)
            st = {name: sum(self._stats[k][name].to(self.device)
                            for k in keys)
                  for name in self._stats[keys[0]]}
            for name, val in router_losses(moe, st).items():
                out[name] = out[name] + val if name in out else val
        return out


@dataclasses.dataclass
class MoEShard:
    """Where one MoE layer call sits: the batch's ``MoEShards``, the
    layer, the shard key (g, c) and the model member j."""
    shards: MoEShards
    layer: int
    key: Tuple[int, int]
    j: int = 0


def _expert_parallel_ffn(cfg: TransformerConfig, shard: MoEShard,
                         xs: torch.Tensor) -> torch.Tensor:
    """The expert MLP of an [E, N, H] buffer whose experts lie split over
    the data index: each owner's slice goes to its device, runs there
    through its member's weights, and comes back (``all_to_all``)."""
    owners = shard.shards.experts[(shard.key[1], shard.j)][shard.layer]
    devs = [d for _, d in owners]
    recv = C.all_to_all([list(xs.chunk(len(owners), 0))], devs)
    outs = [_expert_ffn(cfg, view["mlp"], r[0])
            for (view, _), r in zip(owners, recv)]
    back = C.all_to_all([[o] for o in outs], [xs.device])[0]
    return torch.cat(back, 0)


def moe_mlp_with_losses(cfg: TransformerConfig, m: Dict, x: torch.Tensor,
                        valid_mask: Optional[torch.Tensor] = None,
                        shard: Optional[MoEShard] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MoE feed-forward over [B, L, H] -> (output [B, L, H] in x's dtype,
    aux losses). ``valid_mask`` [B, L] keeps padding tokens out of the
    routing, the expert capacity and the aux losses (their gates are 0).
    With ``shard`` the call is one token shard of a batch (``MoEShards``):
    the capacity is the batch's, the queue positions follow every token
    before the shard, the router sums go to ``shard.shards`` and no
    losses come back; ``m`` may hold a model member's slice of every
    expert's FFN width (the output is then that member's partial sum)."""
    moe = cfg.moe
    if moe.input_jitter_eps:
        raise NotImplementedError(
            "input_jitter_eps requires threading an rng key through the "
            "forward pass, which is not wired yet; unset it.")
    b, l, h = x.shape
    t = b * l
    xt = x.reshape(t, h)
    if valid_mask is None:
        valid = torch.ones(t, dtype=torch.float32, device=x.device)
    else:
        valid = valid_mask.reshape(t).to(torch.float32)
    logits = xt.to(torch.float32) @ m["router"].to(torch.float32)  # [T, E]
    probs_full = torch.softmax(logits, dim=-1)
    top_probs, top_idx = router_probs(moe, logits)
    top_probs = top_probs * valid[:, None]  # pads contribute nothing

    e = moe.num_experts
    ffn = _expert_ffn
    if shard is not None and shard.shards.experts is not None:
        def ffn(cfg_, _m, xs):
            return _expert_parallel_ffn(cfg_, shard, xs)
    if ragged_dispatch_enabled(cfg):
        out = _ragged_moe(cfg, m, xt, top_probs, top_idx)
    elif moe.capacity_factor is None:
        # dense: every expert over every token, gate-weighted
        xs = xt[None].expand(e, t, h)
        expert_out = ffn(cfg, m, xs)                        # [E, T, H]
        gates = torch.zeros((t, e), dtype=torch.float32,
                            device=x.device).scatter_add(1, top_idx,
                                                         top_probs)
        out = torch.einsum("eth,te->th", expert_out.to(torch.float32), gates)
    else:
        n_tok = t if shard is None else shard.shards.n_tokens
        cap = max(1, int(moe.capacity_factor * n_tok * moe.top_k / e))
        # each (token, k)'s place in its expert's queue; pads take none
        onehot = F.one_hot(top_idx, e).to(torch.int32) \
            * valid.to(torch.int32)[:, None, None]          # [T, k, E]
        if shard is None:
            flat = onehot.reshape(t * moe.top_k, e)
            pos = (torch.cumsum(flat, dim=0) * flat - 1).reshape(
                t, moe.top_k, e)
        else:
            # per row: the row's own cumsum after the tokens before it
            rows = onehot.reshape(b, l * moe.top_k, e)
            shard.shards.register(shard.layer, shard.key, rows.sum(1))
            base = shard.shards.base(shard.layer, shard.key).to(
                x.device, torch.int32)
            pos = ((torch.cumsum(rows, dim=1) + base[:, None]) * rows
                   - 1).reshape(t, moe.top_k, e)
        within = (pos < cap) & (onehot > 0)
        # a (token, expert) pair holds at most one k slot, so k folds
        # away before the large products: [T, E, C]
        slots = torch.arange(cap, device=x.device)
        disp = within[..., None] & (pos[..., None] == slots)
        disp_tec = disp.sum(1).to(x.dtype)
        expert_in = torch.einsum("th,tec->ech", xt, disp_tec)
        expert_out = ffn(cfg, m, expert_in)                 # [E, C, H]
        combine = (disp.to(torch.float32)
                   * top_probs[:, :, None, None]).sum(1)    # [T, E, C]
        out = torch.einsum("ech,tec->th", expert_out.to(torch.float32),
                           combine)

    out = out.reshape(b, l, h).to(x.dtype)
    if shard is not None:
        if shard.j == 0:
            shard.shards.record(shard.layer, shard.key, router_stats(
                probs_full, top_idx, logits, valid, e))
        return out, {}
    losses = {}
    if moe.routing_type == "aux_loss" and moe.aux_loss_coeff:
        losses["moe_aux_loss"] = moe.aux_loss_coeff * load_balancing_loss(
            probs_full, top_idx, e, moe.top_k, valid=valid)
    if moe.z_loss_coeff:
        losses["moe_z_loss"] = moe.z_loss_coeff * z_loss(logits, valid=valid)
    return out, losses


def route_counts(cfg: TransformerConfig, m: Dict, x: torch.Tensor,
                 valid_mask: torch.Tensor) -> torch.Tensor:
    """[rows, E] int64: each row's valid (token, k) pairs per expert, the
    routing of ``moe_mlp_with_losses`` on the same inputs (no
    gradient)."""
    with torch.no_grad():
        b, l, h = x.shape
        logits = x.reshape(b * l, h).to(torch.float32) \
            @ m["router"].to(torch.float32)
        _, top_idx = router_probs(cfg.moe, logits)
        onehot = F.one_hot(top_idx, cfg.moe.num_experts) \
            * valid_mask.reshape(b * l, 1, 1).to(torch.int64)
        return onehot.reshape(b, -1, cfg.moe.num_experts).sum(1)
