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
"""

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from realhf_tpu_torch.models.config import MoEConfig, TransformerConfig

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


def moe_mlp_with_losses(cfg: TransformerConfig, m: Dict, x: torch.Tensor,
                        valid_mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MoE feed-forward over [B, L, H] -> (output [B, L, H] in x's dtype,
    aux losses). ``valid_mask`` [B, L] keeps padding tokens out of the
    routing, the expert capacity and the aux losses (their gates are 0)."""
    moe = cfg.moe
    if moe.expert_parallel:
        raise NotImplementedError(
            "expert parallelism is deferred to the parallelism slice of "
            "the port: ROADMAP.md, queue 1, item 4.")
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
    if ragged_dispatch_enabled(cfg):
        out = _ragged_moe(cfg, m, xt, top_probs, top_idx)
    elif moe.capacity_factor is None:
        # dense: every expert over every token, gate-weighted
        xs = xt[None].expand(e, t, h)
        expert_out = _expert_ffn(cfg, m, xs)                # [E, T, H]
        gates = torch.zeros((t, e), dtype=torch.float32,
                            device=x.device).scatter_add(1, top_idx,
                                                         top_probs)
        out = torch.einsum("eth,te->th", expert_out.to(torch.float32), gates)
    else:
        cap = max(1, int(moe.capacity_factor * t * moe.top_k / e))
        # each (token, k)'s place in its expert's queue; pads take none
        onehot = F.one_hot(top_idx, e).to(torch.int32) \
            * valid.to(torch.int32)[:, None, None]          # [T, k, E]
        flat = onehot.reshape(t * moe.top_k, e)
        pos = (torch.cumsum(flat, dim=0) * flat - 1).reshape(t, moe.top_k, e)
        within = (pos < cap) & (onehot > 0)
        # a (token, expert) pair holds at most one k slot, so k folds
        # away before the large products: [T, E, C]
        slots = torch.arange(cap, device=x.device)
        disp = within[..., None] & (pos[..., None] == slots)
        disp_tec = disp.sum(1).to(x.dtype)
        expert_in = torch.einsum("th,tec->ech", xt, disp_tec)
        expert_out = _expert_ffn(cfg, m, expert_in)         # [E, C, H]
        combine = (disp.to(torch.float32)
                   * top_probs[:, :, None, None]).sum(1)    # [T, E, C]
        out = torch.einsum("ech,tec->th", expert_out.to(torch.float32),
                           combine)

    losses = {}
    if moe.routing_type == "aux_loss" and moe.aux_loss_coeff:
        losses["moe_aux_loss"] = moe.aux_loss_coeff * load_balancing_loss(
            probs_full, top_idx, e, moe.top_k, valid=valid)
    if moe.z_loss_coeff:
        losses["moe_z_loss"] = moe.z_loss_coeff * z_loss(logits, valid=valid)
    return out.reshape(b, l, h).to(x.dtype), losses
