"""Tensor ops over packed ``[S, L]`` streams: next-token log-probs and
entropy from final hidden states, masked mean and normalization.

The two that apply the LM head work in chunks along L: each chunk's
``[S, chunk, V]`` fp32 logits live only inside that chunk's call, and
under autograd the chunk is checkpointed (only its hidden states are
kept; the backward recomputes its logits), so the full ``[S, L, V]``
tensor never exists in the forward or the backward.

Given a model's ``MemberParams`` and the ``MemberHidden`` its forward
returned, the log-probs and the entropy run per data group and come
back as one ``[S, L]`` tensor on the first member's device. A group of
``t > 1`` model members is vocabulary-parallel: each member takes its
head shard's logits, and the row max, the sum of exponentials and the
label's logit are each reduced over the group. Padded vocabulary
columns (the last member's, when ``t`` does not divide the vocabulary)
and columns the logits mask forbids read -1e30, so they add nothing to
a sum and never win a max.
"""

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.models.sharding import MemberParams
from realhf_tpu_torch.parallel import collectives as C

_MASKED = -1e30


def _head_log_softmax(cfg, params, hidden, temperature, logits_mask):
    logits = T.lm_logits(cfg, params, hidden)
    if temperature != 1.0:
        logits = logits / temperature
    if logits_mask is not None:
        logits = torch.where(logits_mask, logits, -1e30)
    return torch.log_softmax(logits, dim=-1)


def _chunk_logprobs(cfg, params, temperature, hidden, labels, logits_mask):
    logp = _head_log_softmax(cfg, params, hidden, temperature, logits_mask)
    return logp.gather(-1, labels[..., None])[..., 0]


def _chunk_entropy(cfg, params, temperature, hidden):
    logp = _head_log_softmax(cfg, params, hidden, temperature, None)
    return -(logp.exp() * logp).sum(-1)


def _chunked(fn, hidden, chunk, *per_chunk, fixed=()):
    """``fn(*fixed, hidden[:, c], *(a[:, c] for a in per_chunk))`` over L
    chunks, concatenated; each chunk checkpointed under autograd."""
    remat = torch.is_grad_enabled()
    outs = []
    for c0 in range(0, hidden.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        args = (*fixed, hidden[:, sl],
                *(a[:, sl] if a is not None else None for a in per_chunk))
        outs.append(checkpoint(fn, *args, use_reentrant=False) if remat
                    else fn(*args))
    return torch.cat(outs, dim=1)


def next_token_labels(input_ids: torch.Tensor, seg_ids: torch.Tensor):
    """(labels, valid) [S, L]: the token at t + 1 and whether it
    continues t's segment (not padding, not another segment's start).
    Taken over whole streams: a context-parallel shard's last token
    needs the next shard's first."""
    s = input_ids.shape[0]
    zeros = torch.zeros((s, 1), dtype=input_ids.dtype,
                        device=input_ids.device)
    labels = torch.cat([input_ids[:, 1:], zeros], dim=1).long()
    valid = torch.cat([(seg_ids[:, 1:] == seg_ids[:, :-1])
                       & (seg_ids[:, 1:] != 0), zeros.bool()], dim=1)
    return labels, valid


def logprobs_from_hidden(
    cfg: TransformerConfig,
    params,
    hidden: torch.Tensor,       # [S, L, H] final hidden states
    labels: torch.Tensor,       # [S, L] the token each position predicts
    valid: torch.Tensor,        # [S, L] bool
    *,
    chunk: int = 1024,
    temperature: float = 1.0,
    logits_mask: Optional[torch.Tensor] = None,  # [S, L, V] bool, True=allowed
) -> torch.Tensor:
    """log p(labels[t] | ...) at every position t, 0 where not ``valid``:
    [S, L] fp32."""
    if isinstance(params, MemberParams):
        return _member_rows(cfg, params, hidden, chunk, temperature, labels,
                            valid, logits_mask)
    lp = _chunked(_chunk_logprobs, hidden, chunk, labels, logits_mask,
                  fixed=(cfg, params, temperature))
    return torch.where(valid, lp, 0.0)


def shifted_logprobs_from_hidden(
    cfg: TransformerConfig,
    params,
    hidden: torch.Tensor,       # [S, L, H] final hidden states
    input_ids: torch.Tensor,    # [S, L]
    seg_ids: torch.Tensor,      # [S, L]
    *,
    chunk: int = 1024,
    temperature: float = 1.0,
    logits_mask: Optional[torch.Tensor] = None,  # [S, L, V] bool, True=allowed
) -> torch.Tensor:
    """log p(input_ids[t+1] | ...) at every position t, 0 where t+1
    starts another segment or is padding: [S, L] fp32."""
    labels, valid = next_token_labels(input_ids, seg_ids)
    return logprobs_from_hidden(cfg, params, hidden, labels, valid,
                                chunk=chunk, temperature=temperature,
                                logits_mask=logits_mask)


def entropy_from_hidden(cfg: TransformerConfig, params,
                        hidden: torch.Tensor, *, chunk: int = 1024,
                        temperature: float = 1.0) -> torch.Tensor:
    """Per-position policy entropy [S, L] fp32, chunked like
    ``shifted_logprobs_from_hidden``."""
    if isinstance(params, MemberParams):
        return _member_rows(cfg, params, hidden, chunk, temperature)
    return _chunked(_chunk_entropy, hidden, chunk,
                    fixed=(cfg, params, temperature))


def _member_logits(cfg, tree, h, s0, temperature, logits_mask):
    """One model member's head shard over a chunk: fp32 logits [B, c,
    V/t], -1e30 on padded columns and on columns the mask forbids."""
    lg = T._matmul_f32(h, T.head_weight(cfg, tree))
    if temperature != 1.0:
        lg = lg / temperature
    keep = s0 + torch.arange(lg.shape[-1], device=lg.device) < cfg.vocab_size
    if logits_mask is not None:
        m = logits_mask[..., s0:s0 + lg.shape[-1]].to(lg.device)
        m = torch.cat([m, m.new_zeros(*m.shape[:-1],
                                      lg.shape[-1] - m.shape[-1])], -1)
        keep = keep & m
    return torch.where(keep, lg, _MASKED)


def _member_sums(cfg, tree, h, s0, temperature, logits_mask, mx, labels):
    """One member's share of a chunk given the group's row max ``mx``:
    (sum of exp(logit - mx), and the label's logit where the label lies
    in this shard, else 0) with ``labels``; without, (the sum, and the
    sum of exp(logit - mx) * logit) for the entropy."""
    lg = _member_logits(cfg, tree, h, s0, temperature, logits_mask)
    e = (lg - mx[..., None]).exp()
    if labels is None:
        return e.sum(-1), (e * lg).sum(-1)
    loc = labels.to(lg.device) - s0
    inside = (loc >= 0) & (loc < lg.shape[-1])
    got = lg.gather(-1, loc.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
    return e.sum(-1), torch.where(inside, got, torch.zeros_like(got))


def _vocab_parallel(cfg, trees, devs, starts, temperature, hs, labels=None,
                    logits_mask=None, remat=False):
    """One L chunk of a model group: log-probs of ``labels`` (given) or
    the entropy, [B, c] fp32 on the first member's device. The row max
    comes from a pass without gradient (the log-sum-exp's gradient does
    not depend on it); then each member's sums, checkpointed on its own
    under ``remat`` (a recompute spanning cards would race between the
    autograd engine's device threads), are reduced over the group."""
    with torch.no_grad():
        mx = C.all_reduce_max(
            [_member_logits(cfg, tr, h, s0, temperature, logits_mask)
             .amax(-1) for tr, h, s0 in zip(trees, hs, starts)], devs)
    run = ((lambda *a: checkpoint(_member_sums, *a, use_reentrant=False))
           if remat else _member_sums)
    sums, others = zip(*(run(cfg, tr, h, s0, temperature, logits_mask, m,
                             labels)
                         for tr, h, s0, m in zip(trees, hs, starts, mx)))
    lse = mx[0] + C.reduce_sum(sums, devs[0]).log()
    other = C.reduce_sum(others, devs[0])
    if labels is None:
        return lse - other / C.reduce_sum(sums, devs[0])
    return other - lse


def _member_rows(cfg, mp: MemberParams, hidden, chunk, temperature,
                 labels=None, valid=None, logits_mask=None):
    """Log-probs (``labels`` given) or entropy of a ``MemberHidden``,
    per data group, as one [S, L] tensor on the first member's
    device."""
    starts = mp.vocab_starts(cfg)
    remat = torch.is_grad_enabled()
    out = []
    for g, (hs, (r0, r1)) in enumerate(zip(hidden.hs, hidden.rows)):
        if hs is None:
            continue
        trees, devs = mp.group(g)
        lab = None if labels is None else labels[r0:r1]
        msk = None if logits_mask is None else logits_mask[r0:r1]
        if mp.t == 1:
            dev = devs[0]
            if lab is None:
                res = entropy_from_hidden(cfg, trees[0], hs[0], chunk=chunk,
                                          temperature=temperature)
            else:
                res = logprobs_from_hidden(
                    cfg, trees[0], hs[0], lab.to(dev), valid[r0:r1].to(dev),
                    chunk=chunk, temperature=temperature,
                    logits_mask=None if msk is None else msk.to(dev))
            out.append(res.to(mp.devices[0]))
            continue
        parts = []
        for c0 in range(0, hs[0].shape[1], chunk):
            sl = slice(c0, c0 + chunk)
            parts.append(_vocab_parallel(
                cfg, trees, devs, starts, temperature,
                [h[:, sl] for h in hs], None if lab is None else lab[:, sl],
                None if msk is None else msk[:, sl], remat))
        res = torch.cat(parts, dim=1).to(mp.devices[0])
        if valid is not None:
            res = torch.where(valid[r0:r1].to(res.device), res, 0.0)
        out.append(res)
    return torch.cat(out, dim=0)


def masked_normalization(x: torch.Tensor,
                         mask: Optional[torch.Tensor] = None, *,
                         unbiased: bool = False, eps: float = 1e-5,
                         high_precision: bool = True) -> torch.Tensor:
    """x normalized to zero mean and unit std over the masked entries
    (0 elsewhere); the statistics in float64 when ``high_precision``,
    else float32. Returned in x's dtype."""
    dtype = torch.float64 if high_precision else torch.float32
    xf = x.to(dtype)
    if mask is None:
        factor = torch.tensor(float(x.numel()), dtype=dtype,
                              device=x.device)
        mean = xf.sum() / factor
        mean_sq = (xf ** 2).sum() / factor
    else:
        m = mask.to(dtype)
        factor = m.sum()
        mean = (xf * m).sum() / factor
        mean_sq = (xf ** 2 * m).sum() / factor
    var = mean_sq - mean ** 2
    if unbiased:
        var = var * factor / (factor - 1)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if mask is not None:
        out = out * m
    return out.to(x.dtype)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over the masked entries (0 when none is), fp32."""
    m = mask.to(torch.float32)
    return (x.to(torch.float32) * m).sum() / m.sum().clamp_min(1.0)
