"""Tensor ops over packed ``[S, L]`` streams: next-token log-probs and
entropy from final hidden states, masked mean and normalization.

The two that apply the LM head work in chunks along L: each chunk's
``[S, chunk, V]`` fp32 logits live only inside that chunk's call, and
under autograd the chunk is checkpointed (only its hidden states are
kept; the backward recomputes its logits), so the full ``[S, L, V]``
tensor never exists in the forward or the backward.
"""

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import TransformerConfig


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
    s = hidden.shape[0]
    zeros = torch.zeros((s, 1), dtype=input_ids.dtype,
                        device=input_ids.device)
    labels = torch.cat([input_ids[:, 1:], zeros], dim=1).long()
    valid = torch.cat([(seg_ids[:, 1:] == seg_ids[:, :-1])
                       & (seg_ids[:, 1:] != 0), zeros.bool()], dim=1)
    lp = _chunked(_chunk_logprobs, hidden, chunk, labels, logits_mask,
                  fixed=(cfg, params, temperature))
    return torch.where(valid, lp, 0.0)


def entropy_from_hidden(cfg: TransformerConfig, params,
                        hidden: torch.Tensor, *, chunk: int = 1024,
                        temperature: float = 1.0) -> torch.Tensor:
    """Per-position policy entropy [S, L] fp32, chunked like
    ``shifted_logprobs_from_hidden``."""
    return _chunked(_chunk_entropy, hidden, chunk,
                    fixed=(cfg, params, temperature))


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
