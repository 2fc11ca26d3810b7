"""Attention over packed variable-length sequences.

- ``packed_attention``: prefill attention on ``[B, L]`` packed streams
  with segment ids (0 = padding; tokens attend within their own segment,
  causally).
- ``decode_attention``: one new token per stream against a padded,
  head-major KV cache.

Both choose by the tensors' device alone: a CPU tensor takes the plain
PyTorch version (``packed_attention_plain`` / ``decode_attention_xla_plain``,
fp32 scores, soft-cap and sliding window supported, differentiable by
autograd); a CUDA tensor takes the hand-written kernels
(``ops/flash_attention.py``: ``FlashAttentionFn``, whose backward is the
backward kernels; ``ops/decode_attention.py``) or raises.
"""

from typing import Optional

import torch

from realhf_tpu_torch.ops import decode_attention as _decode
from realhf_tpu_torch.ops.flash_attention import (
    NEG_INF,
    FlashAttentionFn,
    segment_mask,
)


def member_heads(n_q_heads: int, n_kv_heads: int, t: int, j: int = 0):
    """((first, end) query head, (first, end) KV head) of model member
    ``j`` of ``t``: the counterpart of the JAX package's
    ``make_sharded_attention`` (``ops/attention.py:118``), whose members
    run the kernel on their own contiguous heads. When ``t`` divides the
    KV heads each member holds ``nkv / t`` of them; otherwise the KV
    weights are replicated over the model members (``kv_replicated``)
    and member j computes the one KV head its ``nq / t`` query heads
    read, which needs ``nkv`` to divide ``t`` (else a member's query
    heads would read parts of two KV heads' groups)."""
    if n_q_heads % t:
        raise ValueError(f"t={t} does not divide the {n_q_heads} query "
                         "heads.")
    nq = n_q_heads // t
    q = (j * nq, (j + 1) * nq)
    if n_kv_heads % t == 0:
        per = n_kv_heads // t
        return q, (j * per, (j + 1) * per)
    if t % n_kv_heads:
        raise ValueError(
            f"t={t} neither divides the {n_kv_heads} KV heads nor is a "
            "multiple of them: a model member's query heads would read "
            "parts of two KV heads' groups.")
    h = j // (t // n_kv_heads)
    return q, (h, h + 1)


def kv_replicated(n_kv_heads: int, t: int) -> bool:
    """Whether a layout of ``t`` model members holds the KV weights whole
    on every member (``t`` does not divide the KV heads)."""
    return t > 1 and n_kv_heads % t != 0


def packed_attention_plain(q, k, v, seg_ids, *, causal: bool = True,
                           scale: Optional[float] = None,
                           logits_soft_cap: Optional[float] = None,
                           sliding_window: Optional[int] = None):
    """O(L^2) scores in fp32, query heads grouped over their KV head."""
    b, l, nq, hd = q.shape
    nkv = k.shape[2]
    group = nq // nkv
    scale = float(scale) if scale is not None else hd ** -0.5
    qg = q.reshape(b, l, nkv, group, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    if logits_soft_cap is not None:
        scores = logits_soft_cap * torch.tanh(scores / logits_soft_cap)
    mask = segment_mask(seg_ids, seg_ids, causal,
                        sliding_window)[:, None, None]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd",
                       probs.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(b, l, nq, hd).to(q.dtype)


def packed_attention(q, k, v, seg_ids, *, causal: bool = True,
                     scale: Optional[float] = None,
                     logits_soft_cap: Optional[float] = None,
                     sliding_window: Optional[int] = None):
    if not q.is_cuda:
        return packed_attention_plain(q, k, v, seg_ids, causal=causal,
                                      scale=scale,
                                      logits_soft_cap=logits_soft_cap,
                                      sliding_window=sliding_window)
    if logits_soft_cap is not None:
        raise NotImplementedError(
            "soft-cap prefill attention on the GPU is not ported: no model "
            "configuration of either package passes it (ROADMAP.md, queue "
            "1, item 3).")
    return FlashAttentionFn.apply(q, k, v, seg_ids, causal, scale,
                                  sliding_window)


def _no_soft_cap_on_gpu(logits_soft_cap):
    if logits_soft_cap is not None:
        raise NotImplementedError(
            "logits soft-cap in decode attention on the GPU is not ported: "
            "no model configuration of either package passes it "
            "(ROADMAP.md, queue 1, item 3).")


def decode_attention_xla_plain(q, k_cache, v_cache, valid_mask, *,
                               scale=None, logits_soft_cap=None,
                               sliding_window=None, slot=None):
    """Plain decode attention with a plain softmax (so an empty stream
    averages its slots, as the reference path does) and soft-cap."""
    b, nq, hd = q.shape
    nkv = k_cache.shape[1]
    group = nq // nkv
    scale = float(scale) if scale is not None else hd ** -0.5
    qg = q.reshape(b, nkv, group, hd)
    scores = torch.einsum("bhgd,bhkd->bhgk", qg.to(torch.float32),
                          k_cache.to(torch.float32)) * scale
    if logits_soft_cap is not None:
        scores = logits_soft_cap * torch.tanh(scores / logits_soft_cap)
    keep = _decode.window_keep(valid_mask, sliding_window, slot) > 0
    scores = torch.where(keep[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd",
                       probs.to(v_cache.dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    return out.reshape(b, nq, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, valid_mask, *,
                     scale: Optional[float] = None,
                     logits_soft_cap: Optional[float] = None,
                     sliding_window: Optional[int] = None,
                     slot: Optional[torch.Tensor] = None):
    """q [B, nq, hd] against [B, nkv, S, hd] caches; the caller has
    already written the new token's K/V and marked its slot valid."""
    if not q.is_cuda:
        return decode_attention_xla_plain(
            q, k_cache, v_cache, valid_mask, scale=scale,
            logits_soft_cap=logits_soft_cap, sliding_window=sliding_window,
            slot=slot)
    _no_soft_cap_on_gpu(logits_soft_cap)
    return _decode.flash_decode_attention(
        q, k_cache, v_cache, valid_mask, scale=scale,
        sliding_window=sliding_window, slot=slot)


def stacked_decode_attention(q, k_all, v_all, valid_mask, layer_index: int,
                             *, scale: Optional[float] = None,
                             logits_soft_cap: Optional[float] = None,
                             sliding_window: Optional[int] = None,
                             slot: Optional[torch.Tensor] = None):
    """``decode_attention`` on layer ``layer_index`` of the stacked
    [nl, B, nkv, S, hd] caches."""
    if not q.is_cuda:
        return decode_attention_xla_plain(
            q, k_all[layer_index], v_all[layer_index], valid_mask,
            scale=scale, logits_soft_cap=logits_soft_cap,
            sliding_window=sliding_window, slot=slot)
    _no_soft_cap_on_gpu(logits_soft_cap)
    return _decode.flash_decode_attention_stacked(
        q, k_all, v_all, valid_mask, layer_index, scale=scale,
        sliding_window=sliding_window, slot=slot)
