"""Flash-decode attention against a head-major KV cache.

One query token per stream attends over its cache slots. Two entries,
one CUDA kernel (``csrc/flash_decode.cu``):

- ``flash_decode_attention``: a per-layer cache [B, nkv, S, hd];
- ``flash_decode_attention_stacked``: layer ``layer_index`` of the
  stacked cache [nl, B, nkv, S, hd], launched at that layer's offset
  (no copy of the layer).

CUDA tensors launch the kernel or raise; CPU tensors run
``decode_attention_plain``, the same function in plain PyTorch. Slot s
of stream b is kept iff valid[b, s] and, with a sliding window,
slot[b] - s < window. A stream with no kept slot gets 0.
"""

import ctypes
from typing import Optional

import torch

from realhf_tpu_torch.ops import _build

NEG_INF = -2.0 ** 30

#: launches of the per-layer entry and of the stacked-cache entry
#: (reset them to 0 to count the launches of one run)
launches = 0
stacked_launches = 0
_fn = None


def window_keep(valid_mask: torch.Tensor, sliding_window: Optional[int],
                slot: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, S] int32 keep mask: valid AND inside the sliding window
    (slots in ``(slot - window, slot]``)."""
    keep = valid_mask
    if sliding_window is not None:
        if slot is None:
            raise ValueError("sliding_window decode needs slot indices")
        s = valid_mask.shape[1]
        idx = torch.arange(s, dtype=torch.int32,
                           device=valid_mask.device)[None, :]
        keep = keep & ((slot[:, None] - idx) < sliding_window)
    return keep.to(torch.int32)


def decode_attention_plain(q, k_cache, v_cache, keep, *,
                           scale: Optional[float] = None,
                           return_stats: bool = False):
    """The kernel's function in plain PyTorch. ``keep`` is the [B, S]
    int mask of ``window_keep``. Returns out [B, nq, hd] (q's dtype)
    and, with ``return_stats``, the fp32 softmax max and normaliser
    m, l [B, nq]."""
    b, nq, hd = q.shape
    nkv = k_cache.shape[1]
    group = nq // nkv
    scale = float(scale) if scale is not None else hd ** -0.5
    qg = q.to(torch.float32).reshape(b, nkv, group, hd) * scale
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.to(torch.float32))
    s = torch.where((keep > 0)[:, None, None, :], s, NEG_INF)
    m = s.amax(-1)                                  # [B, nkv, g]
    p = torch.exp(s - m[..., None])
    lsum = p.sum(-1)
    acc = torch.einsum("bhgk,bhkd->bhgd",
                       p.to(v_cache.dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    valid = m > NEG_INF / 2
    safe_l = torch.where(lsum > 0, lsum, torch.ones_like(lsum))
    out = torch.where(valid[..., None], acc / safe_l[..., None], 0.0)
    out = out.reshape(b, nq, hd).to(q.dtype)
    if return_stats:
        return out, m.reshape(b, nq), lsum.reshape(b, nq)
    return out


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library("flash_decode").flash_decode_bf16
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, ll, ll, ll,
                       ctypes.c_float, p]
        fn.restype = i
        _fn = fn
    return _fn


def _launch(q, k_layer, v_layer, keep, scale, return_stats):
    """Launch on per-layer cache views [B, nkv, S, hd] (possibly views
    into a stacked cache): pointer plus strides, no copy."""
    b, nq, hd = q.shape
    nkv, s = k_layer.shape[1], k_layer.shape[2]
    if k_layer.stride() != v_layer.stride() or k_layer.shape != v_layer.shape:
        raise ValueError("k and v caches must share shape and strides")
    for name, t in (("q", q), ("k_cache", k_layer), ("v_cache", v_layer),
                    ("keep", keep)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_decode: {name} must be on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} must be 16-byte aligned")
    for name, t in (("q", q), ("k_cache", k_layer), ("v_cache", v_layer)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_decode kernel takes bf16 {name}, "
                            f"got {t.dtype}")
    sb, sh, ss, sd = k_layer.stride()
    if sd != 1 or ss % 8 or sh % 8 or sb % 8:
        raise ValueError("flash_decode: cache rows must be contiguous and "
                         f"strides multiples of 8 elements, got "
                         f"{k_layer.stride()}")
    if not q.is_contiguous() or not keep.is_contiguous():
        raise ValueError("flash_decode: q and keep must be contiguous")
    if keep.dtype != torch.int32 or tuple(keep.shape) != (b, s):
        raise ValueError(f"keep must be int32 [{b}, {s}], got "
                         f"{keep.dtype} {tuple(keep.shape)}")
    if k_layer.shape[0] != b or k_layer.shape[3] != hd or nq % nkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, cache "
                         f"{tuple(k_layer.shape)}")
    if hd not in (64, 128) or nq // nkv > 16:
        raise ValueError("flash_decode kernel supports hd 64 or 128 and at "
                         f"most 16 query heads per KV head, got hd {hd}, "
                         f"group {nq // nkv}")
    out = torch.empty_like(q)
    m = l = None
    if return_stats:
        m = torch.empty((b, nq), dtype=torch.float32, device=q.device)
        l = torch.empty((b, nq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _kernel()(q.data_ptr(), k_layer.data_ptr(), v_layer.data_ptr(),
                     keep.data_ptr(), out.data_ptr(),
                     None if m is None else m.data_ptr(),
                     None if l is None else l.data_ptr(),
                     b, nq, nkv, s, hd, sb, sh, ss, scale, stream)
    _build.check(code, "flash_decode")
    return (out, m, l) if return_stats else out


def flash_decode_attention(q, k_cache, v_cache, valid_mask, *,
                           scale: Optional[float] = None,
                           sliding_window: Optional[int] = None,
                           slot: Optional[torch.Tensor] = None,
                           return_stats: bool = False):
    """q [B, nq, hd] against a per-layer cache [B, nkv, S, hd] with
    valid_mask [B, S] bool."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    keep = window_keep(valid_mask, sliding_window, slot)
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, keep,
                                      scale=scale, return_stats=return_stats)
    res = _launch(q, k_cache, v_cache, keep, scale, return_stats)
    global launches
    launches += 1
    return res


def flash_decode_attention_stacked(q, k_all, v_all, valid_mask,
                                   layer_index: int, *,
                                   scale: Optional[float] = None,
                                   sliding_window: Optional[int] = None,
                                   slot: Optional[torch.Tensor] = None,
                                   return_stats: bool = False):
    """Same math on layer ``layer_index`` of the stacked cache
    [nl, B, nkv, S, hd]; the kernel reads that layer in place."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    keep = window_keep(valid_mask, sliding_window, slot)
    layer_index = int(layer_index)
    if not 0 <= layer_index < k_all.shape[0]:
        raise IndexError(f"layer_index {layer_index} outside "
                         f"[0, {k_all.shape[0]})")
    if not q.is_cuda:
        return decode_attention_plain(q, k_all[layer_index],
                                      v_all[layer_index], keep, scale=scale,
                                      return_stats=return_stats)
    res = _launch(q, k_all[layer_index], v_all[layer_index], keep, scale,
                  return_stats)
    global stacked_launches
    stacked_launches += 1
    return res
