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

The kernel walks each (stream, KV head) in one CTA of ``WARPS`` warps.
``decode_split_plan`` states in PyTorch which 64-slot tiles it walks
(those that hold a kept slot), ``warp_slots`` the slots of them each
warp takes, and ``decode_attention_split_plain`` computes the kernel's
function that way: a partial softmax per warp and the flash merge of
the parts.
"""

import ctypes
from typing import Optional

import torch

from realhf_tpu_torch.ops import _build

NEG_INF = -2.0 ** 30
#: cache slots per tile of the kernel's walk
TILE = 64
#: warps of the kernel's CTA; warp w takes slots [16 w, 16 w + 16) of
#: every walked tile
WARPS = 4

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


def decode_split_plan(keep):
    """The tiles the kernel walks: for every stream, the indices of the
    tiles that hold a kept slot (``keep > 0``), in order (tile t holds
    slots [64 t, 64 t + 64)). An empty stream walks nothing."""
    keep = torch.as_tensor(keep) > 0
    b, s = keep.shape
    n_tiles = -(-s // TILE)
    padded = torch.zeros((b, n_tiles * TILE), dtype=torch.bool)
    padded[:, :s] = keep.cpu()
    marked = padded.view(b, n_tiles, TILE).any(-1)
    return [row.nonzero().flatten().tolist() for row in marked]


def warp_slots(tiles, warp: int, s: int) -> torch.Tensor:
    """The cache slots warp ``warp`` walks over ``tiles``: its 16 of
    each, [64 t + 16 warp, 64 t + 16 warp + 16), cut at S."""
    ws = TILE // WARPS
    idx = [torch.arange(lo, max(lo, min(lo + ws, s)))
           for lo in (t * TILE + warp * ws for t in tiles)]
    return torch.cat(idx) if idx else torch.zeros(0, dtype=torch.long)


def decode_attention_split_plain(q, k_cache, v_cache, keep, *,
                                 scale: Optional[float] = None,
                                 return_stats: bool = False,
                                 drop_warp: int = -1):
    """``decode_attention_plain`` computed the kernel's way: each warp
    takes a softmax over its ``warp_slots`` of the ``decode_split_plan``
    tiles (masked slots NEG_INF), and the parts merge as m = max m_i,
    l = sum l_i exp(m_i - m), out = sum acc_i exp(m_i - m) / l. An empty
    stream gives 0, m = NEG_INF and l = S, as every masked slot of the
    reference scores NEG_INF. ``drop_warp`` >= 0 leaves that warp's part
    out of the merge, as the kernel's planted fault does."""
    b, nq, hd = q.shape
    nkv, s = k_cache.shape[1], k_cache.shape[2]
    group = nq // nkv
    scale = float(scale) if scale is not None else hd ** -0.5
    qg = q.to(torch.float32).reshape(b, nkv, group, hd) * scale
    out = torch.zeros((b, nkv, group, hd), dtype=torch.float32)
    m = torch.full((b, nkv, group), NEG_INF, dtype=torch.float32)
    l = torch.full((b, nkv, group), float(s), dtype=torch.float32)
    for bi, tiles in enumerate(decode_split_plan(keep)):
        if not tiles:
            continue
        parts = []
        for w in range(WARPS):
            idx = warp_slots(tiles, w, s)
            if w == drop_warp or not len(idx):
                continue
            sc = torch.einsum("hgd,hkd->hgk", qg[bi],
                              k_cache[bi][:, idx].to(torch.float32))
            sc = torch.where(keep[bi, idx] > 0, sc, NEG_INF)
            m_i = sc.amax(-1)
            p = torch.exp(sc - m_i[..., None])
            acc = torch.einsum("hgk,hkd->hgd",
                               p.to(v_cache.dtype).to(torch.float32),
                               v_cache[bi][:, idx].to(torch.float32))
            parts.append((m_i, p.sum(-1), acc))
        if not parts:
            continue
        m_b = torch.stack([pt[0] for pt in parts]).amax(0)
        w = [torch.exp(pt[0] - m_b) for pt in parts]
        l_b = sum(pt[1] * wi for pt, wi in zip(parts, w))
        acc = sum(pt[2] * wi[..., None] for pt, wi in zip(parts, w))
        safe_l = torch.where(l_b > 0, l_b, torch.ones_like(l_b))
        out[bi] = torch.where((m_b > NEG_INF / 2)[..., None],
                              acc / safe_l[..., None], 0.0)
        m[bi], l[bi] = m_b, l_b
    out = out.reshape(b, nq, hd).to(q.dtype)
    if return_stats:
        return out, m.reshape(b, nq), l.reshape(b, nq)
    return out


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library("flash_decode").flash_decode_bf16
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, i, p, p, p, i, i, i, i, i, ll, ll, ll,
                       ctypes.c_float, i, p]
        fn.restype = i
        _fn = fn
    return _fn


def _launch(q, k_layer, v_layer, valid, sliding_window, slot, scale,
            return_stats, drop_warp=-1):
    """Launch on per-layer cache views [B, nkv, S, hd] (possibly views
    into a stacked cache): pointer plus strides, no copy. The kernel
    reads the [B, S] bool mask and applies the window from ``slot``
    itself. ``drop_warp`` >= 0 leaves that warp's partial out of the
    merge (a planted fault for checks; no entry sets it)."""
    b, nq, hd = q.shape
    nkv, s = k_layer.shape[1], k_layer.shape[2]
    dev = q.device
    if k_layer.stride() != v_layer.stride() or k_layer.shape != v_layer.shape:
        raise ValueError("k and v caches must share shape and strides")
    if valid.dtype != torch.bool:
        valid = valid != 0
    if not valid.is_contiguous():
        valid = valid.contiguous()
    window = 0
    if sliding_window is not None:
        window = int(sliding_window)
        if slot is None:
            raise ValueError("sliding_window decode needs slot indices")
        if window < 1:
            raise ValueError(f"sliding_window must be >= 1, got {window}")
        if slot.dtype != torch.int32 or not slot.is_contiguous():
            slot = slot.to(torch.int32).contiguous()
        if tuple(slot.shape) != (b,) or not slot.is_cuda or slot.device != dev:
            raise ValueError(f"slot must be [{b}] on {dev}, got "
                             f"{tuple(slot.shape)} on {slot.device}")
    for name, t in (("q", q), ("k_cache", k_layer), ("v_cache", v_layer),
                    ("valid_mask", valid)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"flash_decode: {name} must be on {dev}")
    for name, t in (("q", q), ("k_cache", k_layer), ("v_cache", v_layer)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_decode kernel takes bf16 {name}, "
                            f"got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} must be 16-byte aligned")
    sb, sh, ss, sd = k_layer.stride()
    if sd != 1 or ss % 8 or sh % 8 or sb % 8:
        raise ValueError("flash_decode: cache rows must be contiguous and "
                         f"strides multiples of 8 elements, got "
                         f"{k_layer.stride()}")
    if not q.is_contiguous():
        raise ValueError("flash_decode: q must be contiguous")
    if tuple(valid.shape) != (b, s):
        raise ValueError(f"valid_mask must be [{b}, {s}], got "
                         f"{tuple(valid.shape)}")
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
        m = torch.empty((b, nq), dtype=torch.float32, device=dev)
        l = torch.empty((b, nq), dtype=torch.float32, device=dev)
    code = _kernel()(q.data_ptr(), k_layer.data_ptr(), v_layer.data_ptr(),
                     valid.data_ptr(),
                     slot.data_ptr() if window else None, window,
                     out.data_ptr(), None if m is None else m.data_ptr(),
                     None if l is None else l.data_ptr(),
                     b, nq, nkv, s, hd, sb, sh, ss, scale, drop_warp,
                     _stream(dev))
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
    if not q.is_cuda:
        keep = window_keep(valid_mask, sliding_window, slot)
        return decode_attention_plain(q, k_cache, v_cache, keep,
                                      scale=scale, return_stats=return_stats)
    res = _launch(q, k_cache, v_cache, valid_mask, sliding_window, slot,
                  scale, return_stats)
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
    layer_index = int(layer_index)
    if not 0 <= layer_index < k_all.shape[0]:
        raise IndexError(f"layer_index {layer_index} outside "
                         f"[0, {k_all.shape[0]})")
    if not q.is_cuda:
        keep = window_keep(valid_mask, sliding_window, slot)
        return decode_attention_plain(q, k_all[layer_index],
                                      v_all[layer_index], keep, scale=scale,
                                      return_stats=return_stats)
    res = _launch(q, k_all[layer_index], v_all[layer_index], valid_mask,
                  sliding_window, slot, scale, return_stats)
    global stacked_launches
    stacked_launches += 1
    return res
