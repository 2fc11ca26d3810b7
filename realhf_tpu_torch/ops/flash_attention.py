"""Flash-attention forward over packed segments.

``flash_attention`` launches the CUDA kernel ``csrc/flash_fwd.cu`` on a
CUDA tensor and runs ``flash_attention_plain``, the same function in
plain PyTorch, on a CPU tensor. Both return o and the per-row
log-sum-exp; a row that sees no valid key gets o = 0 and lse = NEG_INF.

Layouts: q [B, L, nq, hd], k/v [B, L, nkv, hd], seg_ids [B, L] (0 =
padding); o like q; lse [B, nq, L] fp32.
"""

import ctypes
from typing import Optional, Tuple

import torch

from realhf_tpu_torch.ops import _build

NEG_INF = -2.0 ** 30

#: kernel launches made by ``flash_attention`` (reset it to 0 to count
#: the launches of one run)
launches = 0
_fn = None


def segment_mask(seg_q: torch.Tensor, seg_k: torch.Tensor, causal: bool,
                 sliding_window: Optional[int] = None) -> torch.Tensor:
    """[B, Lq, Lk] bool: same non-zero segment (+ causality, + optional
    sliding window). Positions inside a segment are contiguous, so the
    stream-index difference is the in-segment position difference."""
    mask = (seg_q[:, :, None] == seg_k[:, None, :]) & (seg_q[:, :, None] != 0)
    lq, lk = seg_q.shape[1], seg_k.shape[1]
    idx_q = torch.arange(lq, device=seg_q.device)[:, None]
    idx_k = torch.arange(lk, device=seg_q.device)[None, :]
    if causal:
        mask = mask & (idx_q >= idx_k)[None]
    if sliding_window is not None:
        mask = mask & ((idx_q - idx_k) < sliding_window)[None]
    return mask


def flash_attention_plain(q, k, v, seg_ids, *, causal: bool = True,
                          scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch (fp32 scores)."""
    b, l, nq, hd = q.shape
    nkv = k.shape[2]
    group = nq // nkv
    scale = float(scale) if scale is not None else hd ** -0.5
    qg = q.to(torch.float32).reshape(b, l, nkv, group, hd) * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32))
    mask = segment_mask(seg_ids, seg_ids, causal)[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1)                                  # [B, nkv, g, L]
    p = torch.exp(s - m[..., None])
    lsum = p.sum(-1)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    valid = m > NEG_INF / 2
    safe_l = torch.where(lsum > 0, lsum, torch.ones_like(lsum))
    out = torch.where(valid[..., None], acc / safe_l[..., None], 0.0)
    lse = torch.where(valid, m + torch.log(safe_l), NEG_INF)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, l, nq, hd).to(q.dtype)
    return out, lse.reshape(b, nq, l)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library("flash_fwd").flash_fwd_bf16
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = i
        _fn = fn
    return _fn


def _check_cuda_inputs(q, k, v, seg_ids):
    for name, t in (("q", q), ("k", k), ("v", v), ("seg_ids", seg_ids)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte aligned")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention kernel takes bf16 {name}, "
                            f"got {t.dtype}")
    if seg_ids.dtype != torch.int32:
        raise TypeError(f"seg_ids must be int32, got {seg_ids.dtype}")
    b, l, nq, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, l) or k.shape[3] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if nq % k.shape[2]:
        raise ValueError(f"nq={nq} is not a multiple of nkv={k.shape[2]}")
    if tuple(seg_ids.shape) != (b, l):
        raise ValueError(f"seg_ids shape {tuple(seg_ids.shape)} != {(b, l)}")
    if hd not in (64, 128):
        raise ValueError(f"flash_attention kernel supports hd 64 or 128, "
                         f"got {hd}")


def flash_attention(q, k, v, seg_ids, *, causal: bool = True,
                    scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed-segment attention -> (o, lse). CPU tensors take the plain
    version; CUDA tensors launch the kernel (bf16 only) or raise."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, seg_ids, causal=causal,
                                     scale=scale)
    _check_cuda_inputs(q, k, v, seg_ids)
    b, l, nq, hd = q.shape
    scale = float(scale) if scale is not None else hd ** -0.5
    o = torch.empty_like(q)
    lse = torch.empty((b, nq, l), dtype=torch.float32, device=q.device)
    fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ids.data_ptr(),
              o.data_ptr(), lse.data_ptr(), b, l, nq, k.shape[2], hd, scale,
              int(causal), stream)
    _build.check(code, "flash_fwd")
    global launches
    launches += 1
    return o, lse
