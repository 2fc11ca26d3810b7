"""Flash attention over packed segments: the forward and its backward.

``flash_attention`` launches the CUDA kernel ``csrc/flash_fwd.cu`` (K1)
on a CUDA tensor and runs ``flash_attention_plain``, the same function in
plain PyTorch, on a CPU tensor. Both return o and the per-row
log-sum-exp; a row that sees no valid key gets o = 0 and lse = NEG_INF.
``flash_bwd_dq`` (K2) and ``flash_bwd_dkv`` (K3) launch the backward
kernels of ``csrc/flash_bwd.cu`` on CUDA tensors and take
``flash_attention_bwd_plain``'s arithmetic on CPU tensors.
``FlashAttentionFn`` ties them into one differentiable function: K1
forward, K2 + K3 backward. The bare ``flash_attention`` returns a tensor
with no gradient, so on the card it refuses inputs that ask for one.

Layouts: q/do/dq [B, L, nq, hd], k/v/dk/dv [B, L, nkv, hd], seg_ids
[B, L] (0 = padding); o like q; lse and delta [B, nq, L] fp32.
"""

import ctypes
from typing import Optional, Tuple

import torch

from realhf_tpu_torch.ops import _build

NEG_INF = -2.0 ** 30

#: kernel launches made by ``flash_attention`` (K1), ``flash_bwd_dq``
#: (K2) and ``flash_bwd_dkv`` (K3); reset them to 0 to count the
#: launches of one run
launches = 0
dq_launches = 0
dkv_launches = 0
_fns = {}


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


def _bwd_plain(q, k, v, seg_ids, lse, do, delta, *, causal: bool,
               scale: float):
    """K2's and K3's arithmetic in plain PyTorch, given delta
    [B, nq, L] = rowsum(o * do) (fp32 throughout)."""
    b, l, nq, hd = q.shape
    nkv = k.shape[2]
    group = nq // nkv
    qf = q.to(torch.float32).reshape(b, l, nkv, group, hd) * scale
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    dof = do.to(torch.float32).reshape(b, l, nkv, group, hd)
    lse_ = lse.reshape(b, nkv, group, l)[..., None]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf)
    keep = segment_mask(seg_ids, seg_ids, causal)[:, None, None] \
        & (lse_ > NEG_INF / 2)
    p = torch.where(keep, torch.exp(s - lse_), 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - delta.reshape(b, nkv, group, l)[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)   # qf carries the scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return (dq.reshape(b, l, nq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(o * do) in fp32, [B, L, nq, hd] -> [B, nq, L]: the
    backward's per-row term, computed beside the kernels as the JAX
    package does."""
    d = (o.to(torch.float32) * do.to(torch.float32)).sum(-1)
    return d.transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, seg_ids, o, lse, do, *,
                              causal: bool = True,
                              scale: Optional[float] = None):
    """The backward kernels' function in plain PyTorch -> (dq, dk, dv):
    p recomputed from the saved lse, ds = p (do.v - delta) with delta =
    rowsum(o * do), dq summed over keys, dk/dv per q head summed over
    each GQA group; dq in q's dtype, dk/dv in k's."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    return _bwd_plain(q, k, v, seg_ids, lse, do, attention_delta(o, do),
                      causal=causal, scale=scale)


def _kernel(name: str):
    """The ctypes entry ``name`` of its library, typed: pointers, then
    B, L, nq, nkv, hd, scale, causal, stream."""
    fn = _fns.get(name)
    if fn is None:
        lib, n_ptrs = {"flash_fwd_bf16": ("flash_fwd", 6),
                       "flash_bwd_dq_bf16": ("flash_bwd", 8),
                       "flash_bwd_dkv_bf16": ("flash_bwd", 9)}[name]
        fn = getattr(_build.library(lib), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * n_ptrs + [i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = i
        _fns[name] = fn
    return fn


def _check_cuda_inputs(q, k, v, seg_ids, *more):
    for name, t in (("q", q), ("k", k), ("v", v), ("seg_ids", seg_ids),
                    *more):
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


def _check_bwd_inputs(q, k, v, seg_ids, do, lse, delta):
    _check_cuda_inputs(q, k, v, seg_ids, ("do", do), ("lse", lse),
                       ("delta", delta))
    if do.dtype != torch.bfloat16 or do.shape != q.shape:
        raise ValueError(f"do must be bf16 of q's shape {tuple(q.shape)}, "
                         f"got {do.dtype} {tuple(do.shape)}")
    b, l, nq, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, nq, l):
            raise ValueError(f"{name} must be fp32 {(b, nq, l)}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def _launch(name: str, ptrs, q, k, causal: bool, scale: float):
    b, l, nq, hd = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _kernel(name)(*(t.data_ptr() for t in ptrs), b, l, nq,
                         k.shape[2], hd, scale, int(causal), stream)
    _build.check(code, name)


def _scale(q, scale: Optional[float]) -> float:
    return float(scale) if scale is not None else q.shape[-1] ** -0.5


def flash_attention(q, k, v, seg_ids, *, causal: bool = True,
                    scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed-segment attention -> (o, lse), with no gradient. CPU
    tensors take the plain version; CUDA tensors launch the kernel (bf16
    only) or raise. Differentiable callers use ``FlashAttentionFn``."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, seg_ids, causal=causal,
                                     scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention's kernel output carries no gradient; use "
            "FlashAttentionFn (or packed_attention) for inputs that "
            "require grad.")
    _check_cuda_inputs(q, k, v, seg_ids)
    b, l, nq, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, nq, l), dtype=torch.float32, device=q.device)
    _launch("flash_fwd_bf16", (q, k, v, seg_ids, o, lse), q, k, causal,
            _scale(q, scale))
    global launches
    launches += 1
    return o, lse


def flash_bwd_dq(q, k, v, seg_ids, do, lse, delta, *, causal: bool = True,
                 scale: Optional[float] = None) -> torch.Tensor:
    """dq of packed-segment attention from the saved lse and delta (K2
    on CUDA tensors, the plain arithmetic on CPU tensors)."""
    scale = _scale(q, scale)
    if not q.is_cuda:
        return _bwd_plain(q, k, v, seg_ids, lse, do, delta, causal=causal,
                          scale=scale)[0]
    _check_bwd_inputs(q, k, v, seg_ids, do, lse, delta)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq_bf16", (q, k, v, seg_ids, do, lse, delta, dq), q,
            k, causal, scale)
    global dq_launches
    dq_launches += 1
    return dq


def flash_bwd_dkv(q, k, v, seg_ids, do, lse, delta, *, causal: bool = True,
                  scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of packed-segment attention, each GQA group summed (K3
    on CUDA tensors, the plain arithmetic on CPU tensors)."""
    scale = _scale(q, scale)
    if not q.is_cuda:
        return _bwd_plain(q, k, v, seg_ids, lse, do, delta, causal=causal,
                          scale=scale)[1:]
    _check_bwd_inputs(q, k, v, seg_ids, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv_bf16", (q, k, v, seg_ids, do, lse, delta, dk, dv),
            q, k, causal, scale)
    global dkv_launches
    dkv_launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, seg_ids, o, lse, do, *, causal: bool = True,
                        scale: Optional[float] = None):
    """(dq, dk, dv) from the forward's o and lse: delta beside the
    kernels, then ``flash_bwd_dq`` and ``flash_bwd_dkv`` (CPU tensors:
    one call of the plain backward for all three)."""
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, seg_ids, o, lse, do,
                                         causal=causal, scale=scale)
    delta = attention_delta(o, do)
    kw = dict(causal=causal, scale=scale)
    dq = flash_bwd_dq(q, k, v, seg_ids, do, lse, delta, **kw)
    return (dq, *flash_bwd_dkv(q, k, v, seg_ids, do, lse, delta, **kw))


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable packed-segment attention -> o: the forward kernel
    (K1) saving (q, k, v, seg, o, lse), the backward kernels (K2, K3)
    from them. On CPU tensors the same wiring runs the plain versions.
    The counterpart of the JAX package's ``custom_vjp`` around
    ``_flash_attention``."""

    @staticmethod
    def forward(ctx, q, k, v, seg_ids, causal: bool = True,
                scale: Optional[float] = None):
        scale = _scale(q, scale)
        o, lse = flash_attention(q, k, v, seg_ids, causal=causal,
                                 scale=scale)
        ctx.save_for_backward(q, k, v, seg_ids, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg_ids, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, seg_ids, o, lse,
                                         do.contiguous(), causal=ctx.causal,
                                         scale=ctx.scale)
        return dq, dk, dv, None, None, None
