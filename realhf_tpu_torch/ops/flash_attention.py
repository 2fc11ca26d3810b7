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

Every function takes ``window`` (None = none): a sliding window in which
a query sees only the keys less than ``window`` positions behind it, as
``segment_mask``'s ``sliding_window``. The kernels skip the key tiles out
of reach, and give the windowless bits for a window of L or more.

A round of the ring's backward (``ops/ring_attention_fused.py``
``RingAttentionFn``) holds one member's q shard against another's keys:
``flash_bwd_dq`` and ``flash_bwd_dkv`` then take the keys' own segment
ids ``seg_k``, the global stream offsets ``q_off`` and ``k_off`` of the
two shards (the causal and window tests read global positions) and
``out_dtype=torch.float32`` for fp32 partials; on CUDA the kernels take
them at every head dim they are built for. With the defaults the
kernels' bits are those of the kernels before the ring round existed.
"""

import ctypes
from typing import Optional, Tuple

import torch

from realhf_tpu_torch.ops import _build

NEG_INF = -2.0 ** 30
#: head dims the kernels (K1, K2, K3) are built for
KERNEL_HEAD_DIMS = (64, 128, 256)

#: kernel launches made by ``flash_attention`` (K1), ``flash_bwd_dq``
#: (K2) and ``flash_bwd_dkv`` (K3) at default arguments, and by K2 and K3
#: at a ring round (a round of the ring's backward, module note); reset
#: them to 0 to count the launches of one run
launches = 0
dq_launches = 0
dkv_launches = 0
dq_ring_launches = 0
dkv_ring_launches = 0
_fns = {}


def segment_mask(seg_q: torch.Tensor, seg_k: torch.Tensor, causal: bool,
                 sliding_window: Optional[int] = None, *, q_off: int = 0,
                 k_off: int = 0) -> torch.Tensor:
    """[B, Lq, Lk] bool: same non-zero segment (+ causality, + optional
    sliding window), the queries at stream positions ``q_off ..`` and the
    keys at ``k_off ..``. Positions inside a segment are contiguous, so
    the stream-index difference is the in-segment position difference."""
    mask = (seg_q[:, :, None] == seg_k[:, None, :]) & (seg_q[:, :, None] != 0)
    lq, lk = seg_q.shape[1], seg_k.shape[1]
    idx_q = q_off + torch.arange(lq, device=seg_q.device)[:, None]
    idx_k = k_off + torch.arange(lk, device=seg_q.device)[None, :]
    if causal:
        mask = mask & (idx_q >= idx_k)[None]
    if sliding_window is not None:
        mask = mask & ((idx_q - idx_k) < sliding_window)[None]
    return mask


#: query rows of one warpgroup of K1 (and K6) and keys of one of its K/V
#: tiles: the tile grid on which ``visited_key_tiles`` states its skip rule
K1_BQ = 64
K1_BK = 64


def _tile_ids(seg: torch.Tensor, t: int):
    """Per tile of ``t`` tokens of ``seg`` [B, L] (the last one ragged):
    the least and largest non-zero id (int64 max / min when it has none)
    and the set of those ids' residues mod 64 as a float [64] row."""
    b, n = seg.shape[0], -(-seg.shape[1] // t)
    big = torch.iinfo(torch.int64).max
    s = torch.nn.functional.pad(seg.to(torch.int64),
                                (0, n * t - seg.shape[1])).reshape(b, n, t)
    nz = s != 0
    residues = torch.nn.functional.one_hot(s & 63, 64) & nz[..., None]
    return (torch.where(nz, s, big).amin(-1),
            torch.where(nz, s, -big).amax(-1),
            residues.any(-2).to(torch.float32))


def visited_key_tiles(seg_ids: torch.Tensor, causal: bool, bq: int = K1_BQ,
                      bk: int = K1_BK, *, seg_k: Optional[torch.Tensor] = None,
                      q_off: int = 0, k_off: int = 0,
                      window: Optional[int] = None) -> torch.Tensor:
    """[B, ceil(Lq/bq), ceil(Lk/bk)] bool: the (q tile, key tile) pairs a
    kernel computes; it skips every other pair. The queries carry
    ``seg_ids`` [B, Lq], the keys ``seg_k`` [B, Lk] (``seg_ids`` itself
    by default), and both lie at global stream offsets ``q_off`` and
    ``k_off`` (K6 holds a member's q shard against a KV half of another
    shard). A pair is visited when the ranges [min, max] of the two
    tiles' non-zero segment ids meet, the sets of those ids' residues mod
    64 meet, when causal the key tile's first global key is at or before
    the q tile's last global row, and with a ``window`` the key tile's
    last global key is less than ``window`` behind the q tile's first
    global row. Sound for any ids (every pair that ``segment_mask``
    allows on global positions lies in a visited pair of tiles); tight to
    the tile edges when fewer than 64 ids lie near each other, in
    whatever order the packer placed them. With the defaults it is K1's
    rule."""
    seg_k = seg_ids if seg_k is None else seg_k
    lq, lk = seg_ids.shape[1], seg_k.shape[1]
    n_q, n_k = -(-lq // bq), -(-lk // bk)
    q_lo, q_hi, q_res = _tile_ids(seg_ids, bq)
    k_lo, k_hi, k_res = _tile_ids(seg_k, bk)
    vis = ((k_lo[:, None, :] <= q_hi[:, :, None])
           & (k_hi[:, None, :] >= q_lo[:, :, None])
           & (q_res @ k_res.transpose(1, 2) > 0))
    dev = seg_ids.device
    first_q = q_off + torch.arange(n_q, device=dev) * bq
    last_q = q_off + (torch.arange(1, n_q + 1, device=dev) * bq).clamp(
        max=lq) - 1
    first_k = k_off + torch.arange(n_k, device=dev) * bk
    last_k = k_off + (torch.arange(1, n_k + 1, device=dev) * bk).clamp(
        max=lk) - 1
    if causal:
        vis = vis & (first_k[None, :] <= last_q[:, None])[None]
    if window is not None:
        vis = vis & ((first_q[:, None] - last_k[None, :]) < window)[None]
    return vis


def visited_q_tiles(seg_ids: torch.Tensor, causal: bool, bk: int = K1_BK,
                    bq: int = K1_BQ, *,
                    window: Optional[int] = None) -> torch.Tensor:
    """[B, ceil(L/bk), ceil(L/bq)] bool: the (key tile, q tile) pairs K3
    computes, stated from the key side as K3 marks them. A key tile (one
    warpgroup's ``bk`` keys) visits a q tile of ``bq`` rows when the
    ranges [min, max] of their non-zero ids meet, their residue sets mod
    64 meet, when causal the q tile's last row is at or after the key
    tile's first key, and with a ``window`` the q tile's first row is less
    than ``window`` after the key tile's last key. This is
    ``visited_key_tiles(seg_ids, causal, bq, bk, window=window)``
    transposed, so K1, K2 and K3 walk the same pairs."""
    l = seg_ids.shape[1]
    n_k, n_q = -(-l // bk), -(-l // bq)
    k_lo, k_hi, k_res = _tile_ids(seg_ids, bk)
    q_lo, q_hi, q_res = _tile_ids(seg_ids, bq)
    vis = ((q_lo[:, None, :] <= k_hi[:, :, None])
           & (q_hi[:, None, :] >= k_lo[:, :, None])
           & (k_res @ q_res.transpose(1, 2) > 0))
    dev = seg_ids.device
    first_k = torch.arange(n_k, device=dev) * bk
    last_k = (torch.arange(1, n_k + 1, device=dev) * bk).clamp(max=l) - 1
    first_q = torch.arange(n_q, device=dev) * bq
    last_q = (torch.arange(1, n_q + 1, device=dev) * bq).clamp(max=l) - 1
    if causal:
        vis = vis & (last_q[None, :] >= first_k[:, None])[None]
    if window is not None:
        vis = vis & ((first_q[None, :] - last_k[:, None]) < window)[None]
    return vis


def flash_attention_plain(q, k, v, seg_ids, *, causal: bool = True,
                          scale: Optional[float] = None,
                          window: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch (fp32 scores)."""
    b, l, nq, hd = q.shape
    nkv = k.shape[2]
    group = nq // nkv
    scale = float(scale) if scale is not None else hd ** -0.5
    qg = q.to(torch.float32).reshape(b, l, nkv, group, hd) * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32))
    mask = segment_mask(seg_ids, seg_ids, causal, window)[:, None, None]
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
               scale: float, window: Optional[int] = None, seg_k=None,
               q_off: int = 0, k_off: int = 0, out_dtype=None):
    """K2's and K3's arithmetic in plain PyTorch, given delta
    [B, nq, L] = rowsum(o * do) (fp32 throughout): q rows with ids
    ``seg_ids`` at stream offset ``q_off`` against keys with ids
    ``seg_k`` (default ``seg_ids``) at ``k_off``; dq in ``out_dtype``
    (default q's), dk/dv in it (default k's)."""
    b, l, nq, hd = q.shape
    nkv = k.shape[2]
    group = nq // nkv
    qf = q.to(torch.float32).reshape(b, l, nkv, group, hd) * scale
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    dof = do.to(torch.float32).reshape(b, l, nkv, group, hd)
    lse_ = lse.reshape(b, nkv, group, l)[..., None]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf)
    keep = segment_mask(seg_ids, seg_ids if seg_k is None else seg_k, causal,
                        window, q_off=q_off, k_off=k_off)[:, None, None] \
        & (lse_ > NEG_INF / 2)
    p = torch.where(keep, torch.exp(s - lse_), 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - delta.reshape(b, nkv, group, l)[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)   # qf carries the scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return (dq.reshape(b, l, nq, hd).to(out_dtype or q.dtype),
            dk.to(out_dtype or k.dtype), dv.to(out_dtype or v.dtype))


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(o * do) in fp32, [B, L, nq, hd] -> [B, nq, L]: the
    backward's per-row term, computed beside the kernels as the JAX
    package does."""
    d = (o.to(torch.float32) * do.to(torch.float32)).sum(-1)
    return d.transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, seg_ids, o, lse, do, *,
                              causal: bool = True,
                              scale: Optional[float] = None,
                              window: Optional[int] = None):
    """The backward kernels' function in plain PyTorch -> (dq, dk, dv):
    p recomputed from the saved lse, ds = p (do.v - delta) with delta =
    rowsum(o * do), dq summed over keys, dk/dv per q head summed over
    each GQA group; dq in q's dtype, dk/dv in k's."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    return _bwd_plain(q, k, v, seg_ids, lse, do, attention_delta(o, do),
                      causal=causal, scale=scale, window=window)


def _kernel(name: str):
    """The ctypes entry ``name`` of its library, typed: pointers, then
    B, L, nq, nkv, hd, (K2 and K3: q_off, k_off, out_f32,) scale,
    causal, window, stream."""
    fn = _fns.get(name)
    if fn is None:
        lib, n_ptrs, n_ring = {"flash_fwd_bf16": ("flash_fwd", 6, 0),
                               "flash_bwd_dq_bf16": ("flash_bwd", 9, 3),
                               "flash_bwd_dkv_bf16": ("flash_bwd", 10, 3),
                               }[name]
        fn = getattr(_build.library(lib), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * n_ptrs + [i] * (5 + n_ring)
                       + [ctypes.c_float, i, i, p])
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
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel supports hd 64, 128 or "
                         f"256, got {hd}")


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


def _window_arg(window: Optional[int]) -> int:
    """The kernels' window argument: -1 for none."""
    if window is None:
        return -1
    if int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return int(window)


def _launch(name: str, ptrs, q, k, causal: bool, scale: float,
            window: Optional[int], ring=()):
    b, l, nq, hd = q.shape
    # the launch goes to the current device's context: make it the
    # tensors' (a member on another card than the caller's current one)
    with _build.on_device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = _kernel(name)(*(t.data_ptr() for t in ptrs), b, l, nq,
                             k.shape[2], hd, *ring, scale, int(causal),
                             _window_arg(window), stream)
    _build.check(code, name)


def _ring_args(q, k, v, seg_ids, seg_k, q_off: int, k_off: int, out_dtype):
    """(seg_k, (q_off, k_off, out_f32)) of a K2/K3 launch, checked, and
    whether it is a ring round: (seg_ids, (0, 0, 0)) and False with the
    defaults."""
    if (seg_k is None and q_off == 0 and k_off == 0
            and out_dtype in (None, q.dtype)):
        return seg_ids, (0, 0, 0), False
    seg_k = seg_ids if seg_k is None else seg_k
    if out_dtype not in (None, torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or fp32, got {out_dtype}")
    if k.shape[1] != q.shape[1]:
        raise ValueError("a ring round's q and key shards have one length, "
                         f"got {q.shape[1]} and {k.shape[1]}")
    _check_cuda_inputs(q, k, v, seg_k)
    return (seg_k, (int(q_off), int(k_off), int(out_dtype == torch.float32)),
            True)


def _scale(q, scale: Optional[float]) -> float:
    return float(scale) if scale is not None else q.shape[-1] ** -0.5


def flash_attention(q, k, v, seg_ids, *, causal: bool = True,
                    scale: Optional[float] = None,
                    window: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed-segment attention -> (o, lse), with no gradient. CPU
    tensors take the plain version; CUDA tensors launch the kernel (bf16
    only) or raise. Differentiable callers use ``FlashAttentionFn``."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, seg_ids, causal=causal,
                                     scale=scale, window=window)
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
            _scale(q, scale), window)
    global launches
    launches += 1
    return o, lse


def flash_bwd_dq(q, k, v, seg_ids, do, lse, delta, *, causal: bool = True,
                 scale: Optional[float] = None, window: Optional[int] = None,
                 seg_k=None, q_off: int = 0, k_off: int = 0,
                 out_dtype=None) -> torch.Tensor:
    """dq of packed-segment attention from the saved lse and delta (K2
    on CUDA tensors, the plain arithmetic on CPU tensors). ``seg_k``,
    ``q_off``, ``k_off`` and ``out_dtype``: a ring round (module note)."""
    scale = _scale(q, scale)
    if not q.is_cuda:
        return _bwd_plain(q, k, v, seg_ids, lse, do, delta, causal=causal,
                          scale=scale, window=window, seg_k=seg_k,
                          q_off=q_off, k_off=k_off, out_dtype=out_dtype)[0]
    _check_bwd_inputs(q, k, v, seg_ids, do, lse, delta)
    seg_k, args, ring = _ring_args(q, k, v, seg_ids, seg_k, q_off, k_off,
                                   out_dtype)
    dq = torch.empty_like(q, dtype=out_dtype or q.dtype)
    _launch("flash_bwd_dq_bf16",
            (q, k, v, seg_ids, seg_k, do, lse, delta, dq), q, k, causal,
            scale, window, args)
    global dq_launches, dq_ring_launches
    if ring:
        dq_ring_launches += 1
    else:
        dq_launches += 1
    return dq


def flash_bwd_dkv(q, k, v, seg_ids, do, lse, delta, *, causal: bool = True,
                  scale: Optional[float] = None,
                  window: Optional[int] = None, seg_k=None, q_off: int = 0,
                  k_off: int = 0, out_dtype=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of packed-segment attention, each GQA group summed (K3
    on CUDA tensors, the plain arithmetic on CPU tensors). ``seg_k``,
    ``q_off``, ``k_off`` and ``out_dtype``: a ring round (module note)."""
    scale = _scale(q, scale)
    if not q.is_cuda:
        return _bwd_plain(q, k, v, seg_ids, lse, do, delta, causal=causal,
                          scale=scale, window=window, seg_k=seg_k,
                          q_off=q_off, k_off=k_off, out_dtype=out_dtype)[1:]
    _check_bwd_inputs(q, k, v, seg_ids, do, lse, delta)
    seg_k, args, ring = _ring_args(q, k, v, seg_ids, seg_k, q_off, k_off,
                                   out_dtype)
    dk = torch.empty_like(k, dtype=out_dtype or k.dtype)
    dv = torch.empty_like(v, dtype=out_dtype or v.dtype)
    _launch("flash_bwd_dkv_bf16",
            (q, k, v, seg_ids, seg_k, do, lse, delta, dk, dv), q, k, causal,
            scale, window, args)
    global dkv_launches, dkv_ring_launches
    if ring:
        dkv_ring_launches += 1
    else:
        dkv_launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, seg_ids, o, lse, do, *, causal: bool = True,
                        scale: Optional[float] = None,
                        window: Optional[int] = None):
    """(dq, dk, dv) from the forward's o and lse: delta beside the
    kernels, then ``flash_bwd_dq`` and ``flash_bwd_dkv`` (CPU tensors:
    one call of the plain backward for all three)."""
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, seg_ids, o, lse, do,
                                         causal=causal, scale=scale,
                                         window=window)
    delta = attention_delta(o, do)
    kw = dict(causal=causal, scale=scale, window=window)
    dq = flash_bwd_dq(q, k, v, seg_ids, do, lse, delta, **kw)
    return (dq, *flash_bwd_dkv(q, k, v, seg_ids, do, lse, delta, **kw))


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable packed-segment attention -> o: the forward kernel
    (K1) saving (q, k, v, seg, o, lse), the backward kernels (K2, K3)
    from them, with the same window. On CPU tensors the same wiring runs
    the plain versions. The counterpart of the JAX package's
    ``custom_vjp`` around ``_flash_attention``."""

    @staticmethod
    def forward(ctx, q, k, v, seg_ids, causal: bool = True,
                scale: Optional[float] = None,
                window: Optional[int] = None):
        scale = _scale(q, scale)
        o, lse = flash_attention(q, k, v, seg_ids, causal=causal,
                                 scale=scale, window=window)
        ctx.save_for_backward(q, k, v, seg_ids, o, lse)
        ctx.causal, ctx.scale, ctx.window = causal, scale, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg_ids, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, seg_ids, o, lse,
                                         do.contiguous(), causal=ctx.causal,
                                         scale=ctx.scale, window=ctx.window)
        return dq, dk, dv, None, None, None, None
