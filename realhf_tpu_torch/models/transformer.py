"""The decoder-only transformer used for every model role.

Parameters are a plain dict tree of tensors in the JAX package's layout,
with the block weights stacked along a leading layer axis
(``params["blocks"][...]`` leaves are ``[n_layers, ...]``), so the two
packages exchange weights leaf for leaf (``models/convert.py``). Each forward
takes layer ``l``'s weights as views from one ``torch.unbind`` per
stacked leaf (``layer_views``).

Batches are packed streams ``[B, L]`` with segment ids (0 = padding);
positions are derived per segment. Generation keeps a head-major KV
cache ``[n_layers, B, n_kv_heads, S, head_dim]`` and runs a one-token
decode step that writes the cache in place.

Attention goes through ``ops/attention.py``, which runs the CUDA kernels
on CUDA tensors and the plain PyTorch versions on CPU tensors; the
projections and MLP are ``torch.matmul``. ``forward_ctx`` runs the same
blocks over context-parallel members that each hold a shard of every
stream, with ring attention (``ops/ring_attention_fused.py``) between
each block's two halves. Under autograd with
``cfg.gradient_checkpointing`` each block is recomputed in the backward
from its input (``torch.utils.checkpoint``), as the JAX package's
``jax.checkpoint(..., policy=nothing_saveable)`` does.
"""

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.ops.attention import (
    decode_attention,
    packed_attention,
    stacked_decode_attention,
)
from realhf_tpu_torch.ops.ring_attention_fused import ring_attention_fused
from realhf_tpu_torch.ops.rotary import apply_rotary, rotary_freqs

Params = Dict[str, Any]
KVCache = Dict[str, torch.Tensor]


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def check_supported(cfg: TransformerConfig):
    """Raise for model features this slice of the port leaves out."""
    if cfg.mlp_type == "moe":
        raise NotImplementedError(
            "Mixture-of-experts models (ops/moe.py) are not ported yet: "
            "ROADMAP.md, queue 1, item 3 (model features beyond LLaMA).")


# ----------------------------------------------------------------------
# Initialization
# ----------------------------------------------------------------------
def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device="cpu") -> Params:
    """Random-normal init (std 0.02, output projections scaled by
    1/sqrt(2 n_layers)), drawn from ``generator`` directly on ``device``
    in ``cfg.param_dtype``. The generator must live on ``device``."""
    check_supported(cfg)
    pdt = dtype_of(cfg.param_dtype)
    h, f, v = cfg.hidden_dim, cfg.intermediate_dim, cfg.vocab_size
    nl, hd = cfg.n_layers, cfg.head_dim
    nq, nkv = cfg.n_q_heads, cfg.n_kv_heads
    std = 0.02
    proj_std = std / (2 * nl) ** 0.5

    def norm(shape, s=std):
        return torch.empty(shape, dtype=pdt, device=device).normal_(
            0.0, s, generator=generator)

    def zeros(shape):
        return torch.zeros(shape, dtype=pdt, device=device)

    def ones(shape):
        return torch.ones(shape, dtype=pdt, device=device)

    params: Params = {
        "embed": {"wte": norm((v, h))},
        "blocks": {
            "ln1": {"scale": ones((nl, h))},
            "attn": {
                "wq": norm((nl, h, nq * hd)),
                "wk": norm((nl, h, nkv * hd)),
                "wv": norm((nl, h, nkv * hd)),
                "wo": norm((nl, nq * hd, h), proj_std),
            },
            "ln2": {"scale": ones((nl, h))},
            "mlp": {},
        },
        "ln_f": {"scale": ones((h,))},
    }
    if cfg.uses_absolute_position:
        assert cfg.n_positions is not None
        params["embed"]["wpe"] = norm(
            (cfg.n_positions + cfg.abs_position_embedding_offset, h))
    mlp = params["blocks"]["mlp"]
    if cfg.gated_mlp:
        mlp["wg"] = norm((nl, h, f))
    mlp["wu"] = norm((nl, h, f))
    mlp["wd"] = norm((nl, f, h), proj_std)
    a = params["blocks"]["attn"]
    if cfg.use_attention_bias:
        a["bq"], a["bk"], a["bv"] = (zeros((nl, nq * hd)),
                                     zeros((nl, nkv * hd)),
                                     zeros((nl, nkv * hd)))
    if cfg.use_attn_proj_bias:
        a["bo"] = zeros((nl, h))
    if cfg.use_mlp_bias and cfg.mlp_type is None:
        mlp["bu"] = zeros((nl, f))
        mlp["bd"] = zeros((nl, h))
    if cfg.layer_norm_type is None:  # LayerNorm has a bias; RMSNorm none
        params["blocks"]["ln1"]["bias"] = zeros((nl, h))
        params["blocks"]["ln2"]["bias"] = zeros((nl, h))
        params["ln_f"]["bias"] = zeros((h,))
    if cfg.is_critic:
        params["head"] = {"w": norm((h, 1))}
    elif not cfg.tied_embedding:
        params["head"] = {"w": norm((h, v))}
    return params


def layer_views(blocks: Params, n_layers: int) -> List[Params]:
    """Every layer's weights as views into the stacked block tree, from
    one ``torch.unbind`` per leaf. Under autograd that is one backward
    node per leaf, which stacks the layer gradients once; indexing
    ``leaf[l]`` per layer would give each layer a node that builds a
    zero-filled gradient of the whole stacked leaf."""
    views: List[Params] = [{} for _ in range(n_layers)]

    def fill(tree, outs):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v, [o.setdefault(k, {}) for o in outs])
            else:
                for o, t in zip(outs, torch.unbind(v)):
                    o[k] = t

    fill(blocks, views)
    return views


# ----------------------------------------------------------------------
# Building blocks
# ----------------------------------------------------------------------
def _norm(cfg: TransformerConfig, x: torch.Tensor, scale: torch.Tensor,
          bias: Optional[torch.Tensor]) -> torch.Tensor:
    """LayerNorm / RMSNorm / gemma-RMSNorm with fp32 accumulation."""
    xf = x.to(torch.float32)
    eps = cfg.layer_norm_epsilon
    if cfg.layer_norm_type is None:
        mean = xf.mean(-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(-1, keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + eps)
        out = out * scale.to(torch.float32)
        if bias is not None:
            out = out + bias.to(torch.float32)
    elif cfg.layer_norm_type == "rms":
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * scale.to(torch.float32)
    elif cfg.layer_norm_type == "gemma":
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    else:
        raise NotImplementedError(cfg.layer_norm_type)
    return out.to(x.dtype)


def _activation(cfg: TransformerConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation_function == "silu":
        return F.silu(x)
    if cfg.activation_function == "gelu":
        return F.gelu(x, approximate="none")
    if cfg.activation_function == "gelu_new":
        return F.gelu(x, approximate="tanh")
    raise NotImplementedError(cfg.activation_function)


def _mlp(cfg: TransformerConfig, lp: Params, x: torch.Tensor) -> torch.Tensor:
    out, _ = _mlp_with_aux(cfg, lp, x)
    return out


def _mlp_with_aux(cfg: TransformerConfig, lp: Params, x: torch.Tensor):
    """MLP -> (output, aux-loss dict); the dict is non-empty only for
    mixture-of-experts models, which this slice does not run."""
    check_supported(cfg)
    return _dense_mlp(cfg, lp["mlp"], x, dtype_of(cfg.compute_dtype)), {}


def _dense_mlp(cfg, m, x, cdt):
    if cfg.gated_mlp:
        gate = x @ m["wg"].to(cdt)
        up = x @ m["wu"].to(cdt)
        return (_activation(cfg, gate) * up) @ m["wd"].to(cdt)
    up = x @ m["wu"].to(cdt)
    if "bu" in m:
        up = up + m["bu"].to(cdt)
    out = _activation(cfg, up) @ m["wd"].to(cdt)
    if "bd" in m:
        out = out + m["bd"].to(cdt)
    return out


def _qkv(cfg: TransformerConfig, lp: Params, x: torch.Tensor):
    cdt = dtype_of(cfg.compute_dtype)
    a = lp["attn"]
    lead = x.shape[:-1]
    q = x @ a["wq"].to(cdt)
    k = x @ a["wk"].to(cdt)
    v = x @ a["wv"].to(cdt)
    if "bq" in a:
        q = q + a["bq"].to(cdt)
        k = k + a["bk"].to(cdt)
        v = v + a["bv"].to(cdt)
    q = q.reshape(*lead, cfg.n_q_heads, cfg.head_dim)
    k = k.reshape(*lead, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(*lead, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def _attn_scale(cfg: TransformerConfig, layer_idx: int) -> float:
    scale = cfg.head_dim ** -0.5 if cfg.scale_attn_weights else 1.0
    if cfg.scale_attn_by_inverse_layer_idx:
        scale = scale / (layer_idx + 1.0)
    return scale


def _attn_in(cfg: TransformerConfig, lp: Params, x: torch.Tensor,
             cos: torch.Tensor, sin: torch.Tensor):
    """The block up to attention: norm, q/k/v projections and rotary
    over [B, L, H] -> q [B, L, nq, hd], k/v [B, L, nkv, hd]."""
    ln1 = _norm(cfg, x, lp["ln1"]["scale"], lp["ln1"].get("bias"))
    q, k, v = _qkv(cfg, lp, ln1)
    if cfg.apply_rotary:
        q = apply_rotary(q, cos, sin, cfg.rotary_interleaved)
        k = apply_rotary(k, cos, sin, cfg.rotary_interleaved)
    return q, k.contiguous(), v.contiguous()


def _attn_out(cfg: TransformerConfig, lp: Params, x: torch.Tensor,
              attn: torch.Tensor) -> torch.Tensor:
    """The block after attention: output projection and residual, norm,
    MLP and residual -> the block's output [B, L, H]."""
    attn = attn.reshape(*x.shape[:-1], cfg.n_q_heads * cfg.head_dim)
    proj = attn @ lp["attn"]["wo"].to(x.dtype)
    if "bo" in lp["attn"]:
        proj = proj + lp["attn"]["bo"].to(x.dtype)
    x = x + proj
    ln2 = _norm(cfg, x, lp["ln2"]["scale"], lp["ln2"].get("bias"))
    return x + _mlp(cfg, lp, ln2)


def _block(cfg: TransformerConfig, lp: Params, layer_idx: int,
           x: torch.Tensor, seg_ids: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor, attention_fn=None):
    """One block over packed streams [B, L, H] -> (residual output,
    (k, v)); k/v feed the prefill KV cache."""
    q, k, v = _attn_in(cfg, lp, x, cos, sin)
    attn_impl = attention_fn or packed_attention
    attn = attn_impl(q, k, v, seg_ids, causal=True,
                     scale=_attn_scale(cfg, layer_idx),
                     sliding_window=cfg.sliding_window)
    return _attn_out(cfg, lp, x, attn), (k, v)


def positions_from_segments(seg_ids: torch.Tensor) -> torch.Tensor:
    """Position of each token within its segment for packed streams:
    [B, L] int -> [B, L] int32. Pad tokens get position 0 within their
    run of padding."""
    idx = torch.arange(seg_ids.shape[1], dtype=torch.int64,
                       device=seg_ids.device)[None, :]
    new_seg = torch.ones_like(seg_ids, dtype=torch.bool)
    new_seg[:, 1:] = seg_ids[:, 1:] != seg_ids[:, :-1]
    starts = torch.where(new_seg, idx, torch.zeros_like(idx))
    seg_start = torch.cummax(starts, dim=1).values
    return (idx - seg_start).to(torch.int32)


def _embed(cfg, params, ids, positions):
    cdt = dtype_of(cfg.compute_dtype)
    x = params["embed"]["wte"][ids].to(cdt)
    if cfg.uses_absolute_position:
        x = x + params["embed"]["wpe"][
            positions.long() + cfg.abs_position_embedding_offset].to(cdt)
    if cfg.normalize_embed:
        x = x * torch.tensor(cfg.hidden_dim ** 0.5, dtype=cdt)
    return x


def _rotary_tables(cfg, positions):
    if cfg.apply_rotary:
        return rotary_freqs(positions, cfg.head_dim, cfg.rotary_base,
                            cfg.rotary_scaling, cfg.rotary_scaling_type,
                            cfg.n_positions)
    half = cfg.head_dim // 2
    shape = (*positions.shape, half)
    return (torch.ones(shape, device=positions.device),
            torch.zeros(shape, device=positions.device))


# ----------------------------------------------------------------------
# Forward (prefill / inference)
# ----------------------------------------------------------------------
def forward(cfg: TransformerConfig, params: Params,
            input_ids: torch.Tensor, seg_ids: torch.Tensor,
            positions: Optional[torch.Tensor] = None, *,
            return_kv: bool = False, attention_fn=None, pipeline=None):
    """Packed forward -> (final hidden states [B, L, H] after the final
    norm, kvs). ``kvs`` is ``(k, v)`` stacked ``[n_layers, B, L, nkv,
    hd]`` when ``return_kv``, else None. Heads apply separately
    (``lm_logits``, ``critic_values``)."""
    if pipeline is not None:
        raise NotImplementedError(
            "pipeline parallelism is deferred to the parallelism slice of "
            "the port.")
    check_supported(cfg)
    seg_ids = seg_ids.to(torch.int32)
    if positions is None:
        positions = positions_from_segments(seg_ids)
    x = _embed(cfg, params, input_ids.long(), positions)
    cos, sin = _rotary_tables(cfg, positions)
    ks, vs = [], []
    remat = cfg.gradient_checkpointing and torch.is_grad_enabled()
    for li, lp in enumerate(layer_views(params["blocks"], cfg.n_layers)):
        if remat:
            x, (k, v) = checkpoint(_block, cfg, lp, li, x, seg_ids, cos, sin,
                                   attention_fn, use_reentrant=False)
        else:
            x, (k, v) = _block(cfg, lp, li, x, seg_ids, cos, sin,
                               attention_fn)
        if return_kv:
            ks.append(k)
            vs.append(v)
    x = _norm(cfg, x, params["ln_f"]["scale"], params["ln_f"].get("bias"))
    kvs = (torch.stack(ks), torch.stack(vs)) if return_kv else None
    return x, kvs


def forward_ctx(cfg: TransformerConfig, member_params: List[Params],
                input_ids: List[torch.Tensor], seg_ids: List[torch.Tensor],
                positions: List[torch.Tensor], *,
                attention_fn=None) -> List[torch.Tensor]:
    """Context-parallel forward: member ``i`` holds the contiguous
    shard ``[B, lc]`` of every stream's tokens, its segment ids and its
    positions within the WHOLE stream, on its own device, with
    ``member_params[i]`` there (members that share a device share one
    tree). Returns each member's final hidden states [B, lc, H] after
    the final norm.

    The layers run layer-major over the members: a member's attention at
    layer l needs every member's K/V of layer l, so each layer runs the
    first half of the block (``_attn_in``) on every member, then the ring
    (``attention_fn``, default ``ring_attention_fused``) over all of
    them, then the second half (``_attn_out``). JAX gets this order from
    SPMD; one process driving the members writes it out."""
    check_supported(cfg)
    ring = attention_fn or ring_attention_fused
    views = {}
    for p in member_params:
        if id(p) not in views:
            views[id(p)] = layer_views(p["blocks"], cfg.n_layers)
    layers = [views[id(p)] for p in member_params]
    segs = [s.to(torch.int32).contiguous() for s in seg_ids]
    xs = [_embed(cfg, p, ids.long(), pos)
          for p, ids, pos in zip(member_params, input_ids, positions)]
    tables = [_rotary_tables(cfg, pos) for pos in positions]
    for li in range(cfg.n_layers):
        qkv = [_attn_in(cfg, lv[li], x, cos, sin)
               for lv, x, (cos, sin) in zip(layers, xs, tables)]
        q, k, v = (list(t) for t in zip(*qkv))
        attn = ring(q, k, v, segs, causal=True,
                    scale=_attn_scale(cfg, li),
                    sliding_window=cfg.sliding_window)
        xs = [_attn_out(cfg, lv[li], x, a)
              for lv, x, a in zip(layers, xs, attn)]
    return [_norm(cfg, x, p["ln_f"]["scale"], p["ln_f"].get("bias"))
            for p, x in zip(member_params, xs)]


def head_weight(cfg: TransformerConfig, params: Params) -> torch.Tensor:
    if cfg.is_critic:
        return params["head"]["w"]
    if cfg.tied_embedding:
        return params["embed"]["wte"].T
    return params["head"]["w"]


class _MatmulF32(torch.autograd.Function):
    """x [M, H] @ w [H, N] with cuBLAS writing its fp32 sums out
    directly (``torch.mm`` with ``out_dtype`` has no derivative); the
    backward runs in x's dtype with fp32 accumulation, the gradient of
    the fp32 logits rounded to it first."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w.T, x.T @ g


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., H] @ w [H, N] summed and returned in fp32, never rounded to
    x's dtype first (the JAX head's ``preferred_element_type=float32``).
    cuBLAS writes its fp32 accumulator out directly; on the CPU, which
    has no such GEMM, the operands are widened (each product is exact)."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        out = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return x.to(torch.float32) @ w.to(torch.float32)


def lm_logits(cfg: TransformerConfig, params: Params,
              hidden: torch.Tensor) -> torch.Tensor:
    """[..., H] -> [..., V] fp32 logits (any vocab padding sliced off)."""
    logits = _matmul_f32(hidden, head_weight(cfg, params))
    if logits.shape[-1] != cfg.vocab_size:
        logits = logits[..., :cfg.vocab_size]
    return logits


def critic_values(cfg: TransformerConfig, params: Params,
                  hidden: torch.Tensor) -> torch.Tensor:
    """[..., H] -> [...] fp32 scalar values."""
    assert cfg.is_critic
    return _matmul_f32(hidden, params["head"]["w"])[..., 0]


# ----------------------------------------------------------------------
# KV cache + decode step (generation)
# ----------------------------------------------------------------------
# Cache layout is HEAD-MAJOR: k/v are [nl, B, nkv, S, hd], so the decode
# kernel reads one (stream, KV head) row block contiguously.
_CACHE_LEN_MULTIPLE = 128
# Up to this depth the decode step reads each layer through a per-layer
# view of the stacked cache; deeper models go through the stacked-cache
# entry of the decode kernel (the layer's offset inside the stack).
_DECODE_UNROLL_MAX_LAYERS = 48


def round_cache_len(n: int) -> int:
    """Round a KV-cache slot count up to a multiple of 128."""
    if n <= _CACHE_LEN_MULTIPLE:
        return n
    return -(-n // _CACHE_LEN_MULTIPLE) * _CACHE_LEN_MULTIPLE


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  dtype=None, device="cpu") -> KVCache:
    """A zero cache of ``round_cache_len(max_len)`` slots."""
    dtype = dtype or dtype_of(cfg.compute_dtype)
    max_len = round_cache_len(max_len)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "valid": torch.zeros((batch, max_len), dtype=torch.bool,
                             device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def prefill(cfg: TransformerConfig, params: Params, input_ids: torch.Tensor,
            seg_ids: torch.Tensor, positions: Optional[torch.Tensor] = None,
            *, total_len: Optional[int] = None, attention_fn=None
            ) -> Tuple[torch.Tensor, KVCache]:
    """Packed forward plus a KV cache whose first L slots hold the
    prompt's keys/values. ``total_len`` sizes the cache for the whole
    generation (prompt + new tokens, rounded) in one allocation."""
    hidden, (k, v) = forward(cfg, params, input_ids, seg_ids, positions,
                             return_kv=True, attention_fn=attention_fn)
    b, lp = input_ids.shape
    total = round_cache_len(total_len if total_len is not None else lp)
    cache = init_kv_cache(cfg, b, total, dtype=k.dtype, device=k.device)
    # [nl, B, L, nkv, hd] -> head-major [nl, B, nkv, L, hd]
    cache["k"][:, :, :, :lp] = k.transpose(2, 3)
    cache["v"][:, :, :, :lp] = v.transpose(2, 3)
    cache["valid"][:, :lp] = seg_ids != 0
    cache["length"].fill_(lp)
    return hidden, cache


def decode_step(cfg: TransformerConfig, params: Params, cache: KVCache,
                token: torch.Tensor, positions: torch.Tensor,
                uniform_slot: bool = False, mesh=None
                ) -> Tuple[torch.Tensor, KVCache]:
    """Feed ``token`` [B] at ``positions`` [B]; return the hidden state
    [B, H] for the next token's logits and the cache.

    The cache is updated IN PLACE: each layer writes its new K/V into
    slot ``cache["length"]`` of the stacked cache (the counterpart of
    the JAX package's ``dynamic_update_slice`` / scatter writes, which
    XLA aliases in place), and the slot is marked valid. The returned
    dict shares ``k``, ``v`` and ``valid`` with the input one.

    ``uniform_slot``: every stream writes the same slot (batch
    generation, where all streams share the padded prompt length), so
    the write is one ``index_copy_`` along the slot axis; otherwise each
    stream writes its own slot."""
    if mesh is not None:
        raise NotImplementedError(
            "sharded decode is deferred to the parallelism slice of the "
            "port.")
    check_supported(cfg)
    b = token.shape[0]
    slot = cache["length"]
    rows = torch.arange(b, device=token.device)
    x = _embed(cfg, params, token.long(), positions)
    cos, sin = _rotary_tables(cfg, positions)

    valid = cache["valid"]
    if uniform_slot:
        s0 = slot[:1].long()
        valid.index_fill_(1, s0, True)
    else:
        valid[rows, slot.long()] = True
    k_all, v_all = cache["k"], cache["v"]
    stacked = cfg.n_layers > _DECODE_UNROLL_MAX_LAYERS
    base = cfg.head_dim ** -0.5 if cfg.scale_attn_weights else 1.0

    for li, lp in enumerate(layer_views(params["blocks"], cfg.n_layers)):
        # q [B, nq, hd]; k/v [B, nkv, hd]
        q, k, v = _attn_in(cfg, lp, x, cos, sin)
        # In-place slot write into the stacked cache: replaces the
        # dynamic_update_slice / scatter of realhf_tpu/models/
        # transformer.py:618-626 without copying the cache.
        if uniform_slot:
            k_all[li].index_copy_(2, s0, k[:, :, None, :].to(k_all.dtype))
            v_all[li].index_copy_(2, s0, v[:, :, None, :].to(v_all.dtype))
        else:
            k_all[li, rows, :, slot.long()] = k.to(k_all.dtype)
            v_all[li, rows, :, slot.long()] = v.to(v_all.dtype)
        scale = (base / (li + 1) if cfg.scale_attn_by_inverse_layer_idx
                 else base)
        if stacked:
            attn = stacked_decode_attention(
                q, k_all, v_all, valid, li, scale=scale,
                sliding_window=cfg.sliding_window, slot=slot)
        else:
            attn = decode_attention(q, k_all[li], v_all[li], valid,
                                    scale=scale,
                                    sliding_window=cfg.sliding_window,
                                    slot=slot)
        x = _attn_out(cfg, lp, x, attn)
    x = _norm(cfg, x, params["ln_f"]["scale"], params["ln_f"].get("bias"))
    new_cache = {"k": k_all, "v": v_all, "valid": valid,
                 "length": slot + 1}
    return x, new_cache
