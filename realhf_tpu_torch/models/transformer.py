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
projections and MLP are ``torch.matmul``. Under autograd with
``cfg.gradient_checkpointing`` each block is recomputed in the backward
from its input (``torch.utils.checkpoint``), as the JAX package's
``jax.checkpoint(..., policy=nothing_saveable)`` does.

Data and tensor parallelism: given a ``models/sharding.MemberParams``
(one tree per member of a ``dNtM`` layout) in place of a tree,
``forward``, ``prefill``, ``decode_step``, ``lm_logits`` and
``critic_values`` split the streams into ``d`` contiguous row groups,
one per data group, and run each group over its ``t`` model members:
the vocab-parallel embedding (each member looks up its own rows, zeroes
the rest, then an all-reduce), column-parallel q/k/v/gate/up with
rotary and attention (K1, K4) on the member's own heads, row-parallel
``wo``/``wd`` whose partial outputs are summed over the model group
(``_row_parallel``), and the LM head by vocabulary shard. Hidden states
come back as a ``MemberHidden``; a decode cache is one ``KVCache`` per
member over its ``nkv / t`` heads.

When ``t`` does not divide the KV heads (``nkv`` must divide ``t``), the
KV weights are replicated on every model member and member j computes
the one KV head its query heads read (``member_views``), so prefill and
training run K1-K3 per member on its own heads; the decode takes the
JAX package's "seq" route instead: member j's cache holds slots ``[j
S/t, (j+1) S/t)`` of every KV head (``offset`` in the cache dict), the
owner of a step's slot writes its K/V (computed from the replicated
weights, all heads), q is gathered over the members, each member runs
K4 with its softmax statistics over its slice, and the partials merge
(``ops/decode_attention.seqsplit_merge``). A MoE model over members
runs each member's slice of every expert's FFN width on the same
routing (every member routes the same replicated input itself), its
data groups and context shards routed as one batch
(``ops/moe.MoEShards``), and under expert parallelism each member holds
``E / d`` experts and sends each shard's buffer to their owners.

Pipeline parallelism: given a ``MemberParams`` of ``p > 1`` stages (or a
tree and a ``pipeline=`` context), ``forward`` embeds on the first
stage's members, runs the block slabs through the schedule
(``parallel/pipeline.py`` GPipe, or ``parallel/schedule.py`` 1F1B when
the context says so and autograd is on), each stage-tick a slab of
``_block`` (t = 1, dense), ``_block_members`` (t > 1, or a MoE model)
or ``_sp_block`` (with ``sp``: the stage boundary passes each model
member's token shard) on the stage's members, and applies the final
norm on the last stage's members, whose trees the heads then use. A MoE
model's pipelined microbatch is the JAX package's, over every data
group's rows of it (``_forward_members_pipeline``); its stage-ticks hand
out router sums, from which the losses are formed per microbatch and
weighted by its real-stream share (``_pipeline_router_losses``, on a
tree too). A prefill
(``return_kv``) or a decode step at p > 1 raises: generation goes
through the engine's decode view.

Context and sequence parallelism (``forward_ctx``, for a ``MemberParams``
of ``c > 1`` or with ``sp``): member ``(g, c, j)`` holds data group g's
streams' contiguous token shard c (the streams padded with segment id 0
to a multiple of ``8 c`` tokens, ``8 c t`` with ``sp``) and model slice
j. Each layer runs the first half of the block on every member, the
ring over the C members of each model index (``ring_attention_fused``,
differentiable: K6 forward, K2/K3 per round backward), then ``wo`` and
the MLP with their row-parallel sums over the model members. With
``sp`` the residual of a model group is split again along its tokens
over the model members, the JAX package's ``P(DATA, (CTX, MODEL),
None)``: each row-parallel sum is a reduce-scatter (the same sums as
the all-reduce, then sliced, so the values equal those without ``sp``),
the norms run on the shard, and an all-gather comes before the q/k/v and
the MLP's up projections. The final hidden states are gathered along
the tokens onto each model member of context index 0, where the heads
run. Under gradient checkpointing each member's half-blocks are
checkpointed on their own and the ring and the sums lie outside every
checkpoint region, so the recompute launches no K6; with ``s`` alone
(c = 1) each member's attention half, K1 included, is one region, as on
the d x t path.
"""

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.models.sharding import MemberParams
from realhf_tpu_torch.ops import decode_attention as _decode
from realhf_tpu_torch.ops.attention import (
    decode_attention,
    kv_replicated,
    member_heads,
    packed_attention,
    stacked_decode_attention,
)
from realhf_tpu_torch.ops.moe import (
    MoEShard,
    MoEShards,
    moe_mlp_with_losses,
    ragged_dispatch_enabled,
    route_counts,
    router_losses,
)
from realhf_tpu_torch.ops.ring_attention_fused import ring_attention_fused
from realhf_tpu_torch.ops.rotary import apply_rotary, rotary_freqs
from realhf_tpu_torch.parallel import collectives as C
from realhf_tpu_torch.parallel.pipeline import (
    ONE_F_ONE_B,
    microbatch_weights,
    pipeline_blocks,
)
from realhf_tpu_torch.parallel.schedule import pipeline_blocks_1f1b

Params = Dict[str, Any]
KVCache = Dict[str, torch.Tensor]


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def check_supported(cfg: TransformerConfig):
    """Raise for model features the port leaves out so far."""
    if cfg.mlp_type == "moe" and cfg.moe.input_jitter_eps:
        raise NotImplementedError(
            "MoE router input jitter needs a generator threaded through "
            "the forward, which the JAX package has not wired either: "
            "ROADMAP.md, queue 1, item 3.")


def check_expert_parallel(cfg: TransformerConfig, d: int):
    """The JAX engine's refusals of expert parallelism
    (``realhf_tpu/engine/engine.py:113-130``), with its messages."""
    if not (cfg.mlp_type == "moe" and cfg.moe.expert_parallel):
        return
    if ragged_dispatch_enabled(cfg):
        raise ValueError(
            "MoEConfig.expert_parallel requires the capacity "
            "or dense dispatch mode (set capacity_factor, or "
            "use_grouped_gemm=False); ragged grouped GEMMs "
            "cannot shard the expert group dim.")
    if cfg.moe.num_experts % d != 0:
        raise ValueError(
            f"expert_parallel needs num_experts "
            f"({cfg.moe.num_experts}) divisible by "
            f"data_parallel_size ({d}).")


def check_layout(cfg: TransformerConfig, t: int):
    """Raise for what a layout of ``t`` model members cannot run: query
    heads or widths ``t`` does not divide, and KV heads that neither
    divide nor are divided by ``t`` (``ops/attention.member_heads``)."""
    check_supported(cfg)
    if t == 1:
        return
    member_heads(cfg.n_q_heads, cfg.n_kv_heads, t)
    if cfg.intermediate_dim % t:
        raise ValueError(f"t={t} does not divide the MLP width "
                         f"{cfg.intermediate_dim}.")


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
    if cfg.mlp_type == "moe":
        ne = cfg.moe.num_experts
        mlp["router"] = norm((nl, h, ne))
        mlp["wg"] = norm((nl, ne, h, f))
        mlp["wu"] = norm((nl, ne, h, f))
        mlp["wd"] = norm((nl, ne, f, h), proj_std)
    else:
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


def member_views(cfg: TransformerConfig, tree: Params, j: int, t: int
                 ) -> List[Params]:
    """Model member ``j`` of ``t``'s layer views for its attention and
    MLP: ``layer_views``, with replicated KV weights (``t`` not dividing
    the KV heads) narrowed to the columns of the one KV head its query
    heads read (``member_heads``), so the member computes that head
    alone and the other columns get no gradient from it."""
    views = layer_views(tree["blocks"], _slab_len(tree))
    if not kv_replicated(cfg.n_kv_heads, t):
        return views
    _, (k0, k1) = member_heads(cfg.n_q_heads, cfg.n_kv_heads, t, j)
    hd = cfg.head_dim
    for lp in views:
        a = dict(lp["attn"])
        for name in ("wk", "wv", "bk", "bv"):
            if name in a:
                a[name] = a[name].narrow(-1, k0 * hd, (k1 - k0) * hd)
        lp["attn"] = a
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


def _mlp_with_aux(cfg: TransformerConfig, lp: Params, x: torch.Tensor,
                  seg_ids: Optional[torch.Tensor] = None,
                  shard: Optional[MoEShard] = None, out_bias: bool = True):
    """MLP -> (output, aux-loss dict); the dict is non-empty only for
    mixture-of-experts models (router load-balancing / z losses).
    ``seg_ids`` keeps padding out of MoE routing, capacity and losses;
    a decode step's ``x`` is [B, H] and routes every row. ``shard``
    makes the MoE call one token shard of a batch (``ops/moe.py``
    ``MoEShards``); ``out_bias=False`` leaves a dense ``bd`` to the
    caller (a model member's output is a partial sum)."""
    if cfg.mlp_type == "moe":
        squeeze = x.ndim == 2
        x3 = x[:, None, :] if squeeze else x
        valid = None if seg_ids is None else seg_ids != 0
        out, aux = moe_mlp_with_losses(cfg, lp["mlp"], x3, valid_mask=valid,
                                       shard=shard)
        return (out[:, 0] if squeeze else out), aux
    return _dense_mlp(cfg, lp["mlp"], x, dtype_of(cfg.compute_dtype),
                      out_bias), {}


def _dense_mlp(cfg, m, x, cdt, out_bias=True):
    """The dense MLP; ``out_bias=False`` leaves ``bd`` to the caller (a
    model member's output is a partial sum)."""
    if cfg.gated_mlp:
        gate = x @ m["wg"].to(cdt)
        up = x @ m["wu"].to(cdt)
        return (_activation(cfg, gate) * up) @ m["wd"].to(cdt)
    up = x @ m["wu"].to(cdt)
    if "bu" in m:
        up = up + m["bu"].to(cdt)
    out = _activation(cfg, up) @ m["wd"].to(cdt)
    if "bd" in m and out_bias:
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
    # the head counts follow the weights: a model member's column
    # shards hold nq / t and nkv / t heads
    q = q.reshape(*lead, -1, cfg.head_dim)
    k = k.reshape(*lead, -1, cfg.head_dim)
    v = v.reshape(*lead, -1, cfg.head_dim)
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
    return _qkv_rotary(cfg, lp, _norm(cfg, x, lp["ln1"]["scale"],
                                      lp["ln1"].get("bias")), cos, sin)


def _qkv_rotary(cfg: TransformerConfig, lp: Params, ln1: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor):
    """``_attn_in`` after the norm."""
    q, k, v = _qkv(cfg, lp, ln1)
    if cfg.apply_rotary:
        q = apply_rotary(q, cos, sin, cfg.rotary_interleaved)
        k = apply_rotary(k, cos, sin, cfg.rotary_interleaved)
    return q, k.contiguous(), v.contiguous()


def _attn_out(cfg: TransformerConfig, lp: Params, x: torch.Tensor,
              attn: torch.Tensor, seg_ids: Optional[torch.Tensor] = None):
    """The block after attention: output projection and residual, norm,
    MLP and residual -> (the block's output [B, L, H], the MLP's aux
    losses)."""
    attn = attn.reshape(*x.shape[:-1], cfg.n_q_heads * cfg.head_dim)
    proj = attn @ lp["attn"]["wo"].to(x.dtype)
    if "bo" in lp["attn"]:
        proj = proj + lp["attn"]["bo"].to(x.dtype)
    x = x + proj
    ln2 = _norm(cfg, x, lp["ln2"]["scale"], lp["ln2"].get("bias"))
    out, aux = _mlp_with_aux(cfg, lp, ln2, seg_ids)
    return x + out, aux


def _block(cfg: TransformerConfig, lp: Params, layer_idx: int,
           x: torch.Tensor, seg_ids: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor, attention_fn=None):
    """One block over packed streams [B, L, H] -> (residual output,
    (k, v), aux losses); k/v feed the prefill KV cache."""
    q, k, v = _attn_in(cfg, lp, x, cos, sin)
    attn_impl = attention_fn or packed_attention
    attn = attn_impl(q, k, v, seg_ids, causal=True,
                     scale=_attn_scale(cfg, layer_idx),
                     sliding_window=cfg.sliding_window)
    x, aux = _attn_out(cfg, lp, x, attn, seg_ids)
    return x, (k, v), aux


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
            return_kv: bool = False, return_aux: bool = False,
            attention_fn=None, pipeline=None):
    """Packed forward -> (final hidden states [B, L, H] after the final
    norm, kvs), and with ``return_aux`` a third item: each MoE aux loss
    summed over the layers (empty for a dense model). ``kvs`` is ``(k,
    v)`` stacked ``[n_layers, B, L, nkv, hd]`` when ``return_kv``, else
    None. Heads apply separately (``lm_logits``, ``critic_values``).
    ``pipeline`` (a ``parallel/pipeline.PipelineContext``) runs the
    blocks as that pipeline, its stages slabs of the one tree on its
    device (a ``MemberParams`` of p > 1 stages brings its own); the aux
    losses are then weighted per microbatch.

    Under gradient checkpointing a block's recompute routes its tokens
    as the first pass did: the same inputs through the same
    deterministic operations (fp32 router, stable sort, and a combine
    whose top-2 adds onto 0 commute), and ``torch.utils.checkpoint``
    raises if a recomputed tensor's shape differs, as an expert's slice
    would."""
    if isinstance(params, MemberParams):
        return forward_members(cfg, params, input_ids, seg_ids, positions,
                               return_kv=return_kv, return_aux=return_aux,
                               attention_fn=attention_fn, pipeline=pipeline)
    check_supported(cfg)
    seg_ids = seg_ids.to(torch.int32)
    if positions is None:
        positions = positions_from_segments(seg_ids)
    x = _embed(cfg, params, input_ids.long(), positions)
    cos, sin = _rotary_tables(cfg, positions)
    if pipeline is not None:
        _check_pipelined(cfg, pipeline, return_kv)
        per = cfg.n_layers // pipeline.n_stages
        stages = [([{"blocks": _tree_narrow(params["blocks"], s * per, per)}],
                   [x.device]) for s in range(pipeline.n_stages)]
        moes, weights = _microbatch_moes(
            cfg, x.shape[0], x.shape[1], pipeline.n_microbatches,
            lambda n: MoEShards(n, 1, x.device))
        hs, sums = _run_pipeline(cfg, pipeline, stages, [x], seg_ids, cos,
                                 sin, attention_fn, moes=moes)
        aux_sum = _pipeline_router_losses(cfg, sums, weights)
        x, kvs = hs[0], None
    else:
        kv = ([], []) if return_kv else None
        x, aux_sum = _layers(cfg, layer_views(params["blocks"], cfg.n_layers),
                             0, x, seg_ids, cos, sin, attention_fn, kv)
        kvs = (torch.stack(kv[0]), torch.stack(kv[1])) if return_kv else None
    x = _norm(cfg, x, params["ln_f"]["scale"], params["ln_f"].get("bias"))
    if return_aux:
        return x, kvs, aux_sum
    return x, kvs


def _layers(cfg, views, first, x, seg_ids, cos, sin, attention_fn, kv=None):
    """Layers ``first, first + 1, ...`` (their weights ``views``) on one
    tree -> (the residual, each aux loss summed over the layers);
    appends each layer's k/v to ``kv`` when given. Under autograd with
    gradient checkpointing each block is recomputed in the backward."""
    aux_sum: Dict[str, torch.Tensor] = {}
    remat = cfg.gradient_checkpointing and torch.is_grad_enabled()
    for i, lp in enumerate(views):
        li = first + i
        if remat:
            x, (k, v), aux = checkpoint(_block, cfg, lp, li, x, seg_ids, cos,
                                        sin, attention_fn,
                                        use_reentrant=False)
        else:
            x, (k, v), aux = _block(cfg, lp, li, x, seg_ids, cos, sin,
                                    attention_fn)
        if kv is not None:
            kv[0].append(k)
            kv[1].append(v)
        for name, val in aux.items():
            aux_sum[name] = aux_sum[name] + val if name in aux_sum else val
    return x, aux_sum


# ----------------------------------------------------------------------
# Pipeline parallelism
# ----------------------------------------------------------------------
def _tree_narrow(tree, start: int, n: int):
    return {k: (_tree_narrow(v, start, n) if isinstance(v, dict)
                else v.narrow(0, start, n)) for k, v in tree.items()}


def _check_pipelined(cfg: TransformerConfig, pipe, return_kv: bool):
    if return_kv:
        raise ValueError(
            "a KV-cache prefill on a pipeline layout: generation runs on "
            "the engine's decode view (Engine.decode_engine).")
    if cfg.n_layers % pipe.n_stages:
        raise ValueError(f"n_layers={cfg.n_layers} does not split into "
                         f"{pipe.n_stages} pipeline stages.")


def _stage_step(cfg: TransformerConfig, attention_fn, sp: bool = False,
                moes=None, g: int = 0):
    """The pipeline's ``block_step``: stage s's slab of ``n_layers / S``
    blocks (global layer indices) on microbatch m, over the stage's
    model members. With ``sp`` each member holds a token shard of the
    residual and every block is ``_sp_block`` (the boundary passes the
    shards). ``moes`` (a MoE model, on one tree or over members): each
    microbatch's ``MoEShards``, which routes data group ``g``'s rows of
    it together with the other groups' rows; the aux values are the
    stage's router sums of the microbatch, keyed ``"layer/name"``, from
    which the caller forms the losses (``_pipeline_router_losses``)."""

    def step(s, trees, xs, segs, coss, sins, m=0):
        views = [member_views(cfg, tr, j, len(trees))
                 for j, tr in enumerate(trees)]
        first = s * len(views[0])
        if len(trees) == 1 and moes is None:  # dense: no aux values
            y, _ = _layers(cfg, views[0], first, xs[0], segs[0], coss[0],
                           sins[0], attention_fn)
            return [y], {}
        remat = cfg.gradient_checkpointing and torch.is_grad_enabled()
        devs = [x.device for x in xs]
        tables = list(zip(coss, sins))
        moe = None if moes is None else moes[m]
        layers = range(first, first + len(views[0]))
        for i, li in enumerate(layers):
            lps = [v[i] for v in views]
            route = None if moe is None else (moe, li, (g, 0))
            if sp:
                xs, _ = _sp_block(cfg, lps, li, xs, segs, tables, devs,
                                  attention_fn, _remat if remat else _call,
                                  route)
            else:
                xs, _ = _block_members(cfg, lps, li, xs, segs, tables, devs,
                                       attention_fn, remat, route)
        return xs, {} if moe is None else moe.layer_sums(layers, (g, 0))

    return step


def _slab_len(tree) -> int:
    return tree["blocks"]["ln1"]["scale"].shape[0]


def _run_pipeline(cfg, pipe, stages, xs, seg_ids, cos, sin, attention_fn,
                  sp=False, moes=None, g=0, mb_rows=None, ep=False):
    """The blocks over ``stages`` by ``pipe``'s schedule: 1F1B's own
    backward when it is asked for and autograd is on, else GPipe (with
    each stage-tick checkpointed as a whole under ``pipeline_remat ==
    "tick"`` and gradient checkpointing). Under expert parallelism
    (``ep``) a member's MLP reaches the other data indices' experts,
    whose leaves no stage's custom backward node returns gradients for:
    it trains under GPipe on autograd's graph, block checkpoints only."""
    step = _stage_step(cfg, attention_fn, sp, moes, g)
    kw = dict(return_aux=True, mb_rows=mb_rows)
    if pipe.schedule == ONE_F_ONE_B and torch.is_grad_enabled():
        if ep:
            raise NotImplementedError(
                "expert parallelism inside a pipeline trains under GPipe "
                "(pipeline_schedule='gpipe'): the 1F1B backward cannot "
                "return the other data indices' expert gradients.")
        return pipeline_blocks_1f1b(pipe, stages, xs, seg_ids, cos, sin,
                                    step, **kw)
    remat_tick = (cfg.gradient_checkpointing and cfg.pipeline_remat == "tick"
                  and torch.is_grad_enabled() and not ep)
    return pipeline_blocks(pipe, stages, xs, seg_ids, cos, sin, step,
                           remat_tick=remat_tick, **kw)


def _forward_pipeline(cfg, mp: MemberParams, pipe, g, ids, seg, pos,
                      attention_fn, moes=None, mb_rows=None):
    """Data group ``g``'s forward over its stages -> (the last stage's
    members' final hidden states, aux). Under sequence parallelism the
    embedding reduce-scatters onto the members' token shards, the
    stages pass the shards, and the final norm runs on them before an
    all-gather."""
    stages = mp.stages(g)
    trees0, devs0 = stages[0]
    sp = mp.sp and mp.t > 1
    if mp.t == 1:
        dev = devs0[0]
        xs = [_embed(cfg, trees0[0], ids.to(dev).long(), pos.to(dev))]
    else:
        xs = _embed_members(cfg, trees0, devs0, C.broadcast(ids, devs0),
                            C.broadcast(pos, devs0), mp.vocab_starts(cfg),
                            sp=sp)
    dev = devs0[0]
    pos0 = pos.to(dev)
    cos, sin = _rotary_tables(cfg, pos0)
    hs, aux = _run_pipeline(cfg, pipe, stages, xs, seg.to(dev), cos, sin,
                            attention_fn, sp, moes, g, mb_rows, mp.ep)
    trees, devs = stages[-1]
    fin = [_norm(cfg, h, tr["ln_f"]["scale"], tr["ln_f"].get("bias"))
           for tr, h in zip(trees, hs)]
    return (C.all_gather(fin, devs, dim=1) if sp else fin), aux


def _forward_members_pipeline(cfg, mp: MemberParams, pipe, ids, seg, pos,
                              return_aux, attention_fn):
    """``forward_members`` at p > 1: each data group's rows through its
    stages (``_forward_pipeline``); under sequence parallelism the
    streams are padded to a multiple of 8t and cut back after. A MoE
    model's microbatch m is the JAX package's: rows ``[m Bm, (m + 1)
    Bm)`` of the whole batch (Bm = ceil(S / M), the last rows
    padding), whichever data groups hold them. Each group runs its share
    of every microbatch; one ``MoEShards`` per microbatch routes the
    shares as one set (capacity over Bm * L tokens, queue positions
    group after group), and each microbatch's router losses, formed from
    every group's sums, weigh by its real-stream share
    (``microbatch_weights``)."""
    n_real = ids.shape[1]
    sp = mp.sp and mp.t > 1
    pad = -n_real % (8 * mp.t) if sp else 0
    if pad:
        ids, seg, pos = (F.pad(a, (0, pad)) for a in (ids, seg, pos))
    n, n_mb = ids.shape[0], pipe.n_microbatches
    moes, weights = _microbatch_moes(cfg, n, n_real, n_mb,
                                     lambda k: _moe_shards(cfg, mp, k))
    bm = -(-n // n_mb)
    rows = data_rows(n, mp.d)
    hs, sums = [], {}
    for g, (r0, r1) in enumerate(rows):
        if r1 == r0:
            hs.append(None)
            continue
        mb_rows = None if moes is None else [
            (min(max(m * bm, r0), r1) - r0, min(max((m + 1) * bm, r0), r1)
             - r0) for m in range(n_mb)]
        h, aux = _forward_pipeline(
            cfg, mp, pipe, g, *(a[r0:r1] for a in (ids, seg, pos)),
            attention_fn, moes, mb_rows)
        hs.append([x[:, :n_real] for x in h] if pad else h)
        for k, v in aux.items():
            v = v.to(mp.devices[0])
            sums[k] = sums[k] + v if k in sums else v
    out = MemberHidden(hs, rows), None
    if not return_aux:
        return out
    return (*out, _pipeline_router_losses(cfg, sums, weights))


def _microbatch_moes(cfg, n: int, width: int, n_mb: int, make):
    """A MoE model's pipelined batch of ``n`` streams of ``width``
    tokens -> (one ``make(Bm * width)`` a microbatch, each microbatch's
    real-stream share (``microbatch_weights``)), Bm = ceil(n / M); (None,
    None) for a dense model."""
    if cfg.mlp_type != "moe":
        return None, None
    bm = -(-n // n_mb)
    return ([make(bm * width) for _ in range(n_mb)],
            microbatch_weights(n, bm, n_mb))


def _pipeline_router_losses(cfg, sums, weights) -> Dict[str, torch.Tensor]:
    """Each router loss of a pipelined batch: per (microbatch, layer)
    from the router sums ``sums[(m, "layer/name")]`` (every data group's
    added), weighted by the microbatch's real-stream share, summed over
    layers and microbatches (none for a dense model, whose ``sums`` are
    empty)."""
    by: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}
    for (m, key), v in sums.items():
        li, name = key.split("/")
        by.setdefault((m, int(li)), {})[name] = v
    out: Dict[str, torch.Tensor] = {}
    for m, li in sorted(by):
        for name, val in router_losses(cfg.moe, by[(m, li)]).items():
            val = val * float(weights[m])
            out[name] = out[name] + val if name in out else val
    return out


def forward_ctx(cfg: TransformerConfig, mp: MemberParams,
                input_ids: torch.Tensor, seg_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None, *,
                return_kv: bool = False, return_aux: bool = False,
                attention_fn=None):
    """``forward`` over a ``dNcCtM[s]`` layout (``mp.c > 1`` or
    ``mp.sp``; the module note): ``[S, L]`` inputs on any device ->
    (``MemberHidden`` at L, per-member (k, v) or None[, aux]). Positions
    come from the whole streams. ``attention_fn`` replaces the ring at
    c > 1 (it takes the C members' shards), packed attention at c = 1.
    A prefill (``return_kv``) at c > 1 raises (generation runs on the
    engine's decode view). A MoE model routes the data and context
    shards as the JAX package routes the whole batch (``ops/moe.py``
    ``MoEShards``): capacity and queue positions over the unpadded
    ``S * L`` tokens, and the router losses from every shard's sums."""
    c = mp.c
    if mp.p > 1:
        raise NotImplementedError(
            "pipeline parallelism cannot be combined with context "
            "parallelism (ring attention) yet; use pp x tp x dp or "
            "cp x tp x dp.")
    if return_kv and c > 1:
        raise ValueError(
            "a KV-cache prefill on a context-parallel layout: generation "
            "runs on the engine's decode view (Engine.decode_engine).")
    seg_ids = seg_ids.to(torch.int32)
    if positions is None:
        positions = positions_from_segments(seg_ids)
    n_real = input_ids.shape[1]
    moe = _moe_shards(cfg, mp, input_ids.shape[0] * n_real)
    mult = 8 * c * (mp.t if mp.sp else 1)
    pad = -n_real % mult
    if pad:
        input_ids, seg_ids, positions = (
            F.pad(a, (0, pad)) for a in (input_ids, seg_ids, positions))
    rows = data_rows(input_ids.shape[0], mp.d)
    hs, kvs = [], []
    for g, (r0, r1) in enumerate(rows):
        if r1 == r0:
            hs.append(None)
            kvs.extend([None] * (c * mp.t))
            continue
        h, kv = _forward_ctx_group(
            cfg, mp, g, *(a[r0:r1] for a in (input_ids, seg_ids, positions)),
            return_kv, attention_fn, moe)
        hs.append([x[:, :n_real] for x in h])
        kvs.extend(kv if kv is not None else [None] * (c * mp.t))
    out = MemberHidden(hs, rows), (kvs if return_kv else None)
    if not return_aux:
        return out
    return (*out, moe.losses(cfg.moe) if moe is not None else {})


def _forward_ctx_group(cfg, mp: MemberParams, g, ids, seg, pos, return_kv,
                       attention_fn, moe=None):
    """Data group ``g``'s padded rows over its C x t members -> (each
    model member's final hidden states over the whole padded streams, on
    member (g, 0, j), and each member's stacked (k, v) at c = 1 when
    ``return_kv``)."""
    n_c, t = mp.c, mp.t
    sp = mp.sp and t > 1
    at = [[mp.index(g, ci, j, 0) for j in range(t)] for ci in range(n_c)]
    trees = [[mp.trees[i] for i in row] for row in at]
    devs = [[mp.devices[i] for i in row] for row in at]
    starts = mp.vocab_starts(cfg)
    views = {}
    for row in trees:
        for j, tr in enumerate(row):
            if (id(tr), j) not in views:
                views[(id(tr), j)] = member_views(cfg, tr, j, t)
    layers = [[views[(id(tr), j)] for j, tr in enumerate(row)]
              for row in trees]
    shard = [a.chunk(n_c, dim=1) for a in (ids, seg, pos)]
    segs = [C.broadcast(shard[1][ci].contiguous(), devs[ci])
            for ci in range(n_c)]
    poss = [C.broadcast(shard[2][ci], devs[ci]) for ci in range(n_c)]
    xs = [_embed_members(cfg, trees[ci], devs[ci],
                         C.broadcast(shard[0][ci], devs[ci]), poss[ci],
                         starts, sp=sp) for ci in range(n_c)]
    tables = [[_rotary_tables(cfg, p) for p in row] for row in poss]
    remat = cfg.gradient_checkpointing and torch.is_grad_enabled()
    run = _remat if remat else _call
    kvs = [[([], []) for _ in range(t)] for _ in range(n_c)]
    for li in range(cfg.n_layers):
        lps = [[lv[li] for lv in row] for row in layers]
        if n_c == 1:  # sequence parallelism alone: no ring
            xs[0], kv = _sp_block(cfg, lps[0], li, xs[0], segs[0],
                                  tables[0], devs[0], attention_fn, run,
                                  (moe, li, (g, 0)))
            if return_kv:
                for acc, (k, v) in zip(kvs[0], kv):
                    acc[0].append(k)
                    acc[1].append(v)
            continue
        qkv = []
        for ci in range(n_c):
            if sp:  # the norm on the shard, then the all-gather
                lns = C.all_gather(
                    [run(_norm, cfg, x, lp["ln1"]["scale"],
                         lp["ln1"].get("bias"))
                     for lp, x in zip(lps[ci], xs[ci])], devs[ci], dim=1)
                qkv.append([run(_qkv_rotary, cfg, lp, h, cos, sin)
                            for lp, h, (cos, sin) in
                            zip(lps[ci], lns, tables[ci])])
            else:
                qkv.append([run(_attn_in, cfg, lp, x, cos, sin)
                            for lp, x, (cos, sin) in
                            zip(lps[ci], xs[ci], tables[ci])])
        attn = _ring_attention(cfg, li, qkv, segs, attention_fn)
        # one region of wo and a dense MLP; a MoE model's shards all
        # route (``_register_routes``) before any of them dispatches
        whole = t == 1 and not sp and moe is None
        for ci in range(n_c):
            if whole:
                xs[ci] = [run(_attn_out, cfg, lps[ci][0], xs[ci][0],
                              attn[ci][0], segs[ci][0])[0]]
                continue
            parts = [run(_attn_proj, lp, x, a)
                     for lp, x, a in zip(lps[ci], xs[ci], attn[ci])]
            xs[ci] = _add_reduced(xs[ci], parts, [lp["attn"].get("bo")
                                                  for lp in lps[ci]],
                                  devs[ci], sp)
        if whole:
            continue
        if moe is not None:
            _register_routes(cfg, moe, li, g, lps, xs, segs, devs, sp)
        for ci in range(n_c):
            xs[ci] = _mlp_members(cfg, lps[ci], devs[ci], xs[ci], run, sp,
                                  segs[ci], moe and (moe, li, (g, ci)))
    hs = []
    for j in range(t):
        col = []
        for ci in range(n_c):
            fin = [_norm(cfg, x, tr["ln_f"]["scale"], tr["ln_f"].get("bias"))
                   for tr, x in zip(trees[ci], xs[ci])]
            if sp:
                fin = C.all_gather(fin, devs[ci], dim=1)
            col.append(fin[j])
        hs.append(col[0] if n_c == 1 else
                  torch.cat([h.to(devs[0][j]) for h in col], dim=1))
    if not return_kv:
        return hs, None
    return hs, [(torch.stack(k), torch.stack(v))
                for row in kvs for k, v in row]


def _sp_block(cfg, lps, layer_idx, xs, segs, tables, devs, attention_fn,
              run, moe=None):
    """One block over a model group whose residual is split along the
    tokens (``sp``, no ring) -> (the members' residual shards, each
    member's (k, v)): the norm on the shard, an all-gather, then each
    member's attention half in its own checkpoint region (K1 recomputed,
    as ``_block_members``), a reduce-scatter, and the MLP half. A MoE
    route ``moe`` is the group's one shard, which registers its expert
    counts as it dispatches (only context shards of one group must all
    register first, ``_register_routes``)."""
    lns = C.all_gather([run(_norm, cfg, x, lp["ln1"]["scale"],
                                lp["ln1"].get("bias"))
                        for lp, x in zip(lps, xs)], devs, dim=1)
    outs = [run(_attn_partial_normed, cfg, lp, layer_idx, h, seg, cos, sin,
                attention_fn or packed_attention)
            for lp, h, seg, (cos, sin) in zip(lps, lns, segs, tables)]
    xs = _add_reduced(xs, [o[0] for o in outs],
                      [lp["attn"].get("bo") for lp in lps], devs, True)
    return (_mlp_members(cfg, lps, devs, xs, run, True, segs,
                         moe if moe and moe[0] is not None else None),
            [o[1:] for o in outs])


def _attn_proj(lp, x, attn):
    """A member's ``wo`` partial of its heads' attention output (over the
    whole shard; ``x`` is the residual, perhaps its ``sp`` slice)."""
    return attn.flatten(-2) @ lp["attn"]["wo"].to(x.dtype)


def _ring_attention(cfg, li, qkv, segs, attention_fn):
    """Layer ``li``'s attention of every member: ``qkv[c][j]`` -> the
    outputs ``[c][j]``, one ring per model index over the C members
    (``ring_attention_fused`` unless ``attention_fn``)."""
    n_c, t = len(qkv), len(qkv[0])
    ring = attention_fn or ring_attention_fused
    out = [[None] * t for _ in range(n_c)]
    for j in range(t):
        q, k, v = ([qkv[ci][j][w] for ci in range(n_c)] for w in range(3))
        for ci, o in enumerate(ring(
                q, k, v, [segs[ci][j] for ci in range(n_c)], causal=True,
                scale=_attn_scale(cfg, li),
                sliding_window=cfg.sliding_window)):
            out[ci][j] = o
    return out


# ----------------------------------------------------------------------
# Data and tensor parallelism over the members of one process
# ----------------------------------------------------------------------
@dataclasses.dataclass
class MemberHidden:
    """Hidden states of a ``MemberParams`` forward: ``rows[g]`` is the
    (start, stop) of data group g's streams in the whole batch and
    ``hs[g][j]`` model member j's copy of them (replicated values, on
    its device); a group with no rows has ``hs[g] = None``."""
    hs: List[Optional[List[torch.Tensor]]]
    rows: List[Tuple[int, int]]

    def map(self, fn) -> "MemberHidden":
        return MemberHidden([None if h is None else [fn(x) for x in h]
                             for h in self.hs], self.rows)


def data_rows(n: int, d: int) -> List[Tuple[int, int]]:
    """Contiguous row ranges of ``n`` streams over ``d`` data groups,
    the first ``n % d`` one row longer (an uneven split is allowed)."""
    out, r = [], 0
    for g in range(d):
        k = n // d + (1 if g < n % d else 0)
        out.append((r, r + k))
        r += k
    return out


def _row_parallel(parts: List[torch.Tensor],
                  devs: List[torch.device]) -> List[torch.Tensor]:
    """The row-parallel ``wo``/``wd`` partial outputs summed over the
    model group: every member gets the sum."""
    return C.all_reduce(parts, devs)


def _embed_members(cfg, trees, devs, ids_m, pos_m, starts, sp=False):
    """The vocab-parallel embedding: each member looks up its own rows
    of ``wte`` and zeroes the others, an all-reduce sums them (with
    ``sp`` a reduce-scatter along the tokens), then the replicated
    position table and scale apply per member. A single member (t = 1)
    takes ``_embed``."""
    if len(trees) == 1:
        return [_embed(cfg, trees[0], ids_m[0].long(), pos_m[0])]
    cdt = dtype_of(cfg.compute_dtype)
    parts = []
    for tr, ids, s0 in zip(trees, ids_m, starts):
        wte = tr["embed"]["wte"]
        loc = ids.long() - s0
        inside = (loc >= 0) & (loc < wte.shape[0])
        e = wte[loc.clamp(0, wte.shape[0] - 1)].to(cdt)
        parts.append(torch.where(inside[..., None], e, torch.zeros_like(e)))
    if sp:
        summed = C.reduce_scatter(parts, devs, dim=1)
        pos_m = [p.chunk(len(devs), dim=1)[j] for j, p in enumerate(pos_m)]
    else:
        summed = C.all_reduce(parts, devs)
    out = []
    for tr, x, pos in zip(trees, summed, pos_m):
        if cfg.uses_absolute_position:
            x = x + tr["embed"]["wpe"][
                pos.long() + cfg.abs_position_embedding_offset].to(cdt)
        if cfg.normalize_embed:
            x = x * torch.tensor(cfg.hidden_dim ** 0.5, dtype=cdt)
        out.append(x)
    return out


def _add_reduced(xs, parts, biases, devs, sp=False):
    """Each member's residual plus the row-parallel partials summed over
    the model group (``_row_parallel``; with ``sp`` a reduce-scatter
    along the tokens onto the member's residual shard) and the
    replicated bias."""
    summed = (C.reduce_scatter(parts, devs, dim=1) if sp
              else _row_parallel(parts, devs))
    out = []
    for x, r, b in zip(xs, summed, biases):
        if b is not None:
            r = r + b.to(x.dtype)
        out.append(x + r)
    return out


def _call(fn, *args):
    return fn(*args)


def _remat(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def _attn_partial(cfg, lp, layer_idx, x, seg, cos, sin, attn_impl):
    """One member's attention half: q/k/v of its own heads, attention
    (K1 on CUDA) and its ``wo`` partial -> (partial, k, v)."""
    return _attn_partial_normed(
        cfg, lp, layer_idx, _norm(cfg, x, lp["ln1"]["scale"],
                                  lp["ln1"].get("bias")),
        seg, cos, sin, attn_impl)


def _attn_partial_normed(cfg, lp, layer_idx, ln1, seg, cos, sin, attn_impl):
    """``_attn_partial`` after the norm."""
    q, k, v = _qkv_rotary(cfg, lp, ln1, cos, sin)
    a = attn_impl(q, k, v, seg, causal=True,
                  scale=_attn_scale(cfg, layer_idx),
                  sliding_window=cfg.sliding_window)
    return a.reshape(*ln1.shape[:-1], -1) @ lp["attn"]["wo"].to(ln1.dtype), \
        k, v


def _mlp_partial(cfg, lp, x, seg=None, shard=None):
    """One member's norm and MLP up to its ``wd`` partial (a MoE member's
    slice of every expert's width, its router sums to ``shard``)."""
    return _mlp_body(cfg, lp, _norm(cfg, x, lp["ln2"]["scale"],
                                    lp["ln2"].get("bias")), seg, shard)


def _mlp_body(cfg, lp, h, seg=None, shard=None):
    """``_mlp_partial`` after the norm."""
    return _mlp_with_aux(cfg, lp, h, seg, shard, out_bias=False)[0]


def _mlp_members(cfg, lps, devs, xs, run=_call, sp=False, segs=None,
                 moe=None):
    """The MLP half over a model group; with ``sp`` each member's norm
    runs on its residual shard (a checkpoint region of its own under
    ``run``) and an all-gather precedes the up projections. ``moe`` is
    (``MoEShards``, layer, shard key) for a MoE model over members: each
    member runs its slice of every expert on the same routing. With
    expert parallelism a member's MLP reaches the other data indices'
    experts on their devices, so it is not checkpointed (a recompute
    region spanning cards would be run by two autograd threads)."""
    segs = segs or [None] * len(lps)
    shards = [None] * len(lps)
    if moe is not None:
        ctx, layer, key = moe
        shards = [MoEShard(ctx, layer, key, j) for j in range(len(lps))]
        if ctx.experts is not None:
            run = _call
    if sp:
        lns = C.all_gather([run(_norm, cfg, x, lp["ln2"]["scale"],
                                lp["ln2"].get("bias"))
                            for lp, x in zip(lps, xs)], devs, dim=1)
        parts = [run(_mlp_body, cfg, lp, h, seg, sh)
                 for lp, h, seg, sh in zip(lps, lns, segs, shards)]
    else:
        parts = [run(_mlp_partial, cfg, lp, x, seg, sh)
                 for lp, x, seg, sh in zip(lps, xs, segs, shards)]
    return _add_reduced(xs, parts, [lp["mlp"].get("bd") for lp in lps], devs,
                        sp)


def _moe_shards(cfg, mp: MemberParams, n_tokens: int
                ) -> Optional[MoEShards]:
    """The ``MoEShards`` of one batch over ``mp``'s members (None for a
    dense model): the capacity over ``n_tokens``, and under expert
    parallelism, for each (context, model) index and each layer, every
    data index's member's layer view and device (the member of the
    layer's stage)."""
    if cfg.mlp_type != "moe":
        return None
    experts = None
    if mp.ep:
        views, experts = {}, {}
        for ci in range(mp.c):
            for j in range(mp.t):
                layers = []
                for s in range(mp.p):
                    at = [mp.index(g, ci, j, s) for g in range(mp.d)]
                    for i in at:
                        tr = mp.trees[i]
                        if id(tr) not in views:
                            views[id(tr)] = layer_views(tr["blocks"],
                                                        _slab_len(tr))
                    layers += [[(views[id(mp.trees[i])][li], mp.devices[i])
                                for i in at]
                               for li in range(_slab_len(mp.trees[at[0]]))]
                experts[(ci, j)] = layers
    return MoEShards(n_tokens, mp.c, mp.devices[0], experts)


def _register_routes(cfg, moe, layer, g, lps, xs, segs, devs, sp):
    """Register every context shard's per-row expert counts of data
    group ``g`` at ``layer`` before any of them dispatches: a shard's
    queue positions follow its rows' tokens in the shards before it (the
    capacity dispatch alone reads them)."""
    if cfg.moe.capacity_factor is None:
        return
    with torch.no_grad():
        for ci, (x, seg) in enumerate(zip(xs, segs)):
            lns = [_norm(cfg, xj, lp["ln2"]["scale"], lp["ln2"].get("bias"))
                   for lp, xj in zip(lps[ci], x)]
            ln2 = C.all_gather(lns, devs[ci], dim=1)[0] if sp else lns[0]
            moe.register(layer, (g, ci), route_counts(
                cfg, lps[ci][0]["mlp"], ln2, seg[0] != 0))


def _block_members(cfg, lps, layer_idx, xs, segs, tables, devs,
                   attention_fn=None, remat=False, moe=None):
    """One block over a model group -> (the members' outputs, each
    member's (k, v)). Under ``remat`` each member's half-block is
    checkpointed on its own: a recompute spanning cards would be
    triggered by the autograd engine's per-device threads at once, and
    ``torch.utils.checkpoint`` recomputes per graph task without a lock.
    The sums between the halves save nothing."""
    attn_impl = attention_fn or packed_attention
    run = _remat if remat else _call
    outs = [run(_attn_partial, cfg, lp, layer_idx, x, seg, cos, sin,
                attn_impl)
            for lp, x, seg, (cos, sin) in zip(lps, xs, segs, tables)]
    xs = _add_reduced(xs, [o[0] for o in outs],
                      [lp["attn"].get("bo") for lp in lps], devs)
    return (_mlp_members(cfg, lps, devs, xs, run, False, segs, moe),
            [o[1:] for o in outs])


def _forward_group(cfg, trees, devs, starts, ids, seg, pos, return_kv,
                   attention_fn, moe=None, g=0):
    """One data group's forward over its model members (t > 1, or a MoE
    model's one member, its shard of the batch's routing ``moe``) ->
    (each member's final hidden states, each member's stacked (k, v) or
    None)."""
    ids_m = C.broadcast(ids, devs)
    seg_m = C.broadcast(seg.contiguous(), devs)
    pos_m = C.broadcast(pos, devs)
    xs = _embed_members(cfg, trees, devs, ids_m, pos_m, starts)
    tables = [_rotary_tables(cfg, p) for p in pos_m]
    layers = [member_views(cfg, tr, j, len(trees))
              for j, tr in enumerate(trees)]
    remat = cfg.gradient_checkpointing and torch.is_grad_enabled()
    kvs = [([], []) for _ in trees]
    for li in range(cfg.n_layers):
        xs, kv = _block_members(cfg, [lv[li] for lv in layers], li, xs,
                                seg_m, tables, devs, attention_fn, remat,
                                None if moe is None else (moe, li, (g, 0)))
        if return_kv:
            for acc, (k, v) in zip(kvs, kv):
                acc[0].append(k)
                acc[1].append(v)
    hs = [_norm(cfg, x, tr["ln_f"]["scale"], tr["ln_f"].get("bias"))
          for tr, x in zip(trees, xs)]
    return hs, ([(torch.stack(k), torch.stack(v)) for k, v in kvs]
                if return_kv else None)


def forward_members(cfg: TransformerConfig, mp: MemberParams,
                    input_ids: torch.Tensor, seg_ids: torch.Tensor,
                    positions: Optional[torch.Tensor] = None, *,
                    return_kv: bool = False, return_aux: bool = False,
                    attention_fn=None, pipeline=None,
                    group: Optional[int] = None):
    """``forward`` over the members of a ``dNtMpP`` layout: ``[S, L]``
    inputs (on any device) -> (``MemberHidden``, per-member stacked
    (k, v) or None[, aux]). Data group g runs rows ``data_rows(S,
    d)[g]`` (all S rows when ``group`` is g, none when it is another
    group: the serving engine fills one slot on its owning group); at
    t = p = 1 that is ``forward`` on its one member's tree.
    At p > 1 each data group runs the pipeline of ``pipeline`` (default
    ``mp.pipeline``; ``_forward_members_pipeline``) and the hidden
    states are the last stage's. A MoE model's data groups route as one
    batch (``MoEShards``; at p > 1 one per microbatch): each group's
    forward runs on its members in turn, registering its per-layer
    expert counts for the groups after it, and the router losses come
    from every group's sums."""
    check_layout(cfg, mp.t)
    if mp.c > 1 or (mp.sp and mp.t > 1 and mp.p == 1):
        return forward_ctx(cfg, mp, input_ids, seg_ids, positions,
                           return_kv=return_kv, return_aux=return_aux,
                           attention_fn=attention_fn)
    seg_ids = seg_ids.to(torch.int32)
    if positions is None:
        positions = positions_from_segments(seg_ids)
    if mp.p > 1:
        pipe = pipeline or mp.pipeline
        _check_pipelined(cfg, pipe, return_kv)
        return _forward_members_pipeline(cfg, mp, pipe, input_ids, seg_ids,
                                         positions, return_aux, attention_fn)
    n = input_ids.shape[0]
    rows = (data_rows(n, mp.d) if group is None else
            [(0, 0)] * group + [(0, n)] + [(n, n)] * (mp.d - group - 1))
    starts = mp.vocab_starts(cfg)
    hs, kvs = [], []
    aux_sum: Dict[str, torch.Tensor] = {}
    moe = _moe_shards(cfg, mp, input_ids.shape[0] * input_ids.shape[1])
    for g, (r0, r1) in enumerate(rows):
        trees, devs = mp.group(g)
        if r1 == r0:
            hs.append(None)
            kvs.extend([None] * mp.t)
            continue
        ids, seg, pos = (a[r0:r1] for a in (input_ids, seg_ids, positions))
        if mp.t == 1 and moe is None:
            dev = devs[0]
            h, kv = forward(cfg, trees[0], ids.to(dev), seg.to(dev),
                            pos.to(dev), return_kv=return_kv,
                            attention_fn=attention_fn)
            hs.append([h])
            kvs.append(kv)
        else:
            h, kv = _forward_group(cfg, trees, devs, starts, ids, seg, pos,
                                   return_kv, attention_fn, moe, g)
            hs.append(h)
            kvs.extend(kv if kv is not None else [None] * mp.t)
    if moe is not None:
        aux_sum = moe.losses(cfg.moe)
    out = MemberHidden(hs, rows), (kvs if return_kv else None)
    return (*out, aux_sum) if return_aux else out


def _gather_rows(parts: List[Optional[torch.Tensor]], device):
    """Data groups' per-row outputs -> one tensor on ``device`` (empty
    groups skipped)."""
    return torch.cat([p.to(device) for p in parts if p is not None], dim=0)



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
    """[..., H] -> [..., V] fp32 logits (any vocab padding sliced off).
    Given ``MemberParams`` and a ``MemberHidden``: each model member's
    vocabulary shard, all-gathered over its model group, the groups'
    rows concatenated on the first member's device."""
    if isinstance(params, MemberParams):
        out = []
        for g, h in enumerate(hidden.hs):
            if h is None:
                out.append(None)
                continue
            trees, devs = params.group(g)
            parts = [_matmul_f32(x, head_weight(cfg, tr))
                     for tr, x in zip(trees, h)]
            out.append(C.all_gather(parts, devs, dim=-1)[0]
                       [..., :cfg.vocab_size])
        return _gather_rows(out, params.devices[0])
    logits = _matmul_f32(hidden, head_weight(cfg, params))
    if logits.shape[-1] != cfg.vocab_size:
        logits = logits[..., :cfg.vocab_size]
    return logits


def critic_values(cfg: TransformerConfig, params: Params,
                  hidden: torch.Tensor) -> torch.Tensor:
    """[..., H] -> [...] fp32 scalar values. Given ``MemberParams``:
    each data group's first model member applies the replicated head,
    the rows concatenated on the first member's device."""
    assert cfg.is_critic
    if isinstance(params, MemberParams):
        return _gather_rows(
            [None if h is None else
             critic_values(cfg, params.group(g)[0][0], h[0])
             for g, h in enumerate(hidden.hs)], params.devices[0])
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
                  dtype=None, device="cpu",
                  n_kv_heads: Optional[int] = None) -> KVCache:
    """A zero cache of ``round_cache_len(max_len)`` slots over
    ``n_kv_heads`` (default all of the model's; a model member holds
    ``nkv / t``)."""
    dtype = dtype or dtype_of(cfg.compute_dtype)
    max_len = round_cache_len(max_len)
    shape = (cfg.n_layers, batch, n_kv_heads or cfg.n_kv_heads, max_len,
             cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "valid": torch.zeros((batch, max_len), dtype=torch.bool,
                             device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def prefill(cfg: TransformerConfig, params: Params, input_ids: torch.Tensor,
            seg_ids: torch.Tensor, positions: Optional[torch.Tensor] = None,
            *, total_len: Optional[int] = None, attention_fn=None,
            group: Optional[int] = None) -> Tuple[torch.Tensor, KVCache]:
    """Packed forward plus a KV cache whose first L slots hold the
    prompt's keys/values. ``total_len`` sizes the cache for the whole
    generation (prompt + new tokens, rounded) in one allocation. Given
    ``MemberParams``: (``MemberHidden``, one cache per member over its
    rows and its KV heads, None for a member of an empty group); with
    ``group`` every row runs on that data group (``forward_members``)."""
    if group is not None:
        hidden, kvs = forward_members(cfg, params, input_ids, seg_ids,
                                      positions, return_kv=True,
                                      attention_fn=attention_fn, group=group)
    else:
        hidden, kvs = forward(cfg, params, input_ids, seg_ids, positions,
                              return_kv=True, attention_fn=attention_fn)
    lp = input_ids.shape[1]
    total = round_cache_len(total_len if total_len is not None else lp)
    if not isinstance(params, MemberParams):
        return hidden, _cache_from_kv(cfg, kvs, seg_ids, total)
    t = params.t
    seq = kv_replicated(cfg.n_kv_heads, t)
    if seq:
        total = _decode.seq_cache_len(total, t)
    caches = []
    for i, kv in enumerate(kvs):
        if kv is None:
            caches.append(None)
            continue
        r0, r1 = hidden.rows[i // t]
        seg = seg_ids[r0:r1].to(params.devices[i])
        caches.append(_seq_cache_from_kv(cfg, kvs, i, t, seg, total) if seq
                      else _cache_from_kv(cfg, kv, seg, total))
    return hidden, caches


def _seq_cache_from_kv(cfg, kvs, i, t, seg_ids, total) -> KVCache:
    """Member ``i``'s cache in the "seq" route's layout: slots ``[j S/t,
    (j+1) S/t)`` (j its model index, S = ``total``) of every KV head,
    the prompt's part of them filled. Each member's prefill computed the
    one KV head its query heads read; head h comes from the first model
    member that reads it. ``offset`` is the slice's first slot."""
    j, base = i % t, i - i % t
    dev = kvs[i][0].device
    per = t // cfg.n_kv_heads
    k, v = (torch.cat([kvs[base + h * per][w].to(dev)
                       for h in range(cfg.n_kv_heads)], dim=3)
            for w in range(2))
    nl, b, lp = k.shape[0], k.shape[1], k.shape[2]
    s_loc = total // t
    lo = j * s_loc
    n = max(0, min(lo + s_loc, lp) - lo)
    shape = (nl, b, cfg.n_kv_heads, s_loc, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=k.dtype, device=dev),
             "v": torch.zeros(shape, dtype=k.dtype, device=dev),
             "valid": torch.zeros((b, s_loc), dtype=torch.bool, device=dev),
             "length": torch.full((b,), lp, dtype=torch.int32, device=dev),
             "offset": lo}
    if n:
        cache["k"][:, :, :, :n] = k[:, :, lo:lo + n].transpose(2, 3)
        cache["v"][:, :, :, :n] = v[:, :, lo:lo + n].transpose(2, 3)
        cache["valid"][:, :n] = seg_ids[:, lo:lo + n] != 0
    return cache


def _cache_from_kv(cfg, kv, seg_ids, total) -> KVCache:
    k, v = kv
    b, lp = seg_ids.shape
    cache = init_kv_cache(cfg, b, total, dtype=k.dtype, device=k.device,
                          n_kv_heads=k.shape[3])
    # [nl, B, L, nkv, hd] -> head-major [nl, B, nkv, L, hd]
    cache["k"][:, :, :, :lp] = k.transpose(2, 3)
    cache["v"][:, :, :, :lp] = v.transpose(2, 3)
    cache["valid"][:, :lp] = seg_ids != 0
    cache["length"].fill_(lp)
    return cache


def decode_step(cfg: TransformerConfig, params: Params, cache: KVCache,
                token: torch.Tensor, positions: torch.Tensor,
                uniform_slot: bool = False
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
    stream writes its own slot, and a stream whose slot lies past the
    cache writes nothing (neither K/V nor ``valid``).

    Given ``MemberParams``, ``cache`` is ``prefill``'s list of member
    caches: data group g steps its rows of ``token`` on its members,
    each member with K4 over its own KV heads, and the result is a
    ``MemberHidden`` and the list of caches."""
    if isinstance(params, MemberParams):
        return _decode_members(cfg, params, cache, token, positions,
                               uniform_slot)
    check_supported(cfg)
    st = _decode_slots(cache, token, uniform_slot)
    x = _embed(cfg, params, token.long(), positions)
    cos, sin = _rotary_tables(cfg, positions)
    for li, lp in enumerate(layer_views(params["blocks"], cfg.n_layers)):
        # q [B, nq, hd]; k/v [B, nkv, hd]
        q, k, v = _attn_in(cfg, lp, x, cos, sin)
        attn = _decode_attend(cfg, li, q, k, v, cache, st)
        x, _ = _attn_out(cfg, lp, x, attn)
    x = _norm(cfg, x, params["ln_f"]["scale"], params["ln_f"].get("bias"))
    return x, _advanced(cache)


def _advanced(cache: KVCache) -> KVCache:
    return {**cache, "length": cache["length"] + 1}


def _decode_slots(cache: KVCache, token: torch.Tensor, uniform_slot: bool):
    """Mark this step's slot valid; returns what the layers' writes
    need."""
    valid = cache["valid"]
    slot = cache["length"]
    st = dict(slot=slot, uniform=uniform_slot,
              rows=torch.arange(token.shape[0], device=token.device))
    if uniform_slot:
        st["s0"] = slot[:1].long()
        valid.index_fill_(1, st["s0"], True)
    else:
        # a stream whose write index has run past the cache (an idle or
        # finished inflight slot that keeps stepping) writes nothing, as
        # JAX drops out-of-range scatter updates: its write goes to the
        # last slot with that slot's own values
        st["inb"] = slot < valid.shape[1]
        st["wpos"] = slot.clamp(max=valid.shape[1] - 1).long()
        rows, wpos = st["rows"], st["wpos"]
        valid[rows, wpos] = valid[rows, wpos] | st["inb"]
    return st


def _decode_attend(cfg, li, q, k, v, cache, st):
    """Write layer ``li``'s new K/V into the cache in place and attend
    (K4 / K5 on CUDA)."""
    k_all, v_all, valid = cache["k"], cache["v"], cache["valid"]
    # In-place slot write into the stacked cache: replaces the
    # dynamic_update_slice / scatter of realhf_tpu/models/
    # transformer.py:618-626 without copying the cache.
    if st["uniform"]:
        s0 = st["s0"]
        k_all[li].index_copy_(2, s0, k[:, :, None, :].to(k_all.dtype))
        v_all[li].index_copy_(2, s0, v[:, :, None, :].to(v_all.dtype))
    else:
        rows, wpos = st["rows"], st["wpos"]
        keep = st["inb"][:, None, None]
        k_all[li, rows, :, wpos] = torch.where(
            keep, k.to(k_all.dtype), k_all[li, rows, :, wpos])
        v_all[li, rows, :, wpos] = torch.where(
            keep, v.to(v_all.dtype), v_all[li, rows, :, wpos])
    scale = _decode_scale(cfg, li)
    if cfg.n_layers > _DECODE_UNROLL_MAX_LAYERS:
        return stacked_decode_attention(
            q, k_all, v_all, valid, li, scale=scale,
            sliding_window=cfg.sliding_window, slot=st["slot"])
    return decode_attention(q, k_all[li], v_all[li], valid, scale=scale,
                            sliding_window=cfg.sliding_window,
                            slot=st["slot"])


def _decode_scale(cfg, li):
    base = cfg.head_dim ** -0.5 if cfg.scale_attn_weights else 1.0
    return base / (li + 1) if cfg.scale_attn_by_inverse_layer_idx else base


def _seq_slots(cache: KVCache, sliding_window):
    """The "seq" route's ``_decode_slots``: each stream's slot (the
    global ``length``) lies in one member's slice; that member marks it
    valid and will write it. Returns the writes' rows, local slots and
    owner mask, and the member's [B, S/t] keep mask (valid, and inside
    the window by global slot index)."""
    valid, slot, off = cache["valid"], cache["length"], cache["offset"]
    b, s_loc = valid.shape
    loc = slot - off
    mine = (loc >= 0) & (loc < s_loc)
    rows = torch.arange(b, device=valid.device)
    wpos = loc.clamp(0, s_loc - 1).long()
    valid[rows, wpos] = valid[rows, wpos] | mine
    keep = valid
    if sliding_window is not None:
        idx = off + torch.arange(s_loc, device=valid.device)[None, :]
        keep = keep & ((slot[:, None] - idx) < sliding_window)
    return dict(rows=rows, wpos=wpos, mine=mine, keep=keep)


def _seq_attend(cfg, li, lps, xs, tables, caches, sts, devs):
    """Layer ``li``'s decode attention in the "seq" route -> each
    member's ``wo`` partial: every member computes q of its own heads
    and k/v of every KV head from its replicated weights, the owner of
    the step's slot writes them, q is gathered over the members, each
    member runs K4 with statistics over its slice of the slots, and the
    partials merge (``ops/decode_attention.seqsplit_merge``) into the
    output each member takes its own heads' rows of."""
    qs = []
    for lp, x, (cos, sin), c, st in zip(lps, xs, tables, caches, sts):
        q, k, v = _attn_in(cfg, lp, x, cos, sin)
        rows, wpos, keep = st["rows"], st["wpos"], st["mine"][:, None, None]
        for w, new in ((c["k"], k), (c["v"], v)):
            w[li, rows, :, wpos] = torch.where(keep, new.to(w.dtype),
                                               w[li, rows, :, wpos])
        qs.append(q)
    stacked = cfg.n_layers > _DECODE_UNROLL_MAX_LAYERS
    merged = C.broadcast(_decode.decode_attention_seqsplit(
        torch.cat([q.to(devs[0]) for q in qs], dim=1),
        *([c[w] if stacked else c[w][li] for c in caches] for w in "kv"),
        [st["keep"] for st in sts], scale=_decode_scale(cfg, li),
        layer_index=li if stacked else None), devs)
    per = cfg.n_q_heads // len(lps)
    return [o[:, j * per:(j + 1) * per].reshape(o.shape[0], -1)
            @ lp["attn"]["wo"].to(x.dtype)
            for j, (o, lp, x) in enumerate(zip(merged, lps, xs))]


def _decode_members(cfg, mp: MemberParams, caches, token, positions,
                    uniform_slot):
    check_layout(cfg, mp.t)
    if mp.p > 1:
        raise ValueError("a decode step on a pipeline layout: generation "
                         "runs on the engine's decode view "
                         "(Engine.decode_engine).")
    rows = data_rows(token.shape[0], mp.d)
    starts = mp.vocab_starts(cfg)
    seq = kv_replicated(cfg.n_kv_heads, mp.t)
    moe = _moe_shards(cfg, mp, token.shape[0])
    hs, new_caches = [], []
    for g, (r0, r1) in enumerate(rows):
        trees, devs = mp.group(g)
        cs = caches[g * mp.t:(g + 1) * mp.t]
        if r1 == r0:
            hs.append(None)
            new_caches.extend(cs)
            continue
        tok, pos = token[r0:r1], positions[r0:r1]
        if mp.t == 1 and moe is None:
            h, c = decode_step(cfg, trees[0], cs[0], tok.to(devs[0]),
                               pos.to(devs[0]), uniform_slot)
            hs.append([h])
            new_caches.append(c)
            continue
        tok_m, pos_m = C.broadcast(tok, devs), C.broadcast(pos, devs)
        if seq:
            _decode.choose_decode_route(cfg.n_kv_heads,
                                        cs[0]["valid"].shape[1] * mp.t, mp.t)
            sts = [_seq_slots(c, cfg.sliding_window) for c in cs]
        else:
            sts = [_decode_slots(c, x, uniform_slot)
                   for c, x in zip(cs, tok_m)]
        xs = _embed_members(cfg, trees, devs, tok_m, pos_m, starts)
        tables = [_rotary_tables(cfg, p) for p in pos_m]
        layers = [layer_views(tr["blocks"], cfg.n_layers) for tr in trees]
        for li in range(cfg.n_layers):
            lps = [lv[li] for lv in layers]
            if seq:
                parts = _seq_attend(cfg, li, lps, xs, tables, cs, sts, devs)
            else:
                parts = []
                for lp, x, (cos, sin), c, st in zip(lps, xs, tables, cs,
                                                    sts):
                    q, k, v = _attn_in(cfg, lp, x, cos, sin)
                    a = _decode_attend(cfg, li, q, k, v, c, st)
                    parts.append(a.reshape(*x.shape[:-1], -1)
                                 @ lp["attn"]["wo"].to(x.dtype))
            xs = _add_reduced(xs, parts, [lp["attn"].get("bo")
                                          for lp in lps], devs)
            xs = _mlp_members(cfg, lps, devs, xs, _call, False, None,
                              None if moe is None else (moe, li, (g, 0)))
        hs.append([_norm(cfg, x, tr["ln_f"]["scale"],
                         tr["ln_f"].get("bias"))
                   for tr, x in zip(trees, xs)])
        new_caches.extend(_advanced(c) for c in cs)
    return MemberHidden(hs, rows), new_caches
