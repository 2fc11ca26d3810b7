"""Tensor-parallel split rules for the transformer's weights.

The counterpart of the JAX package's ``models/sharding.py``. There,
every leaf gets a ``PartitionSpec`` and GSPMD places the shards; here a
layout of ``t`` model members holds ``t`` explicit trees, member ``j``'s
leaf being the ``j``-th contiguous chunk of the logical leaf along the
dim its spec names ``"model"`` (``param_specs``, the same tuples as
``param_pspecs``):

- ``wte`` by vocabulary rows (the vocab-parallel embedding);
- ``wq/wk/wv/wg/wu`` and their biases by output columns;
- ``wo/wd`` by input rows (their partial outputs are summed);
- the LM head by vocabulary columns;
- norms, ``wpe``, ``bo``/``bd`` and the critic's value head replicated;
- ``wk/wv`` and their biases replicated instead when ``t`` does not
  divide the KV heads (``param_specs(cfg, t)``; each member computes the
  one KV head its query heads read, ``ops/attention.member_heads``);
- with expert parallelism (``MoEConfig.expert_parallel``) the expert
  leaves split once more, their expert dim over the data index
  (``"data"``): member (g, j) holds experts ``[g E/d, (g+1) E/d)``, the
  JAX package's ``P(None, "data", ...)``.

A vocabulary that ``t`` does not divide is zero-padded to the next
multiple (``pad_vocab``), the padding in the last member's shard;
``gather_params`` undoes the split and the padding, giving the
canonical tree ``Engine.params_numpy`` returns at one device.

A pipeline layout of ``p`` stages splits every block leaf (``staged``,
the ``blocks`` subtree) along its leading layer dim into ``p``
contiguous slabs, stage ``s`` holding layers ``[s * n / p, (s + 1) * n /
p)``, the JAX package's ``param_pspecs(pipeline_parallel=True)``; the
embedding, final norm and heads are replicated over the stages, as in
JAX (``parallel/pipeline.py``). ``member_chunk`` / ``join_chunks`` give
and undo one member's part of a logical leaf at any layout.

``MemberParams`` is what a sharded engine hands its loss functions in
place of a tree: ``models/transformer.py`` and ``ops/functional.py``
run their pipeline, data- and tensor-parallel paths when they are given
one.
"""

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from realhf_tpu_torch.models.config import TransformerConfig

MODEL = "model"
DATA = "data"

Spec = Tuple[Optional[str], ...]


def param_specs(cfg: TransformerConfig, t: int = 1) -> Dict[str, Any]:
    """Per-leaf split tuples congruent with ``init_params`` output:
    ``"model"`` marks the dim split over the model members, ``"data"``
    the expert dim under expert parallelism (the JAX package's
    ``param_pspecs(cfg)`` as tuples; no pipeline axis). At a ``t`` that
    does not divide the KV heads, the KV leaves are replicated."""
    col = (None, None, MODEL)
    row = (None, MODEL, None)
    col_b = (None, MODEL)
    rep2 = (None, None)
    kv, kv_b = col, col_b
    if t > 1 and cfg.n_kv_heads % t:
        kv, kv_b = (None, None, None), rep2
    specs: Dict[str, Any] = {
        "embed": {"wte": (MODEL, None)},
        "blocks": {
            "ln1": {"scale": rep2},
            "attn": {"wq": col, "wk": kv, "wv": kv, "wo": row},
            "ln2": {"scale": rep2},
            "mlp": {},
        },
        "ln_f": {"scale": (None,)},
    }
    if cfg.uses_absolute_position:
        specs["embed"]["wpe"] = (None, None)
    mlp = specs["blocks"]["mlp"]
    if cfg.mlp_type == "moe":
        ep = DATA if cfg.moe is not None and cfg.moe.expert_parallel else None
        mlp["router"] = (None, None, None)
        mlp["wg"] = (None, ep, None, MODEL)
        mlp["wu"] = (None, ep, None, MODEL)
        mlp["wd"] = (None, ep, MODEL, None)
    elif cfg.gated_mlp:
        mlp["wg"], mlp["wu"], mlp["wd"] = col, col, row
    else:
        mlp["wu"], mlp["wd"] = col, row
    if cfg.use_attention_bias:
        a = specs["blocks"]["attn"]
        a["bq"], a["bk"], a["bv"] = col_b, kv_b, kv_b
    if cfg.use_attn_proj_bias:
        specs["blocks"]["attn"]["bo"] = rep2
    if cfg.use_mlp_bias and cfg.mlp_type is None:
        mlp["bu"] = col_b
        mlp["bd"] = rep2
    if cfg.layer_norm_type is None:
        specs["blocks"]["ln1"]["bias"] = rep2
        specs["blocks"]["ln2"]["bias"] = rep2
        specs["ln_f"]["bias"] = (None,)
    if cfg.is_critic:
        specs["head"] = {"w": (None, None)}
    elif not cfg.tied_embedding:
        specs["head"] = {"w": (None, MODEL)}
    return specs


def split_dim(spec: Spec) -> Optional[int]:
    """The dim a spec splits over the model members, or None."""
    return spec.index(MODEL) if MODEL in spec else None


def data_dim(spec: Spec) -> Optional[int]:
    """The dim a spec splits over the data index (an expert-parallel
    leaf's expert dim), or None."""
    return spec.index(DATA) if DATA in spec else None


def is_staged(path) -> bool:
    """A block leaf: split into layer slabs over the pipeline stages."""
    return path[0] == "blocks"


def member_chunk(leaf, path, spec: Spec, s: int, j: int, p: int, t: int,
                 g: int = 0, d: int = 1):
    """Stage ``s``, data index ``g``, model member ``j``'s part of a
    logical leaf (padded for ``t``): its layer slab, its data chunk (an
    expert-parallel leaf), then its model chunk. Tensor parts are views,
    numpy parts copies."""
    if p > 1 and is_staged(path):
        leaf = _chunk(leaf, 0, p, s)
    dd = data_dim(spec)
    if dd is not None and d > 1:
        if leaf.shape[dd] % d:
            raise ValueError(
                f"expert_parallel needs num_experts ({leaf.shape[dd]}) "
                f"divisible by data_parallel_size ({d}).")
        leaf = _chunk(leaf, dd, d, g)
    sd = split_dim(spec)
    if sd is not None and t > 1:
        if leaf.shape[sd] % t:
            raise ValueError(
                f"a leaf of shape {tuple(leaf.shape)} does not split over "
                f"{t} model members along dim {sd}")
        leaf = _chunk(leaf, sd, t, j)
    return leaf


def join_chunks(parts, path, spec: Spec, d: int = 1):
    """``parts[s][g * t + j]`` (stage-major, then data, then model; ``d``
    data indices given only for an expert-parallel leaf, else one) ->
    the logical leaf, on the first part's device: ``member_chunk``'s
    inverse."""
    sd, dd = split_dim(spec), data_dim(spec)
    if dd is None:
        d = 1

    def cat(xs, dim):
        if len(xs) == 1:
            return xs[0]
        if isinstance(xs[0], torch.Tensor):
            return torch.cat([x.to(xs[0].device) for x in xs], dim=dim)
        return np.concatenate(xs, axis=dim)

    def model(row):
        return cat(row, sd) if sd is not None else row[0]

    def stage(row):
        t = len(row) // d if dd is not None else len(row)
        return cat([model(row[g * t:(g + 1) * t]) for g in range(d)], dd) \
            if dd is not None else model(row)

    if not is_staged(path):
        parts = parts[:1]  # replicated over the stages
    return cat([stage(row) for row in parts], 0)


def flat_specs(cfg: TransformerConfig, t: int = 1
               ) -> List[Tuple[Tuple[str, ...], Spec]]:
    """(path, spec) of every leaf in sorted-key order (the order of
    ``engine._leaves`` and ``parallel/param_stream.flatten_params``), at
    a layout of ``t`` model members."""
    out = []

    def walk(tree, prefix):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                walk(tree[k], prefix + (k,))
            else:
                out.append((prefix + (k,), tree[k]))

    walk(param_specs(cfg, t), ())
    return out


def expert_parallel(cfg: TransformerConfig) -> bool:
    """Whether the expert leaves split over the data index."""
    return (cfg.mlp_type == "moe" and cfg.moe is not None
            and cfg.moe.expert_parallel)


# ----------------------------------------------------------------------
# Vocabulary padding
# ----------------------------------------------------------------------
def padded_vocab_size(cfg: TransformerConfig, tp: int) -> int:
    """The vocabulary rounded up to a multiple of ``tp``."""
    return ((cfg.vocab_size + tp - 1) // tp) * tp


def _pad_axis(a, axis: int, n: int):
    if n == 0:
        return a
    if isinstance(a, torch.Tensor):
        shape = list(a.shape)
        shape[axis] = n
        return torch.cat([a, a.new_zeros(shape)], dim=axis)
    width = [(0, 0)] * a.ndim
    width[axis] = (0, n)
    return np.pad(a, width)


def _carries_vocab_head(cfg: TransformerConfig) -> bool:
    return not cfg.is_critic and not cfg.tied_embedding


def pad_vocab(cfg: TransformerConfig, params: Dict[str, Any],
              tp: int) -> Dict[str, Any]:
    """Zero-pad the vocabulary dim of ``wte`` (and of an untied LM
    head) to ``padded_vocab_size(cfg, tp)``; numpy or tensor leaves."""
    vp, v = padded_vocab_size(cfg, tp), cfg.vocab_size
    if vp == v or params["embed"]["wte"].shape[0] == vp:
        return params
    params = {**params, "embed": {**params["embed"]}}
    params["embed"]["wte"] = _pad_axis(params["embed"]["wte"], 0, vp - v)
    if _carries_vocab_head(cfg):
        params = {**params, "head": {
            "w": _pad_axis(params["head"]["w"], 1, vp - v)}}
    return params


def unpad_vocab(cfg: TransformerConfig, params: Dict[str, Any]
                ) -> Dict[str, Any]:
    """Inverse of ``pad_vocab`` (the canonical, saved layout)."""
    v = cfg.vocab_size
    if params["embed"]["wte"].shape[0] == v:
        return params
    params = {**params, "embed": {**params["embed"]}}
    params["embed"]["wte"] = params["embed"]["wte"][:v]
    if _carries_vocab_head(cfg):
        params = {**params, "head": {"w": params["head"]["w"][:, :v]}}
    return params


def normalize_vocab_padding(cfg: TransformerConfig, params: Dict[str, Any],
                            tp: int) -> Dict[str, Any]:
    """Params padded for any tp (or none) -> padded for ``tp``."""
    return pad_vocab(cfg, unpad_vocab(cfg, params), tp)


def repad_vocab_leaf(cfg: TransformerConfig, path, arr, target_tp: int):
    """Per-leaf ``unpad_vocab`` + ``pad_vocab`` for streamed installs:
    ``path`` is the leaf's key tuple, e.g. ("embed", "wte")."""
    vp, v = padded_vocab_size(cfg, target_tp), cfg.vocab_size
    if tuple(path) == ("embed", "wte"):
        return _pad_axis(arr[:v], 0, vp - v)
    if tuple(path) == ("head", "w") and _carries_vocab_head(cfg):
        return _pad_axis(arr[:, :v], 1, vp - v)
    return arr


def canonical_shape(cfg: TransformerConfig, path, spec: Spec, shard_shape,
                    t: int, d: int = 1) -> Tuple[int, ...]:
    """The logical, unpadded shape of a leaf from one member's shard."""
    shape = list(shard_shape)
    sd, dd = split_dim(spec), data_dim(spec)
    if sd is not None:
        shape[sd] *= t
    if dd is not None:
        shape[dd] *= d
    if tuple(path) == ("embed", "wte"):
        shape[0] = cfg.vocab_size
    elif tuple(path) == ("head", "w") and _carries_vocab_head(cfg):
        shape[1] = cfg.vocab_size
    return tuple(shape)


def zero1_moment_spec(spec: Spec, shape, dp: int) -> Spec:
    """``spec`` with the data axis on its largest free dim that ``dp``
    divides (the first such dim on a tie): the ZeRO-1 split of that
    leaf's optimizer state. Unchanged when ``dp <= 1``, when the data
    axis is already used, or when no free dim divides."""
    if dp <= 1:
        return tuple(spec)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in entries:
        if e is not None:
            used.update(e if isinstance(e, tuple) else (e,))
    if DATA in used:
        return tuple(spec)
    best_i, best = None, 0
    for i, (e, d) in enumerate(zip(entries, shape)):
        if e is None and d % dp == 0 and d > best:
            best, best_i = d, i
    if best_i is None:
        return tuple(spec)
    entries[best_i] = DATA
    return tuple(entries)


# ----------------------------------------------------------------------
# Trees per member
# ----------------------------------------------------------------------
def _chunk(a, dim: int, t: int, j: int):
    n = a.shape[dim] // t
    if isinstance(a, torch.Tensor):
        return a.narrow(dim, j * n, n)
    return np.take(a, np.arange(j * n, (j + 1) * n), axis=dim)


def _map_paths(fn, tree, prefix=()):
    return {k: (_map_paths(fn, v, prefix + (k,)) if isinstance(v, dict)
                else fn(prefix + (k,), v))
            for k, v in tree.items()}


def shard_params(cfg: TransformerConfig, params: Dict[str, Any],
                 t: int, p: int = 1, d: int = 1) -> List[Dict[str, Any]]:
    """A canonical (or any tp-padded) tree -> ``p * d * t`` trees, stage
    ``s``, data index ``g``, model member ``j``'s at ``(s * d + g) * t +
    j``: its layer slab of each block leaf and its chunk of each split
    leaf (``member_chunk``), the whole of each replicated one. Only an
    expert-parallel leaf differs over g. Tensor chunks are views (the
    caller copies them where it places them); numpy chunks are
    copies."""
    params = normalize_vocab_padding(cfg, params, t)
    specs = dict(flat_specs(cfg, t))
    return [_map_paths(lambda path, a, s=s, j=j, g=g: member_chunk(
                a, path, specs[path], s, j, p, t, g, d), params)
            for s in range(p) for g in range(d) for j in range(t)]


def gather_params(cfg: TransformerConfig, trees: Sequence[Dict[str, Any]],
                  p: int = 1, d: int = 1) -> Dict[str, Any]:
    """``p * d * t`` member trees (one model group of each stage and data
    index, stage-major; ``d`` > 1 only for an expert-parallel model) ->
    the canonical tree: every leaf joined on the first tree's device
    (``join_chunks``), replicated ones taken from the first stage's
    first member, vocabulary padding cut off."""
    t = len(trees) // (p * d)
    specs = dict(flat_specs(cfg, t))

    def get(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def row(s, path):
        n = d * t if data_dim(specs[path]) is not None else t
        return [get(trees[s * d * t + i], path) for i in range(n)]

    return unpad_vocab(cfg, _map_paths(
        lambda path, _: join_chunks(
            [row(s, path) for s in range(p if is_staged(path) else 1)],
            path, specs[path], d), trees[0]))


@dataclasses.dataclass
class MemberParams:
    """The weights of a ``dNcCtMpP`` layout: one tree per member, flat
    in (pipe, data, ctx, model) order, each on its member's device.
    ``p * d * c * t == len(trees)``. The members of one context group
    (same stage, data and model index) that lie on one device share one
    tree object (``units`` lists each distinct tree once). ``pipeline``
    is the engine's ``parallel/pipeline.PipelineContext`` when ``p > 1``
    (the forward reads its schedule and microbatch count); ``sp`` turns
    on sequence parallelism (the forward splits the residual stream of a
    model group along its tokens over the model members)."""
    trees: List[Dict[str, Any]]
    devices: List[torch.device]
    d: int
    t: int
    p: int = 1
    pipeline: Any = None
    c: int = 1
    sp: bool = False
    #: the expert leaves split over the data index (expert parallelism)
    ep: bool = False

    def index(self, g: int, c: int = 0, j: int = 0,
              s: Optional[int] = None) -> int:
        """The member at stage ``s`` (default: the last), data index
        ``g``, context index ``c``, model index ``j``."""
        s = self.p - 1 if s is None else s
        return ((s * self.d + g) * self.c + c) * self.t + j

    def group(self, g: int, s: Optional[int] = None, c: int = 0
              ) -> Tuple[List[Dict[str, Any]], List[torch.device]]:
        """Stage ``s``'s (default: the last, which holds the final
        hidden states) model group of data index ``g`` and context index
        ``c``: their trees and devices."""
        base = self.index(g, c, 0, s)
        return self.trees[base:base + self.t], self.devices[base:base + self.t]

    def stages(self, g: int = 0) -> List[Tuple[List[Dict[str, Any]],
                                               List[torch.device]]]:
        """Data group ``g``'s (context index 0) model group of every
        stage, in stage order."""
        return [self.group(g, s) for s in range(self.p)]

    @property
    def gather_d(self) -> int:
        """The data indices whose trees make up the logical weights: all
        d under expert parallelism, else data group 0 alone."""
        return self.d if self.ep else 1

    def canonical_trees(self) -> List[Dict[str, Any]]:
        """The model groups of every stage (of data group 0, or of every
        data index under expert parallelism), stage-major: what
        ``gather_params`` joins."""
        return [tr for s in range(self.p) for g in range(self.gather_d)
                for tr in self.group(g, s)[0]]

    def units(self) -> List[int]:
        """The first member of each distinct tree, in member order."""
        seen, out = set(), []
        for i, tr in enumerate(self.trees):
            if id(tr) not in seen:
                seen.add(id(tr))
                out.append(i)
        return out

    def vocab_starts(self, cfg: TransformerConfig) -> List[int]:
        """The first (padded) vocabulary row each model member holds."""
        per = padded_vocab_size(cfg, self.t) // self.t
        return [j * per for j in range(self.t)]


def shared_tree_key(i: int, c: int, t: int, device) -> tuple:
    """Members of one context group on one device share a tree: member
    ``i``'s (stage and data index, model index, device)."""
    return (i // (c * t), i % t, device)


def gather_member_params(cfg: TransformerConfig, mp: MemberParams,
                         device=None) -> Dict[str, Any]:
    """The canonical tree of ``mp``'s weights on ``device`` (default:
    its first member's)."""
    dev = torch.device(device) if device is not None else mp.devices[0]
    return gather_params(cfg, [_map_paths(lambda _, a: a.to(dev), tr)
                               for tr in mp.canonical_trees()], mp.p,
                         mp.gather_d)


def empty_member_trees(cfg: TransformerConfig, devices: Sequence[torch.device],
                       d: int, t: int, p: int, dtype: torch.dtype, c: int = 1
                       ) -> List[Dict[str, Any]]:
    """Uninitialised member trees of a ``dNcCtMpP`` layout (each leaf its
    member's shard shape, vocabulary padded for t), on their devices,
    shared within a context group on one device: the target of a
    reallocation."""
    shapes = init_shapes(cfg)
    vp = padded_vocab_size(cfg, t)
    specs = dict(flat_specs(cfg, t))
    out, made = [], {}
    for i, dev in enumerate(devices):
        key = shared_tree_key(i, c, t, dev)
        if key in made:
            out.append(made[key])
            continue
        s = i // (d * c * t)

        def leaf(path, shape, dev=dev, s=s):
            shape = list(shape)
            if tuple(path) == ("embed", "wte"):
                shape[0] = vp
            elif tuple(path) == ("head", "w") and _carries_vocab_head(cfg):
                shape[1] = vp
            if p > 1 and is_staged(path):
                shape[0] //= p
            sd, dd = (split_dim(specs[tuple(path)]),
                      data_dim(specs[tuple(path)]))
            if sd is not None:
                shape[sd] //= t
            if dd is not None:
                shape[dd] //= d
            return torch.empty(shape, dtype=dtype, device=dev)

        made[key] = _map_paths(leaf, shapes)
        out.append(made[key])
    return out


def init_shapes(cfg: TransformerConfig) -> Dict[str, Any]:
    """The logical shape of every leaf of ``transformer.init_params``."""
    from realhf_tpu_torch.models import transformer as T
    with torch.device("meta"):
        tree = T.init_params(cfg, None, device="meta")
    return _map_paths(lambda _, a: tuple(a.shape), tree)
