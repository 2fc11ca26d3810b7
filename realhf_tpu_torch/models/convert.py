"""Weights across the numpy boundary.

The JAX package's ``Engine.params_numpy()`` tree (nested dicts of numpy
arrays, block leaves stacked ``[n_layers, ...]``) is the exchange
format: ``params_from_numpy`` turns it into this package's tensors with
the same paths and shapes, ``params_numpy`` turns them back. Both
directions are bit-exact; bfloat16 leaves travel as numpy arrays of
``base/safetensors_io.BF16`` (``ml_dtypes.bfloat16`` where that package
is installed, else a structured dtype over the same 16 bits).

A pipeline-, data- and tensor-parallel engine takes the same trees,
canonical or padded for any t: ``params_from_numpy(..., cfg=, devices=,
t=, p=)`` gives one tree per member (``models/sharding.shard_params``),
each member's leaves its own copy on its own device.
"""

from typing import Any, Dict, Optional, Sequence

import torch

from realhf_tpu_torch.base.safetensors_io import (
    numpy_to_tensor,
    tensor_to_numpy,
)
from realhf_tpu_torch.models import sharding

Tree = Dict[str, Any]


def _to_tensor(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    # the tensor never shares memory with the caller's array (a training
    # engine updates its params in place); a move or cast copies anyway
    t = numpy_to_tensor(a, copy=False)
    out = t.to(device=device, dtype=dtype or t.dtype)
    return out.clone() if out.data_ptr() == t.data_ptr() else out


def params_from_numpy(tree: Tree, device="cpu",
                      dtype: Optional[torch.dtype] = None, *, cfg=None,
                      devices: Optional[Sequence] = None,
                      t: int = 1, p: int = 1, c: int = 1):
    """numpy tree -> tensor tree on ``device`` (cast to ``dtype`` if
    given, else keeping each leaf's dtype). With ``devices`` (the members
    of a dNcCtMpP layout, in (pipe, data, ctx, model) order), ``t``,
    ``p``, ``c`` and the model's ``cfg``: a canonical or tp-padded tree
    (numpy or tensors) -> a list of trees, member i's holding stage
    ``i // (d * c * t)``'s layer slabs and model shard ``i % t`` (and,
    under expert parallelism, data index ``i // (c * t) % d``'s experts) on
    ``devices[i]``; the members of one context group on one device share
    one copy (``sharding.shared_tree_key``), every other member has its
    own."""
    if devices is not None:
        per_stage = len(devices) // p
        # only an expert-parallel model's trees differ over the data index
        nd = per_stage // (c * t) if sharding.expert_parallel(cfg) else 1
        shards = sharding.shard_params(cfg, tree, t, p, nd)
        out, made = [], {}
        for i, d in enumerate(devices):
            key = sharding.shared_tree_key(i, c, t, d)
            if key not in made:
                g = (i // (c * t)) % nd
                made[key] = _map(lambda a, d=d: _member_leaf(a, d, dtype),
                                 shards[((i // per_stage) * nd + g) * t
                                        + i % t])
            out.append(made[key])
        return out
    return {k: (params_from_numpy(v, device, dtype) if isinstance(v, dict)
                else _to_tensor(v, device, dtype))
            for k, v in tree.items()}


def _member_leaf(a, device, dtype) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = numpy_to_tensor(a, copy=False)
    return a.to(device=device, dtype=dtype or a.dtype,
                copy=True).contiguous()


def _map(fn, tree: Tree) -> Tree:
    return {k: (_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def params_numpy(params: Tree) -> Tree:
    """tensor tree -> host numpy tree with the same paths and shapes."""
    return {k: (params_numpy(v) if isinstance(v, dict)
                else tensor_to_numpy(v))
            for k, v in params.items()}
