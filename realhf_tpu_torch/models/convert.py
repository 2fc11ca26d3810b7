"""Weights across the numpy boundary.

The JAX package's ``Engine.params_numpy()`` tree (nested dicts of numpy
arrays, block leaves stacked ``[n_layers, ...]``) is the exchange
format: ``params_from_numpy`` turns it into this package's tensors with
the same paths and shapes, ``params_numpy`` turns them back. Both
directions are bit-exact; bfloat16 leaves travel as numpy arrays of
``base/safetensors_io.BF16`` (``ml_dtypes.bfloat16`` where that package
is installed, else a structured dtype over the same 16 bits).
"""

from typing import Any, Dict, Optional

import torch

from realhf_tpu_torch.base.safetensors_io import (
    numpy_to_tensor,
    tensor_to_numpy,
)

Tree = Dict[str, Any]


def _to_tensor(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    # the tensor never shares memory with the caller's array (a training
    # engine updates its params in place); a move or cast copies anyway
    t = numpy_to_tensor(a, copy=False)
    out = t.to(device=device, dtype=dtype or t.dtype)
    return out.clone() if out.data_ptr() == t.data_ptr() else out


def params_from_numpy(tree: Tree, device="cpu",
                      dtype: Optional[torch.dtype] = None) -> Tree:
    """numpy tree -> tensor tree on ``device`` (cast to ``dtype`` if
    given, else keeping each leaf's dtype)."""
    return {k: (params_from_numpy(v, device, dtype) if isinstance(v, dict)
                else _to_tensor(v, device, dtype))
            for k, v in tree.items()}


def params_numpy(params: Tree) -> Tree:
    """tensor tree -> host numpy tree with the same paths and shapes."""
    return {k: (params_numpy(v) if isinstance(v, dict)
                else tensor_to_numpy(v))
            for k, v in params.items()}
