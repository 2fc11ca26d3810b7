"""Weights across the numpy boundary.

The JAX package's ``Engine.params_numpy()`` tree (nested dicts of numpy
arrays, block leaves stacked ``[n_layers, ...]``) is the exchange
format: ``params_from_numpy`` turns it into this package's tensors with
the same paths and shapes, ``params_numpy`` turns them back. Both
directions are bit-exact; bfloat16 leaves travel as ``ml_dtypes``
bfloat16 arrays (float32 where that package is absent, which holds
every bfloat16 value exactly).
"""

from typing import Any, Dict, Optional

import numpy as np
import torch

Tree = Dict[str, Any]


def _to_tensor(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    # a copy: the tensor never shares memory with the caller's array (a
    # training engine updates its params in place)
    a = np.array(a, order="C", copy=True)
    if a.dtype.name == "bfloat16":  # ml_dtypes: reinterpret the bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)  # never a view of the params
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:
            return t.to(torch.float32).numpy()
        return t.view(torch.int16).numpy().view(np.uint16).view(
            ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree: Tree, device="cpu",
                      dtype: Optional[torch.dtype] = None) -> Tree:
    """numpy tree -> tensor tree on ``device`` (cast to ``dtype`` if
    given, else keeping each leaf's dtype)."""
    return {k: (params_from_numpy(v, device, dtype) if isinstance(v, dict)
                else _to_tensor(v, device, dtype))
            for k, v in tree.items()}


def params_numpy(params: Tree) -> Tree:
    """tensor tree -> host numpy tree with the same paths and shapes."""
    return {k: (params_numpy(v) if isinstance(v, dict) else _to_numpy(v))
            for k, v in params.items()}
