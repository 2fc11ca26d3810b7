"""Chunked host-side parameter streaming.

A copy of the JAX package's ``parallel/param_stream.py`` (which imports
no JAX): a model's weights as a sorted list of (path, leaf) pairs, byte-
bounded chunks of that list, one chunk's payload and the manifest that
lists them. ``parallel/realloc.py`` ``install_param_chunks`` installs
such chunks on an engine one at a time, so a receiver holds one chunk
on the host, not one model. Leaves may be numpy arrays or tensors.
"""

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

DEFAULT_CHUNK_BYTES = 64 << 20  # 64 MiB

Path = Tuple[str, ...]


def flatten_params(params: Any, _prefix: Path = ()
                   ) -> List[Tuple[Path, np.ndarray]]:
    """Nested-dict pytree -> sorted [(path, leaf)] (no copies)."""
    out: List[Tuple[Path, np.ndarray]] = []
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict):
            out.extend(flatten_params(v, _prefix + (str(k),)))
        else:
            out.append((_prefix + (str(k),), v))
    return out


def unflatten_params(items: Dict[Path, Any]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for path, leaf in items.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root


def leaf_nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(np.prod(a.shape)) * np.dtype(a.dtype).itemsize


def plan_chunks(flat: Sequence[Tuple[Path, Any]],
                max_chunk_bytes: int = DEFAULT_CHUNK_BYTES
                ) -> List[List[int]]:
    """Greedy contiguous grouping of leaf indices into byte-bounded
    chunks (deterministic given the sorted flatten order)."""
    chunks: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i, (_, leaf) in enumerate(flat):
        nb = leaf_nbytes(leaf)
        if cur and cur_bytes + nb > max_chunk_bytes:
            chunks.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
    if cur:
        chunks.append(cur)
    return chunks


def chunk_payload(flat: Sequence[Tuple[Path, Any]],
                  idxs: Sequence[int]) -> Dict[Path, Any]:
    return {flat[i][0]: np.asarray(flat[i][1]) for i in idxs}


def build_manifest(flat: Sequence[Tuple[Path, Any]],
                   chunks: Sequence[Sequence[int]]) -> Dict:
    return {
        "n_chunks": len(chunks),
        "total_bytes": sum(leaf_nbytes(l) for _, l in flat),
        "paths": [[list(flat[i][0]) for i in idxs] for idxs in chunks],
    }
