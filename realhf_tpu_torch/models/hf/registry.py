"""HuggingFace-layout checkpoints: family converters and checkpoint IO.

The JAX package's ``models/hf/registry.py``, on one device. Each family
maps its HF config and flat per-layer state dict (numpy, HF's
``(out, in)`` Linear convention) to and from a ``TransformerConfig`` and
the stacked parameter tree (block leaves ``[n_layers, ...]``, matrices
``(in, out)``). A checkpoint is a directory of ``config.json``, sharded
safetensors with ``model.safetensors.index.json`` (or one
``model.safetensors``), and for a critic ``value_head.safetensors``. The
files are the JAX package's, so either package loads what the other
wrote. The safetensors format is ``base/safetensors_io.py``.

The eager ``load_hf_checkpoint`` / ``save_hf_checkpoint`` hold the whole
model on the host as numpy. The streamed forms move one layer at a time
between the files and the device, so the host holds one layer plus the
embeddings.
"""

import copy
import dataclasses
import json
import os
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from realhf_tpu_torch.base import logging
from realhf_tpu_torch.base.device import DeviceLike, resolve_device
from realhf_tpu_torch.base.safetensors_io import (
    SafeOpen,
    load_file,
    numpy_to_tensor,
    save_file,
    tensor_to_numpy,
)
from realhf_tpu_torch.models.config import TransformerConfig

logger = logging.getLogger("hf_registry")

StateDict = Dict[str, np.ndarray]


@dataclasses.dataclass
class HFFamily:
    name: str
    hf_model_type: str
    # TransformerConfig <-> HF config dict (kwargs of the HF config class)
    config_from_hf: Callable[[Dict[str, Any], bool], TransformerConfig]
    config_to_hf: Callable[[TransformerConfig], Dict[str, Any]]
    # stacked tree <-> HF flat state dict of numpy arrays
    params_from_hf: Callable[[StateDict, TransformerConfig], Dict[str, Any]]
    params_to_hf: Callable[[Dict[str, Any], TransformerConfig], StateDict]


HF_FAMILIES: Dict[str, HFFamily] = {}


def register_hf_family(family: HFFamily):
    if family.name in HF_FAMILIES:
        raise ValueError(f"HF family {family.name} already registered.")
    HF_FAMILIES[family.name] = family


def config_from_hf(family: str, hf_config: Any,
                   is_critic: bool = False) -> TransformerConfig:
    d = hf_config if isinstance(hf_config, dict) else hf_config.to_dict()
    return HF_FAMILIES[family].config_from_hf(d, is_critic)


def config_to_hf(family: str, cfg: TransformerConfig) -> Dict[str, Any]:
    return HF_FAMILIES[family].config_to_hf(cfg)


def params_from_hf(family: str, state_dict: StateDict,
                   cfg: TransformerConfig) -> Dict[str, Any]:
    return HF_FAMILIES[family].params_from_hf(state_dict, cfg)


def params_to_hf(family: str, params: Dict[str, Any],
                 cfg: TransformerConfig) -> StateDict:
    return HF_FAMILIES[family].params_to_hf(params, cfg)


_INDEX_NAME = "model.safetensors.index.json"
_VALUE_HEAD_NAME = "value_head.safetensors"
_SHARD_SIZE = 2 * 1024 ** 3  # bytes per safetensors shard


def detect_family(path: str) -> str:
    with open(os.path.join(path, "config.json")) as f:
        mt = json.load(f)["model_type"]
    for fam in HF_FAMILIES.values():
        if fam.hf_model_type == mt:
            return fam.name
    raise ValueError(f"No registered family for HF model_type={mt}")


def _read_config(path: str, family: Optional[str], is_critic: bool
                 ) -> Tuple[str, TransformerConfig]:
    family = family or detect_family(path)
    with open(os.path.join(path, "config.json")) as f:
        hf_config = json.load(f)
    return family, config_from_hf(family, hf_config, is_critic=is_critic)


def _value_head(path: str, cfg: TransformerConfig) -> np.ndarray:
    """The critic's [H, 1] head: ``value_head.safetensors``, or, for a
    critic made from an actor's checkpoint, a fresh head drawn exactly as
    the JAX package draws it."""
    vh_path = os.path.join(path, _VALUE_HEAD_NAME)
    if os.path.exists(vh_path):
        return load_file(vh_path)["value_head.weight"]
    rng = np.random.RandomState(0)
    logger.info("Initialized critic value head from scratch.")
    return rng.normal(0, 0.02, size=(cfg.hidden_dim, 1)).astype(np.float32)


def load_hf_checkpoint(path: str, family: Optional[str] = None,
                       is_critic: bool = False):
    """Read an HF-layout directory -> (TransformerConfig, numpy tree);
    every shard is read into host memory first."""
    family, cfg = _read_config(path, family, is_critic)
    state: StateDict = {}
    index_path = os.path.join(path, _INDEX_NAME)
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        for shard in sorted(set(index["weight_map"].values())):
            state.update(load_file(os.path.join(path, shard)))
    else:
        state.update(load_file(os.path.join(path, "model.safetensors")))
    params = params_from_hf(family, state, cfg)
    if is_critic:
        params["head"] = {"w": _value_head(path, cfg)}
    return cfg, params


class _LazyShardState:
    """Dict-like view over a (sharded) checkpoint that reads one tensor
    at a time, so the host never holds a whole shard."""

    def __init__(self, path: str):
        self._path = path
        self._handles: Dict[str, SafeOpen] = {}
        index_path = os.path.join(path, _INDEX_NAME)
        if os.path.exists(index_path):
            with open(index_path) as f:
                self._weight_map = json.load(f)["weight_map"]
        else:
            fname = "model.safetensors"
            self._weight_map = dict.fromkeys(self._handle(fname).keys(),
                                             fname)

    def _handle(self, fname: str) -> SafeOpen:
        if fname not in self._handles:
            self._handles[fname] = SafeOpen(os.path.join(self._path, fname))
        return self._handles[fname]

    def __contains__(self, key: str) -> bool:
        return key in self._weight_map

    def __getitem__(self, key: str) -> np.ndarray:
        return self._handle(self._weight_map[key]).get_tensor(key)

    def spec(self, key: str):
        """(numpy dtype, shape) of a tensor, from its file's header."""
        return self._handle(self._weight_map[key]).spec(key)

    def close(self):
        for h in self._handles.values():
            h.close()
        self._handles.clear()


# Layer-container prefixes across families (bare, container-less exports
# drop the leading "model."/"transformer."): the one place the streamed
# loader's layer-key detection and the streamed saver's shard-key
# renaming agree on.
_LAYER_KEY_PAT = re.compile(
    r"^((?:model\.layers|transformer\.h|layers|h)\.)0\.")


class PrefixedStateView:
    """Lazy key-rename view for bare (headless) HF exports whose keys lack
    a container prefix (e.g. GPT2Model without ``transformer.``)."""

    def __init__(self, base, prefix: str,
                 passthrough: tuple = ("lm_head.weight",)):
        self._base = base
        self._prefix = prefix
        self._passthrough = passthrough

    def _map(self, key: str) -> str:
        if key in self._passthrough or not key.startswith(self._prefix):
            return key
        return key[len(self._prefix):]

    def __contains__(self, key: str) -> bool:
        return self._map(key) in self._base

    def __getitem__(self, key: str) -> np.ndarray:
        return self._base[self._map(key)]


class _LayerKeyView:
    """A single-layer converter's layer-0 keys mapped onto layer ``i`` of
    the checkpoint. The converter rebuilds the embeddings, final norm
    and head on every pass, but only the first pass's are kept; after it
    those keys read as one-element stand-ins of the same rank, so they
    are neither read nor transposed again."""

    def __init__(self, base, layer: int):
        self._base = base
        self._layer = layer
        self._sub = r"\g<1>%d." % layer

    def _map(self, key: str) -> str:
        return _LAYER_KEY_PAT.sub(self._sub, key)

    def __contains__(self, key: str) -> bool:
        return self._map(key) in self._base

    def __getitem__(self, key: str) -> np.ndarray:
        # the pattern decides, not mapped == key: for layer 0 the
        # substitution is the identity
        if _LAYER_KEY_PAT.match(key) is None and self._layer > 0:
            dtype, shape = self._base.spec(key)
            return np.zeros((1,) * len(shape), dtype)
        return self._base[self._map(key)]


def _flatten(tree, prefix=()) -> List[Tuple[tuple, Any]]:
    """(key path, leaf) pairs in sorted-key order."""
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += _flatten(tree[k], prefix + (k,))
        else:
            out.append((prefix + (k,), tree[k]))
    return out


def _unflatten(pairs) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def load_hf_checkpoint_streamed(path: str, device: DeviceLike = None,
                                family: Optional[str] = None,
                                is_critic: bool = False,
                                param_dtype: Optional[str] = None):
    """Load straight onto ``device`` (None = the CUDA card), one
    transformer layer at a time: the family converter runs on a
    single-layer view of the checkpoint, each layer's slices are cast
    and copied into preallocated ``[n_layers, ...]`` tensors, and only
    the embeddings, final norm and head are whole on the host. Host
    memory peaks at one layer plus those. Returns (cfg, tensor tree in
    ``param_dtype``, default the config's)."""
    from realhf_tpu_torch.models.transformer import dtype_of

    family, cfg = _read_config(path, family, is_critic)
    if param_dtype is not None:
        cfg.param_dtype = param_dtype
    dev = resolve_device(device)
    tdt = dtype_of(cfg.param_dtype)

    def put(a: np.ndarray) -> torch.Tensor:
        return numpy_to_tensor(a, copy=False).to(device=dev, dtype=tdt)

    cfg1 = copy.copy(cfg)
    cfg1.n_layers = 1
    state = _LazyShardState(path)
    leaves: Dict[tuple, torch.Tensor] = {}
    try:
        for i in range(cfg.n_layers):
            sub = params_from_hf(family, _LayerKeyView(state, i), cfg1)
            for kp, leaf in _flatten(sub):
                if kp[0] == "blocks":
                    if i == 0:
                        leaves[kp] = torch.empty(
                            (cfg.n_layers,) + leaf.shape[1:], dtype=tdt,
                            device=dev)
                    leaves[kp][i:i + 1].copy_(put(leaf))
                elif i == 0:
                    # The port never pads the vocabulary (no tensor
                    # parallelism), so the embeddings and head go on as
                    # the file holds them; the JAX loader re-pads them
                    # for its mesh here.
                    leaves[kp] = put(leaf)
            del sub
    finally:
        state.close()
    params = _unflatten(sorted(leaves.items()))
    if is_critic:
        params["head"] = {"w": put(_value_head(path, cfg))}
    return cfg, params


def _write_index(path: str, weight_map: Dict[str, str], total: int):
    with open(os.path.join(path, _INDEX_NAME), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)


def _finish_save(path: str, value_head, tokenizer):
    if value_head is not None:
        save_file({"value_head.weight": value_head},
                  os.path.join(path, _VALUE_HEAD_NAME))
    if tokenizer is not None and hasattr(tokenizer, "save_pretrained"):
        tokenizer.save_pretrained(path)


def save_hf_checkpoint(path: str, family: str, cfg: TransformerConfig,
                       params: Dict[str, Any],
                       tokenizer: Optional[Any] = None):
    """Write an HF-layout directory (config.json + ~2 GB safetensors
    shards + index) from a numpy or tensor tree held whole on the host."""
    from realhf_tpu_torch.models.convert import params_numpy

    os.makedirs(path, exist_ok=True)
    if any(isinstance(leaf, torch.Tensor) for _, leaf in _flatten(params)):
        params = params_numpy(params)
    else:
        params = copy.copy(params)
    value_head = params.pop("head")["w"] if cfg.is_critic else None
    state = params_to_hf(family, params, cfg)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config_to_hf(family, cfg), f, indent=2)

    shards, current, current_bytes = [], {}, 0
    for k, v in state.items():
        if current and current_bytes + v.nbytes > _SHARD_SIZE:
            shards.append(current)
            current, current_bytes = {}, 0
        current[k] = v
        current_bytes += v.nbytes
    shards.append(current)
    if len(shards) == 1:
        save_file(shards[0], os.path.join(path, "model.safetensors"))
    else:
        weight_map = {}
        for i, shard in enumerate(shards):
            name = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
            save_file(shard, os.path.join(path, name))
            weight_map.update({k: name for k in shard})
        _write_index(path, weight_map, sum(
            v.nbytes for s in shards for v in s.values()))
    _finish_save(path, value_head, tokenizer)
    logger.info("Saved %s checkpoint to %s", family, path)


def save_hf_checkpoint_streamed(path: str, family: str,
                                cfg: TransformerConfig,
                                params: Dict[str, Any],
                                tokenizer: Optional[Any] = None):
    """The mirror of ``load_hf_checkpoint_streamed``: one safetensors
    shard per transformer layer, each converted from that layer's slice
    of the (device) tensors, then one shard of the embeddings, final
    norm and head; the host holds one layer plus those. The file layout
    is the JAX package's streamed save's."""
    os.makedirs(path, exist_ok=True)
    params = dict(params)
    value_head = (tensor_to_numpy(params.pop("head")["w"])
                  if cfg.is_critic else None)
    flat = _flatten(params)
    # the non-stacked leaves: one host copy, reused by every per-layer
    # pass (the port's vocabulary is never padded, so nothing to cut)
    nonlayer = {kp: tensor_to_numpy(leaf) for kp, leaf in flat
                if kp[0] != "blocks"}
    # passes after the first keep only the layer keys, so the other
    # leaves get rank-preserving one-element stand-ins there
    dummy = {kp: np.zeros((1,) * v.ndim, v.dtype)
             for kp, v in nonlayer.items()}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config_to_hf(family, cfg), f, indent=2)
    cfg1 = copy.copy(cfg)
    cfg1.n_layers = 1
    n_files = cfg.n_layers + 1
    weight_map: Dict[str, str] = {}
    total = 0

    def write_file(idx: int, state: StateDict):
        nonlocal total
        name = f"model-{idx + 1:05d}-of-{n_files:05d}.safetensors"
        save_file(state, os.path.join(path, name))
        weight_map.update({k: name for k in state})
        total += sum(v.nbytes for v in state.values())

    for i in range(cfg.n_layers):
        tree_i = _unflatten(
            (kp, tensor_to_numpy(leaf[i:i + 1]) if kp[0] == "blocks"
             else (nonlayer[kp] if i == 0 else dummy[kp]))
            for kp, leaf in flat)
        state_i = params_to_hf(family, tree_i, cfg1)
        write_file(i, {_LAYER_KEY_PAT.sub(r"\g<1>%d." % i, k): v
                       for k, v in state_i.items()
                       if _LAYER_KEY_PAT.match(k)})
        if i == 0:
            write_file(cfg.n_layers, {k: v for k, v in state_i.items()
                                      if not _LAYER_KEY_PAT.match(k)})
    _write_index(path, weight_map, total)
    _finish_save(path, value_head, tokenizer)
    logger.info("Saved %s checkpoint (streamed, %d shards) to %s",
                family, n_files, path)


# ----------------------------------------------------------------------
# Helpers shared by family converters
# ----------------------------------------------------------------------
_INTS = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}
_COPY_CHUNK = 32 * 2 ** 20  # bytes a copy thread takes
_copy_pool = None


def _as_bits(a: np.ndarray) -> torch.Tensor:
    """A torch view over ``a``'s bytes as ints of its width (any strides)."""
    return torch.from_numpy(a.view(_INTS[a.dtype.itemsize]))


def _copy_into(dst: np.ndarray, src: np.ndarray):
    """dst[...] = src, bit for bit. A transposed ``src`` is a strided
    copy: numpy's runs ~0.2 GB/s at 7B-width matrices, torch's blocked
    copy several times that, and row chunks in threads (torch releases
    the GIL) multiply it."""
    global _copy_pool
    d, s = _as_bits(dst), _as_bits(src)
    n = min(d.shape[0], dst.nbytes // _COPY_CHUNK) if d.dim() else 0
    if n <= 1:
        d.copy_(s)
        return
    if _copy_pool is None:
        from concurrent.futures import ThreadPoolExecutor
        _copy_pool = ThreadPoolExecutor(min(8, os.cpu_count() or 1))
    list(_copy_pool.map(lambda ab: ab[0].copy_(ab[1]),
                        zip(d.chunk(n), s.chunk(n))))


def contiguous(w: np.ndarray) -> np.ndarray:
    """``np.ascontiguousarray(w)``, copied through ``_copy_into``."""
    if w.flags.c_contiguous:
        return np.ascontiguousarray(w)
    out = np.empty(w.shape, w.dtype)
    _copy_into(out, w)
    return out


def stack_layers(state: StateDict, pattern: str, n_layers: int,
                 transpose: bool = False) -> np.ndarray:
    """Collect per-layer HF keys ``pattern.format(i)`` into one stacked
    array [n_layers, ...]; HF Linear weights are (out, in), so
    ``transpose=True`` gives the framework's (in, out)."""
    mats = [state[pattern.format(i)] for i in range(n_layers)]
    mats = [w.T if transpose else w for w in mats]
    if len({(w.shape, w.dtype) for w in mats}) != 1:
        return np.stack(mats, axis=0)
    out = np.empty((n_layers,) + mats[0].shape, mats[0].dtype)
    for i, w in enumerate(mats):
        _copy_into(out[i], w)
    return out


def unstack_layers(arr: np.ndarray, pattern: str, out: StateDict,
                   transpose: bool = False):
    for i in range(arr.shape[0]):
        w = arr[i]
        out[pattern.format(i)] = contiguous(w.T if transpose else w)
