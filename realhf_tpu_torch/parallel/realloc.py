"""Parameter reallocation: move live weights between layouts.

The counterpart of the JAX package's ``parallel/realloc.py``. There,
moving a model between two meshes is one ``jax.device_put`` onto the
target shardings; here the port writes the move out leaf by leaf: each
logical leaf is gathered from the source's first data group (its model
shards and stage slabs joined on the target's first device; an
expert-parallel leaf from every data index), its vocabulary re-padded
for the target's t (``models/sharding.repad_vocab_leaf``), and each
target member's chunk (its stage's slab, its data and model chunk:
``sharding.member_chunk``, under each side's own split rules, since a
KV leaf split at one t is replicated at another) copied into that
member's tensor in place. One leaf is in flight at a time, so the move needs the source,
the target and one leaf of memory, never a second whole model.

An ``eta`` below 1 merges instead of overwriting: ``target = eta *
source + (1 - eta) * target`` in fp32, rounded to the target's dtype
(the JAX package's ``_ema_lerp``; an EMA reference model).

``ReplicaManager`` keeps the replica engines of a role (per-MFC layouts
other than the role's own) in step with the role's trained primary:
``ensure_fresh`` reallocates before a replica's MFC whenever the
primary's version moved since the last sync.
"""

import time
from typing import Any, Callable, Dict, Optional

import torch

from realhf_tpu_torch.base import logging
from realhf_tpu_torch.models import sharding as shard_rules
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.models.sharding import MemberParams
from realhf_tpu_torch.parallel import param_stream

logger = logging.getLogger("param_realloc", "benchmark")


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _targets(engine):
    """(member trees, [(stage, data, model index) of each], p, t, d) of an
    engine at any layout: each distinct tree of a sharded engine once
    (context copies on one device share one), else its one tree."""
    if getattr(engine, "sharded", False):
        mp = engine.params
        per = mp.d * mp.c * mp.t
        return ([mp.trees[i] for i in engine.units],
                [(i // per, (i // (mp.c * mp.t)) % mp.d, i % mp.t)
                 for i in engine.units], mp.p, mp.t, mp.d)
    return [engine.params], [(0, 0, 0)], 1, 1, 1


def _source_leaf(src, path, spec, device):
    """The logical leaf at ``path`` (padded for the source's t) on
    ``device``: the model shards and stage slabs of the first data group
    (of every data index for an expert-parallel leaf) joined."""
    if not isinstance(src, MemberParams):
        return _get(src, path).to(device)
    trees = src.canonical_trees()
    stages = range(src.p) if shard_rules.is_staged(path) else [0]
    nd = src.gather_d
    n = nd * src.t if shard_rules.data_dim(spec) is not None else src.t
    return shard_rules.join_chunks(
        [[_get(trees[s * nd * src.t + i], path).to(device) for i in range(n)]
         for s in stages], path, spec, nd)


def _ema(src: torch.Tensor, dst: torch.Tensor, eta: float) -> torch.Tensor:
    return (eta * src.to(torch.float32)
            + (1.0 - eta) * dst.to(torch.float32)).to(dst.dtype)


def _install_leaf(cfg, target, path, spec, leaf, eta):
    """Re-pad ``leaf`` (a logical leaf, any padding) for the target's t
    and copy each member's chunk into its tensor in place (EMA when
    eta < 1). ``target`` is ``_targets``'s result."""
    trees, coords, p, t, d = target
    leaf = shard_rules.repad_vocab_leaf(cfg, path, leaf, t)
    for tree, (s, g, j) in zip(trees, coords):
        dst = _get(tree, path)
        src = shard_rules.member_chunk(leaf, path, spec, s, j, p, t, g,
                                       d).to(device=dst.device,
                                             dtype=dst.dtype)
        if dst.shape != src.shape:
            raise ValueError(f"{'/'.join(path)}: a {tuple(src.shape)} "
                             f"chunk for a {tuple(dst.shape)} member leaf")
        with torch.no_grad():
            dst.copy_(src if eta == 1.0 else _ema(src, dst, eta))


def _synchronize(engine):
    for d in set(engine.members):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _finish(engine):
    engine.params_epoch += 1  # a decode view of the target is stale now


def reallocate(cfg: TransformerConfig, src_params: Any, dst_engine,
               eta: float = 1.0) -> float:
    """Move (or EMA-merge) ``src_params`` (a tree, or a sharded engine's
    ``MemberParams``) onto ``dst_engine``'s members, in place. Returns
    the seconds of the move, the device work included (the north-star
    reshard metric)."""
    dst_engine.ensure_on_device()
    _synchronize(dst_engine)
    t0 = time.monotonic()
    target = _targets(dst_engine)
    dev = dst_engine.members[0]
    src_t = src_params.t if isinstance(src_params, MemberParams) else 1
    src_specs = dict(shard_rules.flat_specs(cfg, src_t))
    for path, spec in shard_rules.flat_specs(cfg, target[3]):
        leaf = _source_leaf(src_params, path, src_specs[path], dev)
        _install_leaf(cfg, target, path, spec, leaf, eta)
    _synchronize(dst_engine)
    dt = time.monotonic() - t0
    _finish(dst_engine)
    return dt


def install_param_chunks(cfg: TransformerConfig, dst_engine, n_chunks: int,
                         fetch_chunk: Callable[[int], Dict], eta: float = 1.0):
    """Streamed receiver install: ``fetch_chunk(i) -> {path: array}``
    chunks (``param_stream.chunk_payload``, canonical or any padding)
    land on the target's members one at a time, each leaf re-padded,
    cast and optionally EMA-merged. Returns (seconds, bytes received)."""
    dst_engine.ensure_on_device()
    t0 = time.monotonic()
    target = _targets(dst_engine)
    specs = dict(shard_rules.flat_specs(cfg, target[3]))
    seen, total = set(), 0
    for i in range(n_chunks):
        for path, arr in sorted(fetch_chunk(i).items()):
            path = tuple(path)
            total += param_stream.leaf_nbytes(arr)
            leaf = arr if isinstance(arr, torch.Tensor) else \
                torch.from_numpy(arr)
            _install_leaf(cfg, target, path, specs[path], leaf, eta)
            seen.add(path)
    missing = set(specs) - seen
    assert not missing, f"param stream missed leaves: {sorted(missing)}"
    _synchronize(dst_engine)
    _finish(dst_engine)
    return time.monotonic() - t0, total


def offload_to_host(params: Any) -> Any:
    """A host copy of a model's weights: a tree's leaves on the CPU, or
    the model shards and stage slabs of a sharded model's first data
    group (either installs with ``Engine.set_params``)."""
    if isinstance(params, MemberParams):
        trees = [_cpu_tree(tr) for tr in params.canonical_trees()]
        return MemberParams(trees, [torch.device("cpu")] * len(trees),
                            params.gather_d, params.t, params.p, ep=params.ep)
    return _cpu_tree(params)


def _cpu_tree(tree):
    return {k: (_cpu_tree(v) if isinstance(v, dict) else v.cpu())
            for k, v in tree.items()}


class ReplicaManager:
    """Keeps a role's replica engines (other layouts of the same
    weights) in step with its trained primary: the primary is the
    source of truth, and a replica whose last sync predates the
    primary's current version is reallocated before its MFC runs."""

    def __init__(self):
        # role -> replica engine id -> primary version at the last sync
        self._synced: Dict[str, Dict[int, int]] = {}
        self.last_reshard_secs: Optional[float] = None
        #: every reallocation's seconds, in order
        self.reshard_secs = []

    def ensure_fresh(self, role: str, primary_model, replica_model,
                     eta: float = 1.0):
        if replica_model is primary_model:
            return
        pv = primary_model.version.global_step
        synced = self._synced.setdefault(role, {})
        rid = id(replica_model)
        if synced.get(rid) == pv:
            return
        dt = reallocate(primary_model.config, primary_model.engine.params,
                        replica_model.engine, eta=eta)
        self.last_reshard_secs = dt
        self.reshard_secs.append(dt)
        synced[rid] = pv
        logger.info("Reallocated %s %s -> %s in %.3fs", role,
                    primary_model.engine.parallel,
                    replica_model.engine.parallel, dt)
