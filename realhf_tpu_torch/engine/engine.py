"""The per-model execution engine: train, inference and generate.

One ``Engine`` holds one model's parameters on one device, or on the
members of a ``dNcCtMpP[s]`` layout (below). It runs the inference
forwards (hidden states, next-token log-probs, critic
values), batch generation, and, when built with an optimizer, one
optimizer step over a list of microbatches (``train_batch``) or one per
minibatch of a list (``train_minibatches``): per microbatch a forward
and backward, the gradients accumulated in fp32 with the microbatch's
loss weight, then the JAX package's AdamW (``engine/optim.py``). The
engine owns the tensors it is given: a training engine updates them in
place.

Between uses the weights can wait on the host (``offload`` /
``ensure_on_device``), and with ``OptimizerConfig.offload`` the
optimizer state does so between steps: pinned host buffers, made once
and reused, copies on PyTorch's current stream, synchronised before the
device tensors are dropped. On ``device="cpu"`` only the flags move.

A layout of more than one member (over ``devices``: one entry per
member, repeats allowed, default ``cuda:0 .. n-1``) holds its weights as
a ``models/sharding.MemberParams``, which the loss functions and the
forwards take in place of a tree. Context parallelism (``c > 1``, alone
or with d and t; with p it raises, as in the JAX package): the members
of one context group that share a device share one tree, and
``transformer.forward_ctx`` pads each stream's L to a multiple of ``8 c``
(``8 c t`` with ``sp``) with segment id 0, takes positions from the whole
streams, runs the ring between each block's halves and gathers the final
hidden states onto each model member of context index 0, where the
interface's loss runs unchanged; the gradients flow back through that
gather and through the ring's backward (K2/K3 per round on CUDA).

The optimizer steps each distinct tree once (a "unit": ``units``), its
ZeRO-1 slice over the data index. A leaf's gradient is summed over every
unit that holds its values (data and context copies, ``mesh.holders``)
before the step, so the copies stay equal after it; the clipping norm
counts each logical element once.
"""

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from realhf_tpu_torch.base import logging
from realhf_tpu_torch.base.device import DeviceLike, resolve_device
from realhf_tpu_torch.base.safetensors_io import tensor_to_numpy
from realhf_tpu_torch.engine import generation as gen_mod
from realhf_tpu_torch.engine import offload, optim
from realhf_tpu_torch.models import sharding
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.models.convert import params_from_numpy, params_numpy
from realhf_tpu_torch.models.sharding import MemberParams
from realhf_tpu_torch.ops import functional as F
from realhf_tpu_torch.ops.moe import ragged_dispatch_enabled
from realhf_tpu_torch.ops.sampling import GenerationHyperparameters
from realhf_tpu_torch.parallel import collectives as C
from realhf_tpu_torch.parallel.mesh import (
    ParallelismConfig,
    data_group,
    data_index,
    default_devices,
    holders,
    make_mesh,
    member_at,
    model_index,
    pipe_index,
)
from realhf_tpu_torch.parallel.pipeline import PipelineContext
from realhf_tpu_torch.parallel.schedule import default_microbatches

logger = logging.getLogger("engine")

#: loss_fn(params, microbatch tensors) -> (scalar loss, {name: scalar})
LossFn = Callable[[Any, Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


class Engine:

    def __init__(self, cfg: TransformerConfig, params: Any,
                 device: DeviceLike = None,
                 optimizer: Optional[optim.OptimizerConfig] = None,
                 total_train_steps: Optional[int] = None, *,
                 parallel: Optional[ParallelismConfig] = None,
                 devices: Optional[List[DeviceLike]] = None):
        T.check_supported(cfg)
        T.check_expert_parallel(
            cfg, (parallel or ParallelismConfig()).data_parallel_size)
        if (cfg.mlp_type == "moe" and cfg.moe.capacity_factor is None
                and cfg.moe.num_experts > 4
                and not ragged_dispatch_enabled(cfg)):
            logger.warning(
                "MoE model running in dense dispatch (capacity_factor "
                "unset, grouped GEMM disabled): every expert processes "
                "every token -- %dx the FLOPs of top-%d routing. Set "
                "MoEConfig.use_grouped_gemm=True or capacity_factor "
                "(e.g. 1.25).", cfg.moe.num_experts // cfg.moe.top_k,
                cfg.moe.top_k)
        self.cfg = cfg
        self.parallel = parallel or ParallelismConfig()
        n = self.parallel.world_size
        self.mesh = None
        if n > 1:
            self.mesh = make_mesh(
                self.parallel, devices if devices is not None
                else default_devices(n, device))
            #: the members' devices, in (pipe, data, ctx, model) order
            self.members = list(self.mesh.devices)
        else:
            self.members = [resolve_device(
                devices[0] if devices is not None else device)]
        self.device = self.members[0]
        #: more than one member: the weights are a ``MemberParams``
        self.sharded = n > 1
        if self.sharded:
            T.check_layout(cfg, self.parallel.tensor_parallel_size)
        self.pipeline_ctx = self._pipeline_ctx()
        #: bumped by every install of weights (``set_params``, a
        #: reallocation into this engine): with ``version``, what keys
        #: the decode view's freshness
        self.params_epoch = 0
        self._decode_view: Optional["Engine"] = None
        self._view_key = None
        self.params = None
        #: the first member of each distinct tree (a sharded engine)
        self.units: List[int] = [0]
        #: the weights wait on the host (``offload``) until the next use
        self.offloaded = False
        self._host_params = None  # pinned buffers, made at the first offload
        self.set_params(params)
        #: optimizer steps taken or skipped (one per minibatch trained)
        self.version = 0
        #: stats of each generate call (decode steps, tokens, seconds)
        self.generate_stats = []
        self.optimizer: Optional[optim.AdamW] = None
        self._zero1 = None
        if optimizer is not None and optimizer.type != "empty":
            if self.sharded:
                self._zero1 = self._zero1_slices(optimizer.zero1)
                self.optimizer = optim.AdamW(
                    optimizer, self._member_leaves(), total_train_steps,
                    slices=[sl for m in self._zero1 for sl in m])
            else:
                self.optimizer = optim.AdamW(
                    optimizer, list(_leaves(self.params)), total_train_steps)

    def _pipeline_ctx(self) -> Optional[PipelineContext]:
        p = self.parallel.pipeline_parallel_size
        if p == 1:
            return None
        if self.cfg.n_layers % p:
            raise ValueError(f"n_layers={self.cfg.n_layers} not divisible by "
                             f"pipeline_parallel_size={p}")
        sched = self.parallel.pipeline_schedule
        return PipelineContext(
            p, self.parallel.pipeline_microbatches
            or default_microbatches(p, sched), sched)

    @property
    def pipeline_ctx_infer(self) -> Optional[PipelineContext]:
        """The pipeline of inference-only forwards: always GPipe (there
        is no backward to schedule)."""
        if self.pipeline_ctx is None:
            return None
        return dataclasses.replace(self.pipeline_ctx, schedule="gpipe")

    @property
    def n_streams(self) -> int:
        """Preferred [S, L] stream-batch rows: one per data member, times
        the pipeline's microbatch count at p > 1."""
        d = self.parallel.data_parallel_size
        return d * (self.pipeline_ctx.n_microbatches
                    if self.pipeline_ctx is not None else 1)

    def _cast_param_dtype(self, params):
        """Place leaves on this engine's device in cfg.param_dtype
        (numpy leaves are converted first)."""
        pdt = T.dtype_of(self.cfg.param_dtype)
        if params and not isinstance(
                next(iter(_leaves(params))), torch.Tensor):
            params = params_from_numpy(params)
        return _tree_map(
            lambda a: a.to(device=self.device, dtype=pdt), params)

    def set_params(self, params):
        """Install new weights (a tensor or numpy tree, canonical or
        padded for any t, or another engine's ``MemberParams``) on the
        device, or on every member. The optimizer state, fp32 master
        copies included, is kept, as in the JAX package. ``None`` makes
        a sharded engine's member trees uninitialised (a reallocation
        fills them)."""
        self.params_epoch += 1
        if isinstance(params, MemberParams):
            params = sharding.gather_member_params(self.cfg, params)
        if self.sharded:
            self.params = None  # the old copies go before the new ones come
            par = self.parallel
            d, t = par.data_parallel_size, par.tensor_parallel_size
            p, c = par.pipeline_parallel_size, par.context_parallel_size
            pdt = T.dtype_of(self.cfg.param_dtype)
            trees = (sharding.empty_member_trees(
                self.cfg, self.members, d, t, p, pdt, c) if params is None
                else params_from_numpy(params, dtype=pdt, cfg=self.cfg,
                                       devices=self.members, t=t, p=p, c=c))
            self.params = MemberParams(
                trees, list(self.members), d, t, p, self.pipeline_ctx, c,
                par.sequence_parallel,
                sharding.expert_parallel(self.cfg) and d > 1)
            self.units = self.params.units()
            self.offloaded = False
            return
        self.params = self._cast_param_dtype(params)
        self.offloaded = False

    def params_numpy(self):
        """Host numpy copy with the JAX package's paths and shapes (the
        canonical, unpadded tree at any layout)."""
        if self.sharded:
            return params_numpy(self.gathered_params("cpu"))
        return params_numpy(self.params)

    def gathered_params(self, device=None):
        """The canonical tree of a sharded engine's weights, gathered
        from the first data group's members of every stage onto
        ``device`` (default: the first member's)."""
        return sharding.gather_member_params(self.cfg, self.params,
                                             device or self.device)

    def _unit_trees(self) -> List[Dict[str, Any]]:
        """Each distinct tree once, in ``units`` order."""
        return [self.params.trees[u] for u in self.units]

    def _unit_of(self) -> Dict[int, int]:
        """member -> the index (in ``units``) of the tree it holds."""
        at = {id(self.params.trees[u]): k for k, u in enumerate(self.units)}
        return {i: at[id(tr)] for i, tr in enumerate(self.params.trees)}

    def _member_leaves(self) -> List[torch.Tensor]:
        """Every unit's leaves, unit-major, each in ``_leaves`` order."""
        return [p for tr in self._unit_trees() for p in _leaves(tr)]

    # ------------------------------------------------------------------
    # ZeRO-1 and the gradient sums of a sharded engine
    # ------------------------------------------------------------------
    def _leaf_specs(self):
        """(path, spec, staged) of every leaf in ``_leaves`` order; a
        block leaf is staged (split into layer slabs) at p > 1."""
        p = self.parallel.pipeline_parallel_size
        return [(path, spec, p > 1 and sharding.is_staged(path))
                for path, spec in sharding.flat_specs(
                    self.cfg, self.parallel.tensor_parallel_size)]

    def _zero1_slices(self, zero1: bool):
        """Per unit, per leaf: the slice of the shard whose optimizer
        state the unit holds (``zero1_moment_spec``'s data dim over the
        stage's logical shape, never the layer dim of a slab; JAX shards
        the moments over the data axis only, so context copies each hold
        the same slice), or None for the whole shard (an expert-parallel
        leaf, already split over the data index, is not split again: the
        JAX package's ``zero1_moment_spec``)."""
        d, t = (self.parallel.data_parallel_size,
                self.parallel.tensor_parallel_size)
        out = []
        for i, tree in zip(self.units, self._unit_trees()):
            row = []
            for (_, spec, staged), p in zip(self._leaf_specs(), _leaves(tree)):
                shape = list(p.shape)
                sd = sharding.split_dim(spec)
                if sd is not None:
                    shape[sd] *= t
                if sharding.data_dim(spec) is not None:
                    row.append(None)
                    continue
                if staged:
                    spec = ("pipe",) + tuple(spec[1:])
                zspec = sharding.zero1_moment_spec(
                    spec, shape, d if zero1 else 1)
                if sharding.DATA not in zspec:
                    row.append(None)
                    continue
                z = zspec.index(sharding.DATA)
                n = p.shape[z] // d
                row.append((z, data_index(self.mesh, i) * n, n))
            out.append(row)
        return out

    def _sum_grads(self, acc):
        """Each leaf's gradient summed over the units that hold its
        values (``mesh.holders``: a split leaf over its model index, a
        block leaf within its stage, over everything else it is
        replicated on, data and context copies alike; an expert-parallel
        leaf over its data index too).
        ``acc[unit][leaf]`` -> the same nesting; units on one device
        share the summed tensor."""
        unit_of = self._unit_of()
        out = [list(row) for row in acc]
        for k, (_, spec, staged) in enumerate(self._leaf_specs()):
            split = sharding.split_dim(spec) is not None
            dsplit = sharding.data_dim(spec) is not None
            done = set()
            for i in self.units:
                if unit_of[i] in done:
                    continue
                grp = list(dict.fromkeys(
                    unit_of[m] for m in holders(self.mesh, i, split, staged,
                                                dsplit)))
                done.update(grp)
                summed = C.all_reduce([acc[u][k] for u in grp],
                                      [self.members[self.units[u]]
                                       for u in grp])
                for u, g in zip(grp, summed):
                    out[u][k] = g
        return out

    def _logical_norm(self, grads):
        """The norm of the logical gradient: each element once (context
        index 0; data index 0 but for an expert-parallel leaf, whose every
        data slice counts; every model index of a split leaf; every stage
        of a block leaf)."""
        unit_of = self._unit_of()
        total = None
        p, t, d = (self.parallel.pipeline_parallel_size,
                   self.parallel.tensor_parallel_size,
                   self.parallel.data_parallel_size)
        for k, (_, spec, staged) in enumerate(self._leaf_specs()):
            split = sharding.split_dim(spec) is not None
            dsplit = sharding.data_dim(spec) is not None
            for s in (range(p) if staged else [0]):
                for g in (range(d) if dsplit else [0]):
                    for j in (range(t) if split else [0]):
                        u = unit_of[member_at(self.mesh, s, g, j)]
                        sq = grads[u][k].float().pow(2).sum().to(self.device)
                        total = sq if total is None else total + sq
        return torch.sqrt(total)

    def _data_groups(self):
        """Each data group (one stage, context and model index) as the
        indices of its units in data order, each group once (context
        copies on one device share their units)."""
        unit_of = self._unit_of()
        groups = {}
        for i in self.units:
            grp = tuple(unit_of[m] for m in data_group(self.mesh, i))
            groups.setdefault(grp, None)
        return list(groups)

    def _gather_zero1(self):
        """After a ZeRO-1 step each data member holds its own updated
        slice of every split-over-data leaf: all-gather the slices over
        each data group into every unit's shard."""
        leaves = [list(_leaves(tr)) for tr in self._unit_trees()]
        for k in range(len(leaves[0])):
            for grp in self._data_groups():
                sl = self._zero1[grp[0]][k]
                if sl is None:
                    continue
                parts = [leaves[u][k].narrow(*self._zero1[u][k])
                         for u in grp]
                full = C.all_gather(
                    parts, [self.members[self.units[u]] for u in grp],
                    dim=sl[0])
                for u, f in zip(grp, full):
                    leaves[u][k].copy_(f)

    # ------------------------------------------------------------------
    # Optimizer state across the numpy boundary
    # ------------------------------------------------------------------
    def opt_state_spec(self):
        """(shape, numpy dtype) of each optimizer-state leaf, in the JAX
        package's leaf order (``AdamW.state_leaves``); a sharded
        engine's are the canonical leaves a one-device engine has."""
        if not self.sharded:
            return self.optimizer.state_spec()
        t = self.parallel.tensor_parallel_size
        p = self.parallel.pipeline_parallel_size
        canon = []
        for (path, spec, staged), leaf in zip(self._leaf_specs(),
                                              _leaves(self.params.trees[0])):
            shape = list(sharding.canonical_shape(
                self.cfg, path, spec, leaf.shape, t,
                self.parallel.data_parallel_size))
            if staged:
                shape[0] *= p
            canon.append(tuple(shape))
        f32 = np.dtype(np.float32)
        n_master = sum(w is not None for w in self.optimizer.master[
            :len(canon)])
        count = ((), np.dtype(np.int32))
        return ([(s, f32) for s in canon[:n_master]] + [count]
                + [(s, f32) for s in canon] * 2 + [count])

    def iter_opt_state_numpy(self):
        """Yield the optimizer-state leaves as host numpy arrays, one at a
        time, in the JAX package's order, dtypes and 0-d step counts. An
        offloaded state is read from its pinned host copy. A sharded
        engine gathers each leaf over its members (data slices, model
        shards, stage slabs) and cuts the vocabulary padding off."""
        if not self.sharded:
            for x in self.optimizer.state_leaves():
                yield (np.asarray(x, np.int32) if isinstance(x, int)
                       else tensor_to_numpy(x))
            return
        opt = self.optimizer
        count = np.asarray(opt.count, np.int32)
        if any(w is not None for w in opt.master):
            yield from map(tensor_to_numpy, self._canonical_state(opt.master))
        yield count
        yield from map(tensor_to_numpy, self._canonical_state(opt.m))
        yield from map(tensor_to_numpy, self._canonical_state(opt.v))
        yield count

    def _canonical_state(self, per_unit, device="cpu"):
        """Per (member, leaf) state tensors -> each leaf's canonical
        tensor on ``device``: data slices concatenated along the ZeRO-1
        dim, model shards along the split dim, an expert-parallel leaf's
        data slices along its expert dim, stage slabs along the layer
        dim, the vocabulary unpadded."""
        k_leaves = len(self._zero1[0])
        par = self.parallel
        p, t, d = (par.pipeline_parallel_size, par.tensor_parallel_size,
                   par.data_parallel_size)
        unit_of = self._unit_of()
        for k, (path, spec, staged) in enumerate(self._leaf_specs()):
            dsplit = sharding.data_dim(spec) is not None
            parts = []
            for s in range(p if staged else 1):
                row = []
                for g in range(d if dsplit else 1):
                    for j in range(t):
                        at = member_at(self.mesh, s, g, j)
                        grp = ([unit_of[at]] if dsplit else
                               [unit_of[m] for m in data_group(self.mesh, at)])
                        sl = self._zero1[grp[0]][k]
                        ds = [per_unit[m * k_leaves + k].to(device)
                              for m in grp]
                        row.append(torch.cat(ds, dim=sl[0]) if sl is not None
                                   else ds[0])
                parts.append(row)
            full = sharding.join_chunks(parts, path, spec, d)
            yield sharding.repad_vocab_leaf(self.cfg, path, full, 1)

    def opt_state_numpy(self) -> list:
        return list(self.iter_opt_state_numpy())

    def load_opt_state(self, host_leaves: list):
        """Install host leaves in ``iter_opt_state_numpy``'s order (the
        restore path, ``engine/opt_checkpoint.py``); a sharded engine
        pads, splits and slices each canonical leaf onto its members."""
        if not self.sharded:
            self.optimizer.load_state_leaves(host_leaves)
            return
        opt = self.optimizer
        k = len(self._zero1[0])
        n_master = (k if any(w is not None for w in opt.master) else 0)
        leaves = list(host_leaves)
        counts = {int(leaves[n_master]), int(leaves[-1])}
        if len(counts) != 1:
            raise ValueError(
                f"adam and schedule step counts differ: {sorted(counts)}")
        groups = ([opt.master] if n_master else []) + [opt.m, opt.v]
        values = (leaves[:n_master] + leaves[n_master + 1:-1])
        opt.ensure_on_device()
        for g, per_unit in enumerate(groups):
            for kk, arr in enumerate(values[g * k:(g + 1) * k]):
                self._scatter_state(per_unit, kk, arr)
        opt.count = counts.pop()

    def _scatter_state(self, per_unit, k, arr):
        path, spec, staged = self._leaf_specs()[k]
        par = self.parallel
        p, t = par.pipeline_parallel_size, par.tensor_parallel_size
        full = sharding.repad_vocab_leaf(
            self.cfg, path, torch.from_numpy(np.asarray(arr, np.float32)),
            t)
        for u, m in enumerate(self.units):
            shard = sharding.member_chunk(
                full, path, spec, pipe_index(self.mesh, m),
                model_index(self.mesh, m), p if staged else 1, t,
                data_index(self.mesh, m), par.data_parallel_size)
            sl = self._zero1[u][k]
            if sl is not None:
                shard = shard.narrow(*sl)
            per_unit[u * len(self._zero1[0]) + k].copy_(shard)

    def _tensor(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def train_batch(self, microbatches: List[Dict[str, np.ndarray]],
                    loss_fn: LossFn,
                    loss_weights: Optional[List[float]] = None,
                    loss_fn_key: Optional[str] = None) -> Dict[str, float]:
        """One optimizer step over the microbatches (numpy arrays, one
        dict each). Each microbatch's gradient enters the fp32 sum with
        weight ``w / sum(w)``, so equal-mean losses add up to the
        one-big-batch gradient; ``loss``, ``grad_norm`` (of the summed
        gradient, before clipping) and every stat come back weighted the
        same way. A loss that reports ``__skip_update__ > 0`` (weighted)
        discards the step: params, moments and step count stay, and
        ``early_stop_skipped`` is 1. ``loss_fn_key`` names the loss for
        the JAX package's compile cache and is unused here."""
        return self.train_minibatches(
            [microbatches], loss_fn,
            None if loss_weights is None else [loss_weights])[0]

    def train_minibatches(self,
                          minibatches: List[List[Dict[str, np.ndarray]]],
                          loss_fn: LossFn,
                          loss_weights: Optional[List[List[float]]] = None,
                          loss_fn_key: Optional[str] = None
                          ) -> List[Dict[str, float]]:
        """One optimizer step per minibatch, in order, each over its
        microbatches as ``train_batch`` describes; returns one stats dict
        per minibatch and advances ``version`` by their number (a
        skipped update still counts). With ``OptimizerConfig.offload``
        the optimizer state, which the first update brings to the device,
        goes back to the host after the last. ``loss_fn_key`` is unused,
        as in ``train_batch``."""
        if self.optimizer is None:
            raise RuntimeError("Engine has no optimizer (inference-only).")
        if loss_weights is None:
            loss_weights = [None] * len(minibatches)
        out = [self._train_step(mbs, loss_fn, w)
               for mbs, w in zip(minibatches, loss_weights)]
        if self.optimizer.cfg.offload:
            self.optimizer.offload()
        return out

    def _train_step(self, microbatches, loss_fn, loss_weights):
        n = len(microbatches)
        w = np.asarray(loss_weights if loss_weights is not None
                       else [1.0] * n, np.float32)
        w = (w / w.sum()).tolist()
        trees = self._unit_trees() if self.sharded else [self.params]
        leaves = [list(_leaves(tr)) for tr in trees]
        acc = [[torch.zeros_like(p, dtype=torch.float32) for p in row]
               for row in leaves]
        flat = [p for row in leaves for p in row]
        losses, stats = [], []
        try:
            for p in flat:
                p.requires_grad_(True)
            for mb, wi in zip(microbatches, w):
                batch = {k: torch.as_tensor(np.asarray(v), device=self.device)
                         for k, v in mb.items()}
                loss, st = loss_fn(self.params, batch)
                loss.backward()
                for arow, prow in zip(acc, leaves):
                    for a, p in zip(arow, prow):
                        if p.grad is not None:
                            a.add_(p.grad, alpha=wi)
                            p.grad = None
                losses.append(loss.detach().float())
                stats.append({k: v.detach().float() for k, v in st.items()})
        finally:
            for p in flat:
                p.requires_grad_(False)
                p.grad = None
        if self.sharded:
            grads = self._sum_grads(acc)
            gnorm = self._logical_norm(grads)
        else:
            grads = acc
            gnorm = optim.global_norm(acc[0])
        mean = {k: sum(s[k] * wi for s, wi in zip(stats, w))
                for k in stats[0]}
        mean["loss"] = sum(x * wi for x, wi in zip(losses, w))
        mean["grad_norm"] = gnorm
        out = dict(zip(mean, torch.stack(
            [v.to(self.device) for v in mean.values()]).tolist()))
        skip = out.pop("__skip_update__", None)
        if skip is not None:
            out["early_stop_skipped"] = float(skip > 0)
        if skip is None or skip <= 0:
            if self.sharded:
                self.optimizer.step(flat, [g for row in grads for g in row],
                                    gnorm=gnorm)
                self._gather_zero1()
            else:
                self.optimizer.step(flat, grads[0])
        self.version += 1
        return out

    # ------------------------------------------------------------------
    # Weight offload
    # ------------------------------------------------------------------
    def offload(self):
        """Move the weights to pinned host memory and free their device
        memory. Whoever runs the model next calls ``ensure_on_device``
        first (``ModelHost.execute`` does, before every MFC)."""
        if self.offloaded:
            return
        if self.device.type == "cuda":
            trees = self._unit_trees() if self.sharded else [self.params]
            leaves = [p for tr in trees for p in _leaves(tr)]
            self._host_params = offload.to_pinned_host(leaves,
                                                       self._host_params)
            self._devices = [p.device for p in leaves]
            it = iter(self._host_params)
            for tr in trees:
                _set_leaves(tr, [next(it) for _ in _leaves(tr)])
        self.offloaded = True

    def ensure_on_device(self):
        """Bring offloaded weights back to this engine's device (every
        member's to its own)."""
        if not self.offloaded:
            return
        if self.device.type == "cuda":
            moved = iter(offload.to_devices(self._host_params,
                                            self._devices))
            trees = self._unit_trees() if self.sharded else [self.params]
            for tr in trees:
                _set_leaves(tr, [next(moved) for _ in _leaves(tr)])
        self.offloaded = False

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def forward_hidden(self, input_ids, seg_ids) -> torch.Tensor:
        h, _ = T.forward(self.cfg, self.params, self._tensor(input_ids),
                         self._tensor(seg_ids),
                         pipeline=self.pipeline_ctx_infer)
        if self.sharded:  # each data group's first model member's copy
            return T._gather_rows([None if x is None else x[0]
                                   for x in h.hs], self.device)
        return h

    @torch.inference_mode()
    def forward_logprobs(self, input_ids, seg_ids, temperature: float = 1.0,
                         logits_mask=None) -> torch.Tensor:
        """Next-token log-probs [S, L] fp32 (0 at segment ends and pads)."""
        ids, seg = self._tensor(input_ids), self._tensor(seg_ids)
        h, _ = T.forward(self.cfg, self.params, ids, seg,
                         pipeline=self.pipeline_ctx_infer)
        mask = (None if logits_mask is None
                else self._tensor(logits_mask, dtype=torch.bool))
        return F.shifted_logprobs_from_hidden(
            self.cfg, self.params, h, ids, seg, temperature=temperature,
            logits_mask=mask)

    @torch.inference_mode()
    def forward_values(self, input_ids, seg_ids) -> torch.Tensor:
        """Critic or reward scalar outputs [S, L] fp32."""
        if not self.cfg.is_critic:
            raise ValueError("forward_values needs a critic model.")
        h, _ = T.forward(self.cfg, self.params, self._tensor(input_ids),
                         self._tensor(seg_ids),
                         pipeline=self.pipeline_ctx_infer)
        return T.critic_values(self.cfg, self.params, h)

    def generate(self, prompt_ids, prompt_seg, prompt_pos,
                 generator: Optional[torch.Generator],
                 gconfig: GenerationHyperparameters,
                 eos_token_id: Optional[int], pad_token_id: int
                 ) -> gen_mod.GenerationOutput:
        """Batch generation from [B, Lp] left-padded prompts (numpy or
        tensors); ``generator`` must live on this engine's device. Runs
        on the decode view (``decode_engine``) where there is one."""
        eng = self.decode_engine()
        out = gen_mod.generate(
            self.cfg, eng.params, eng._tensor(prompt_ids),
            eng._tensor(prompt_seg), eng._tensor(prompt_pos), generator,
            gconfig, eos_token_id=eos_token_id, pad_token_id=pad_token_id)
        self.generate_stats.append(dict(out.stats))
        return out

    # ------------------------------------------------------------------
    # The decode view
    # ------------------------------------------------------------------
    def decode_engine(self) -> "Engine":
        """The engine generation runs on: this one for a dNtM layout at
        ``g == t`` (it decodes in place), else the decode view.

        On a pipeline or context-parallel layout, or at ``g != t``: an
        optimizer-free engine at ``d' = n / g``, ``t' = g`` over the same
        member devices, built once and kept. Its weights come by
        ``reallocate`` from this engine's, one leaf in flight, whenever
        this engine's ``version`` or ``params_epoch`` moved since they
        last did, or after ``drop_decode_view``; a refresh writes them
        in place (never a second copy)."""
        par = self.parallel
        g = par.gen_tp_size or par.tensor_parallel_size
        if (par.pipeline_parallel_size == 1
                and par.context_parallel_size == 1
                and g == par.tensor_parallel_size):
            return self
        if self._decode_view is None:
            view_par = ParallelismConfig(data_parallel_size=len(self.members)
                                         // g, tensor_parallel_size=g)
            logger.info("Building the decode view %s of a %s layout",
                        view_par, par)
            self._decode_view = Engine(self.cfg, None, parallel=view_par,
                                       devices=self.members)
        view = self._decode_view
        key = self._weights_key()
        if view.params is None:
            view.set_params(None)
            self._view_key = None
        if self._view_key != key:
            from realhf_tpu_torch.parallel.realloc import reallocate
            reallocate(self.cfg, self.params, view)
            self._view_key = key
        return view

    def _weights_key(self):
        """What the decode view's freshness is keyed on: the optimizer
        steps and the installs of weights (the port updates its weights
        in place, so the weights object's identity never moves)."""
        return (self.version, self.params_epoch)

    def drop_decode_view(self):
        """Free the decode view's weights (the view object stays; the
        next generate moves the weights in again)."""
        if self._decode_view is not None:
            self._decode_view.params = None
            self._view_key = None

    def decode_view_param_bytes(self) -> int:
        """Bytes the decode view's weights hold over all its members (0
        when there is none or it was dropped): one logical copy split
        over the view's t and replicated over its d, the quantity
        ``drop_decode_view`` frees."""
        view = self._decode_view
        if view is None or view.params is None:
            return 0
        return sum(p.numel() * p.element_size()
                   for tr in view._unit_trees() for p in _leaves(tr))

    def set_gen_tp(self, gen_tp: int):
        """Install a decode-view model degree (the allocation
        shorthand's ``g``), checked against the layout now; a changed
        degree discards the view."""
        n = len(self.members)
        if gen_tp and n % gen_tp:
            raise ValueError(f"gen_tp_size={gen_tp} does not divide the "
                             f"layout's {n} devices.")
        if gen_tp == self.parallel.gen_tp_size:
            return
        self.parallel = dataclasses.replace(self.parallel,
                                            gen_tp_size=gen_tp)
        self._decode_view = None
        self._view_key = None


def _leaves(tree):
    """Leaves in sorted-key order, whatever order the dicts were built
    in (the optimizer's state lists follow it)."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k])
        else:
            yield tree[k]


def _set_leaves(tree, leaves):
    """Put ``leaves`` (in ``_leaves`` order) into the tree, in place."""
    it = iter(leaves)

    def fill(t):
        for k in sorted(t):
            if isinstance(t[k], dict):
                fill(t[k])
            else:
                t[k] = next(it)

    fill(tree)


def _tree_map(fn, tree):
    return {k: (_tree_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}
