"""The per-model execution engine: train, inference and generate.

One ``Engine`` holds one model's parameters on one device, or on the
members of a context-parallel layout (below). It runs the inference
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

Context parallelism (``parallel.context_parallel_size = n > 1``, over
``devices``: n entries, repeats allowed, default ``cuda:0 .. n-1``): the
inference forwards pad each stream's L to a multiple of ``n * 8`` with
segment id 0, take positions and next-token labels from the whole
stream, give member i the i-th contiguous shard of every stream, run
``transformer.forward_ctx`` (ring attention between each block's
halves) and gather the ``[S, L]`` outputs back on the first member's
device. The weights are placed once per distinct device; members that
share a device share that copy. Training and generation on such a layout
raise (later slices). ``offload`` keeps one pinned host copy and frees
every device's; ``ensure_on_device`` places it on every device again.
"""

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from realhf_tpu_torch.base import logging
from realhf_tpu_torch.base.device import DeviceLike, resolve_device
from realhf_tpu_torch.base.safetensors_io import tensor_to_numpy
from realhf_tpu_torch.engine import generation as gen_mod
from realhf_tpu_torch.engine import offload, optim, packing
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
    default_devices,
    make_mesh,
    model_group,
)

logger = logging.getLogger("engine")

_CTX_TRAIN = ("training on a context-parallel layout (the differentiable "
              "ring on CUDA) is a later part of ROADMAP.md, queue 1, "
              "item 4.")

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
            #: the members' devices: in ring order (ctx), or in (data,
            #: model) order
            self.members = list(self.mesh.devices)
        else:
            self.members = [resolve_device(
                devices[0] if devices is not None else device)]
        self.device = self.members[0]
        self._ctx = self.parallel.context_parallel_size > 1
        #: data and tensor parallelism over more than one member
        self.sharded = n > 1 and not self._ctx
        if self.sharded:
            T.check_layout(cfg, self.parallel.tensor_parallel_size)
        self.params = None
        self._member_params = None
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
            if self._ctx:
                raise NotImplementedError(_CTX_TRAIN)
            if self.sharded:
                self._zero1 = self._zero1_slices(optimizer.zero1)
                self.optimizer = optim.AdamW(
                    optimizer, self._member_leaves(), total_train_steps,
                    slices=[sl for m in self._zero1 for sl in m])
            else:
                self.optimizer = optim.AdamW(
                    optimizer, list(_leaves(self.params)), total_train_steps)

    @property
    def n_streams(self) -> int:
        """Preferred [S, L] stream-batch rows: one per data member."""
        return self.parallel.data_parallel_size

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
        copies included, is kept, as in the JAX package."""
        if isinstance(params, MemberParams):
            params = sharding.gather_params(self.cfg, params.group(0)[0])
        if self.sharded:
            t = self.parallel.tensor_parallel_size
            self.params = MemberParams(
                params_from_numpy(params, dtype=T.dtype_of(
                    self.cfg.param_dtype), cfg=self.cfg,
                    devices=self.members, t=t),
                list(self.members), self.parallel.data_parallel_size, t)
            self.offloaded = False
            return
        self.params = self._cast_param_dtype(params)
        self._place_members()
        self.offloaded = False

    def _place_members(self):
        """Every member's weights: this engine's copy on the first
        member's device, one more copy per other distinct device."""
        on = {self.device: self.params}
        for d in self.members:
            if d not in on:
                on[d] = _tree_map(lambda a, d=d: a.to(d), self.params)
        self._member_params = [on[d] for d in self.members]

    def params_numpy(self):
        """Host numpy copy with the JAX package's paths and shapes (the
        canonical, unpadded tree at any layout)."""
        if self.sharded:
            return params_numpy(self.gathered_params("cpu"))
        return params_numpy(self.params)

    def gathered_params(self, device=None):
        """The canonical tree of a sharded engine's weights, gathered
        from the first data group's members onto ``device`` (default:
        the first member's)."""
        dev = torch.device(device) if device is not None else self.device
        trees, _ = self.params.group(0)
        return sharding.gather_params(
            self.cfg, [_tree_map(lambda a: a.to(dev), tr) for tr in trees])

    def _member_leaves(self) -> List[torch.Tensor]:
        """Every member's leaves, member-major, each in ``_leaves``
        order."""
        return [p for tr in self.params.trees for p in _leaves(tr)]

    # ------------------------------------------------------------------
    # ZeRO-1 and the gradient sums of a sharded engine
    # ------------------------------------------------------------------
    def _leaf_specs(self):
        return [spec for _, spec in sharding.flat_specs(self.cfg)]

    def _zero1_slices(self, zero1: bool):
        """Per member, per leaf: the slice of the shard whose optimizer
        state the member holds (``zero1_moment_spec``'s data dim over
        the logical shape), or None for the whole shard."""
        d, t = (self.parallel.data_parallel_size,
                self.parallel.tensor_parallel_size)
        specs = self._leaf_specs()
        out = []
        for i, tree in enumerate(self.params.trees):
            row = []
            for spec, p in zip(specs, _leaves(tree)):
                shape = list(p.shape)
                sd = sharding.split_dim(spec)
                if sd is not None:
                    shape[sd] *= t
                zspec = sharding.zero1_moment_spec(
                    spec, shape, d if zero1 else 1)
                if sharding.DATA not in zspec:
                    row.append(None)
                    continue
                z = zspec.index(sharding.DATA)
                n = p.shape[z] // d
                row.append((z, (i // t) * n, n))
            out.append(row)
        return out

    def _sum_grads(self, acc):
        """Each leaf's gradient summed over the members that hold it: a
        split leaf over its data group, a replicated leaf over every
        member. ``acc[member][leaf]`` -> the same nesting; members on
        one device share the summed tensor."""
        specs = self._leaf_specs()
        out = [list(row) for row in acc]
        for k, spec in enumerate(specs):
            if sharding.split_dim(spec) is None:
                groups = [list(range(len(self.members)))]
            else:
                groups = [data_group(self.mesh, j)
                          for j in range(self.parallel.tensor_parallel_size)]
            for grp in groups:
                summed = C.all_reduce([acc[m][k] for m in grp],
                                      [self.members[m] for m in grp])
                for m, g in zip(grp, summed):
                    out[m][k] = g
        return out

    def _logical_norm(self, grads):
        """The norm of the logical gradient: each split leaf's t shards
        once, each replicated leaf once (from the first data group)."""
        total = None
        for k, spec in enumerate(self._leaf_specs()):
            grp = (model_group(self.mesh, 0)
                   if sharding.split_dim(spec) is not None else [0])
            for m in grp:
                sq = grads[m][k].float().pow(2).sum().to(self.device)
                total = sq if total is None else total + sq
        return torch.sqrt(total)

    def _gather_zero1(self):
        """After a ZeRO-1 step each data member holds its own updated
        slice of every split-over-data leaf: all-gather the slices over
        the data group into every member's shard."""
        t = self.parallel.tensor_parallel_size
        leaves = [list(_leaves(tr)) for tr in self.params.trees]
        for k in range(len(leaves[0])):
            for j in range(t):
                grp = data_group(self.mesh, j)
                sl = self._zero1[grp[0]][k]
                if sl is None:
                    continue
                z = sl[0]
                parts = [leaves[m][k].narrow(*self._zero1[m][k])
                         for m in grp]
                full = C.all_gather(parts, [self.members[m] for m in grp],
                                    dim=z)
                for m, f in zip(grp, full):
                    leaves[m][k].copy_(f)

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
        canon = [sharding.canonical_shape(self.cfg, path, spec, p.shape, t)
                 for (path, spec), p in zip(sharding.flat_specs(self.cfg),
                                            _leaves(self.params.trees[0]))]
        f32 = np.dtype(np.float32)
        n_master = sum(w is not None for w in self.optimizer.master[
            :len(canon)])
        count = ((), np.dtype(np.int32))
        return ([(tuple(s), f32) for s in canon[:n_master]] + [count]
                + [(tuple(s), f32) for s in canon] * 2 + [count])

    def iter_opt_state_numpy(self):
        """Yield the optimizer-state leaves as host numpy arrays, one at a
        time, in the JAX package's order, dtypes and 0-d step counts. An
        offloaded state is read from its pinned host copy. A sharded
        engine gathers each leaf over its members and cuts the
        vocabulary padding off."""
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
        dim, model shards along the split dim, the vocabulary
        unpadded."""
        k_leaves = len(self._zero1[0])
        t = self.parallel.tensor_parallel_size
        for k, (path, spec) in enumerate(sharding.flat_specs(self.cfg)):
            shards = []
            for j in range(t):
                grp = data_group(self.mesh, j)
                sl = self._zero1[grp[0]][k]
                parts = [per_unit[m * k_leaves + k].to(device) for m in grp]
                shards.append(torch.cat(parts, dim=sl[0]) if sl is not None
                              else parts[0])
            sd = sharding.split_dim(spec)
            full = torch.cat(shards, dim=sd) if sd is not None else shards[0]
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
        path, spec = sharding.flat_specs(self.cfg)[k]
        t = self.parallel.tensor_parallel_size
        full = sharding.repad_vocab_leaf(
            self.cfg, path, torch.from_numpy(np.asarray(arr, np.float32)),
            t)
        sd = sharding.split_dim(spec)
        for m in range(len(self.members)):
            shard = (full.chunk(t, dim=sd)[m % t] if sd is not None
                     else full)
            sl = self._zero1[m][k]
            if sl is not None:
                shard = shard.narrow(*sl)
            per_unit[m * len(self._zero1[0]) + k].copy_(shard)

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
        if self._ctx:
            raise NotImplementedError(_CTX_TRAIN)
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
        trees = self.params.trees if self.sharded else [self.params]
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
            trees = self.params.trees if self.sharded else [self.params]
            leaves = [p for tr in trees for p in _leaves(tr)]
            self._host_params = offload.to_pinned_host(leaves,
                                                       self._host_params)
            self._devices = [p.device for p in leaves]
            it = iter(self._host_params)
            for tr in trees:
                _set_leaves(tr, [next(it) for _ in _leaves(tr)])
            self._member_params = None  # other devices' copies go too
        self.offloaded = True

    def ensure_on_device(self):
        """Bring offloaded weights back to this engine's device (every
        member's to its own)."""
        if not self.offloaded:
            return
        if self.device.type == "cuda":
            moved = iter(offload.to_devices(self._host_params,
                                            self._devices))
            trees = self.params.trees if self.sharded else [self.params]
            for tr in trees:
                _set_leaves(tr, [next(moved) for _ in _leaves(tr)])
            if not self.sharded:
                self._place_members()
        self.offloaded = False

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def forward_hidden(self, input_ids, seg_ids) -> torch.Tensor:
        if self._ctx:
            n_real, ids, seg = self._ctx_pad(input_ids, seg_ids)
            return self._gather(self._ctx_hidden(ids, seg), n_real)
        h, _ = T.forward(self.cfg, self.params, self._tensor(input_ids),
                         self._tensor(seg_ids))
        if self.sharded:  # each data group's first model member's copy
            return T._gather_rows([None if x is None else x[0]
                                   for x in h.hs], self.device)
        return h

    @torch.inference_mode()
    def forward_logprobs(self, input_ids, seg_ids, temperature: float = 1.0,
                         logits_mask=None) -> torch.Tensor:
        """Next-token log-probs [S, L] fp32 (0 at segment ends and pads)."""
        if self._ctx:
            return self._ctx_logprobs(input_ids, seg_ids, temperature,
                                      logits_mask)
        ids, seg = self._tensor(input_ids), self._tensor(seg_ids)
        h, _ = T.forward(self.cfg, self.params, ids, seg)
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
        if self._ctx:
            n_real, ids, seg = self._ctx_pad(input_ids, seg_ids)
            hs = self._ctx_hidden(ids, seg)
            return self._gather([T.critic_values(self.cfg, p, h) for p, h
                                 in zip(self._member_params, hs)], n_real)
        h, _ = T.forward(self.cfg, self.params, self._tensor(input_ids),
                         self._tensor(seg_ids))
        return T.critic_values(self.cfg, self.params, h)

    def generate(self, prompt_ids, prompt_seg, prompt_pos,
                 generator: Optional[torch.Generator],
                 gconfig: GenerationHyperparameters,
                 eos_token_id: Optional[int], pad_token_id: int
                 ) -> gen_mod.GenerationOutput:
        """Batch generation from [B, Lp] left-padded prompts (numpy or
        tensors); ``generator`` must live on this engine's device."""
        if self._ctx:
            raise NotImplementedError(
                "generation on a context-parallel layout (the JAX "
                "package's decode view, engine.py:653) is a later part of "
                "ROADMAP.md, queue 1, item 4.")
        out = gen_mod.generate(
            self.cfg, self.params, self._tensor(prompt_ids),
            self._tensor(prompt_seg), self._tensor(prompt_pos), generator,
            gconfig, eos_token_id=eos_token_id, pad_token_id=pad_token_id)
        self.generate_stats.append(dict(out.stats))
        return out

    # ------------------------------------------------------------------
    # Context parallelism
    # ------------------------------------------------------------------
    def _ctx_pad(self, input_ids, seg_ids):
        """-> (the caller's L, ids, seg): [S, L] padded to a multiple of
        n * 8 with segment id 0, on the first member's device."""
        mult = 8 * len(self.members)
        seg_ids = np.asarray(seg_ids)
        return (seg_ids.shape[1],
                self._tensor(packing.pad_stream_len(input_ids, mult)),
                self._tensor(packing.pad_stream_len(seg_ids, mult)))

    def _split(self, t: torch.Tensor) -> List[torch.Tensor]:
        """[S, L, ...] -> member i's contiguous i-th shard along L, on
        its device."""
        return [c.to(d).contiguous() for c, d in
                zip(t.chunk(len(self.members), dim=1), self.members)]

    def _gather(self, shards: List[torch.Tensor], n_real: int):
        """Members' [S, lc, ...] outputs -> [S, L, ...] on this engine's
        device, cut back to the caller's L."""
        return torch.cat([s.to(self.device) for s in shards],
                         dim=1)[:, :n_real]

    def _ctx_hidden(self, ids, seg) -> List[torch.Tensor]:
        """Members' final hidden states of padded [S, L] streams; the
        positions come from the whole streams."""
        pos = T.positions_from_segments(seg)
        return T.forward_ctx(self.cfg, self._member_params, self._split(ids),
                             self._split(seg), self._split(pos))

    def _ctx_logprobs(self, input_ids, seg_ids, temperature, logits_mask):
        n_real, ids, seg = self._ctx_pad(input_ids, seg_ids)
        # labels and validity from the whole stream: a shard's last
        # token predicts the next shard's first
        labels, valid = F.next_token_labels(ids, seg)
        hs = self._ctx_hidden(ids, seg)
        masks = [None] * len(self.members)
        if logits_mask is not None:
            mask = packing.pad_stream_len(logits_mask, 8 * len(self.members),
                                          fill=True)
            masks = self._split(self._tensor(mask, dtype=torch.bool))
        lps = [F.logprobs_from_hidden(self.cfg, p, h, lab, val,
                                      temperature=temperature,
                                      logits_mask=m)
               for p, h, lab, val, m in zip(
                   self._member_params, hs, self._split(labels),
                   self._split(valid), masks)]
        return self._gather(lps, n_real)


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
