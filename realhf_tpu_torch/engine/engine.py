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

from realhf_tpu_torch.base.device import DeviceLike, resolve_device
from realhf_tpu_torch.base.safetensors_io import tensor_to_numpy
from realhf_tpu_torch.engine import generation as gen_mod
from realhf_tpu_torch.engine import offload, optim, packing
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.models.convert import params_from_numpy, params_numpy
from realhf_tpu_torch.ops import functional as F
from realhf_tpu_torch.ops.sampling import GenerationHyperparameters
from realhf_tpu_torch.parallel.mesh import (
    ParallelismConfig,
    default_devices,
    make_mesh,
)

_CTX_TRAIN = ("training on a context-parallel layout (the differentiable "
              "ring on CUDA) is a later slice of the port (ROADMAP.md, "
              "queue 5).")

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
        self.cfg = cfg
        self.parallel = parallel or ParallelismConfig()
        n = self.parallel.world_size
        if n > 1:
            #: the context-parallel members' devices, in ring order
            self.members = list(make_mesh(
                self.parallel, devices if devices is not None
                else default_devices(n, device)).devices)
        else:
            self.members = [resolve_device(
                devices[0] if devices is not None else device)]
        self.device = self.members[0]
        self._ctx = n > 1
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
        if optimizer is not None and optimizer.type != "empty":
            if self._ctx:
                raise NotImplementedError(_CTX_TRAIN)
            if optimizer.zero1:
                raise NotImplementedError(
                    "ZeRO-1 optimizer-state sharding is deferred to the "
                    "parallelism slice of the port.")
            self.optimizer = optim.AdamW(optimizer, list(_leaves(self.params)),
                                         total_train_steps)

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
        """Install new weights (a tensor or numpy tree) on the device.
        The optimizer state, fp32 master copies included, is kept, as in
        the JAX package."""
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
        """Host numpy copy with the JAX package's paths and shapes."""
        return params_numpy(self.params)

    # ------------------------------------------------------------------
    # Optimizer state across the numpy boundary
    # ------------------------------------------------------------------
    def opt_state_spec(self):
        """(shape, numpy dtype) of each optimizer-state leaf, in the JAX
        package's leaf order (``AdamW.state_leaves``)."""
        return self.optimizer.state_spec()

    def iter_opt_state_numpy(self):
        """Yield the optimizer-state leaves as host numpy arrays, one at a
        time, in the JAX package's order, dtypes and 0-d step counts. An
        offloaded state is read from its pinned host copy."""
        for x in self.optimizer.state_leaves():
            yield (np.asarray(x, np.int32) if isinstance(x, int)
                   else tensor_to_numpy(x))

    def opt_state_numpy(self) -> list:
        return list(self.iter_opt_state_numpy())

    def load_opt_state(self, host_leaves: list):
        """Install host leaves in ``iter_opt_state_numpy``'s order (the
        restore path, ``engine/opt_checkpoint.py``)."""
        self.optimizer.load_state_leaves(host_leaves)

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
        leaves = list(_leaves(self.params))
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        losses, stats = [], []
        try:
            for p in leaves:
                p.requires_grad_(True)
            for mb, wi in zip(microbatches, w):
                batch = {k: torch.as_tensor(np.asarray(v), device=self.device)
                         for k, v in mb.items()}
                loss, st = loss_fn(self.params, batch)
                loss.backward()
                for a, p in zip(acc, leaves):
                    if p.grad is not None:
                        a.add_(p.grad, alpha=wi)
                        p.grad = None
                losses.append(loss.detach().float())
                stats.append({k: v.detach().float() for k, v in st.items()})
        finally:
            for p in leaves:
                p.requires_grad_(False)
                p.grad = None
        gnorm = optim.global_norm(acc)
        mean = {k: sum(s[k] * wi for s, wi in zip(stats, w))
                for k in stats[0]}
        mean["loss"] = sum(x * wi for x, wi in zip(losses, w))
        mean["grad_norm"] = gnorm
        out = dict(zip(mean, torch.stack(list(mean.values())).tolist()))
        skip = out.pop("__skip_update__", None)
        if skip is not None:
            out["early_stop_skipped"] = float(skip > 0)
        if skip is None or skip <= 0:
            self.optimizer.step(leaves, acc)
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
            self._host_params = offload.to_pinned_host(
                list(_leaves(self.params)), self._host_params)
            _set_leaves(self.params, self._host_params)
            self._member_params = None  # other devices' copies go too
        self.offloaded = True

    def ensure_on_device(self):
        """Bring offloaded weights back to this engine's device."""
        if not self.offloaded:
            return
        if self.device.type == "cuda":
            _set_leaves(self.params, offload.to_device(self._host_params,
                                                       self.device))
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
                "package's decode view, engine.py:653) is a later slice of "
                "the port.")
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
