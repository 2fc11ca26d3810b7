"""The per-model execution engine: train, inference and generate.

One ``Engine`` holds one model's parameters on one device. It runs the
inference forwards (hidden states, next-token log-probs, critic
values), batch generation, and, when built with an optimizer, one
optimizer step over a list of microbatches (``train_batch``): per
microbatch a forward and backward, the gradients accumulated in fp32 with
the microbatch's loss weight, then the JAX package's AdamW
(``engine/optim.py``). The engine owns the tensors it is given: a
training engine updates them in place.
"""

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from realhf_tpu_torch.base.device import DeviceLike, resolve_device
from realhf_tpu_torch.engine import generation as gen_mod
from realhf_tpu_torch.engine import optim
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.models.convert import params_from_numpy, params_numpy
from realhf_tpu_torch.ops import functional as F
from realhf_tpu_torch.ops.sampling import GenerationHyperparameters

#: loss_fn(params, microbatch tensors) -> (scalar loss, {name: scalar})
LossFn = Callable[[Any, Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


class Engine:

    def __init__(self, cfg: TransformerConfig, params: Any,
                 device: DeviceLike = None,
                 optimizer: Optional[optim.OptimizerConfig] = None,
                 total_train_steps: Optional[int] = None):
        T.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = None
        self.set_params(params)
        #: optimizer steps taken (train_batch calls)
        self.version = 0
        #: stats of each generate call (decode steps, tokens, seconds)
        self.generate_stats = []
        self.optimizer: Optional[optim.AdamW] = None
        if optimizer is not None and optimizer.type != "empty":
            if optimizer.offload:
                raise NotImplementedError(
                    "optimizer offload is deferred to the PPO slice of the "
                    "port.")
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
        """Install new weights (a tensor or numpy tree). The optimizer
        state, fp32 master copies included, is kept, as in the JAX
        package."""
        self.params = self._cast_param_dtype(params)

    def params_numpy(self):
        """Host numpy copy with the JAX package's paths and shapes."""
        return params_numpy(self.params)

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
        if self.optimizer is None:
            raise RuntimeError("Engine has no optimizer (inference-only).")
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

    def train_minibatches(self, *args, **kwargs):
        raise NotImplementedError(
            "several optimizer steps in one call (the PPO minibatch loop) "
            "are deferred to the PPO slice of the port.")

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def forward_hidden(self, input_ids, seg_ids) -> torch.Tensor:
        h, _ = T.forward(self.cfg, self.params, self._tensor(input_ids),
                         self._tensor(seg_ids))
        return h

    @torch.inference_mode()
    def forward_logprobs(self, input_ids, seg_ids, temperature: float = 1.0,
                         logits_mask=None) -> torch.Tensor:
        """Next-token log-probs [S, L] fp32 (0 at segment ends and pads)."""
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
        out = gen_mod.generate(
            self.cfg, self.params, self._tensor(prompt_ids),
            self._tensor(prompt_seg), self._tensor(prompt_pos), generator,
            gconfig, eos_token_id=eos_token_id, pad_token_id=pad_token_id)
        self.generate_stats.append(dict(out.stats))
        return out


def _leaves(tree):
    """Leaves in sorted-key order, whatever order the dicts were built
    in (the optimizer's state lists follow it)."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k])
        else:
            yield tree[k]


def _tree_map(fn, tree):
    return {k: (_tree_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}
