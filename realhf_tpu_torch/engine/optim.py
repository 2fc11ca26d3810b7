"""AdamW with optax's numerics, its learning-rate schedules, and fp32
master weights.

The JAX package builds ``optax.chain(clip_by_global_norm(clip),
adamw(schedule, b1, b2, eps, weight_decay, mask=ndim >= 2))``, wrapped
in ``with_master_weights`` when the params are not fp32. This module is
that update written out over a list of tensors, not
``torch.optim.AdamW``, whose decay and schedule conventions differ:

- the schedule is read at the step count before it is incremented, so
  the first step of a warmup uses lr 0;
- clipping scales g by max / |g| only when |g| >= max;
- u = m_hat / (sqrt(v_hat) + eps), then ``+ wd * p`` where the mask
  allows, then ``* -lr``;
- the decay mask is ``p.ndim >= 2`` on the stacked parameter tree, so
  the ``[n_layers, H]`` norm scales are decayed and the final norm's
  ``[H]`` scale is not.

Params, master copies and moments are updated in place (the JAX package
returns new arrays that XLA aliases in place). With
``OptimizerConfig.offload`` the engine keeps the state in pinned host
memory between train calls (``AdamW.offload`` / ``ensure_on_device``).
"""

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from realhf_tpu_torch.base.safetensors_io import numpy_to_tensor
from realhf_tpu_torch.engine import offload


@dataclasses.dataclass
class OptimizerConfig:
    """The JAX package's optimizer settings, same defaults (type "empty"
    means no optimizer: an inference-only model)."""
    type: str = "adam"  # adam | empty
    lr: float = 1e-5
    weight_decay: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-5
    min_lr_ratio: float = 0.0
    lr_scheduler_type: str = "cosine"  # linear | cosine | constant
    warmup_steps_proportion: float = 0.02
    gradient_clipping: float = 1.0
    #: keep the optimizer state (master weights and moments) in pinned
    #: host memory between train calls, on the device only during them
    offload: bool = False
    #: shard the optimizer state over data-parallel ranks (ZeRO-1):
    #: raises until the parallelism slice of the port
    zero1: bool = False


def lr_schedule(cfg: OptimizerConfig, total_steps: int
                ) -> Callable[[int], float]:
    """step count -> lr: a linear warmup from 0 over
    ``int(warmup_steps_proportion * total_steps)`` steps (none when that
    is 0) joined to a constant, linear or cosine decay (optax's
    ``join_schedules`` of ``linear_schedule`` and the decay)."""
    warmup = int(cfg.warmup_steps_proportion * total_steps)
    decay_steps = max(1, total_steps - warmup)
    end = cfg.lr * cfg.min_lr_ratio
    kind = cfg.lr_scheduler_type
    if kind not in ("constant", "linear", "cosine"):
        raise NotImplementedError(kind)

    def decay(step: int) -> float:
        frac = min(max(step, 0), decay_steps) / decay_steps
        if kind == "constant":
            return cfg.lr
        if kind == "linear":
            return cfg.lr + (end - cfg.lr) * frac
        cos = 0.5 * (1 + math.cos(math.pi * frac))
        return cfg.lr * ((1 - cfg.min_lr_ratio) * cos + cfg.min_lr_ratio)

    def schedule(step: int) -> float:
        if warmup <= 0:
            return decay(step)
        if step < warmup:
            return cfg.lr * step / warmup
        return decay(step - warmup)

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32 (optax's
    ``global_norm``)."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


class AdamW:
    """The update of the JAX package's ``make_optimizer`` over a flat
    list of parameter tensors; non-fp32 params train against fp32
    master copies held here (``with_master_weights``) and receive
    ``round(new_master)`` after each step."""

    def __init__(self, cfg: OptimizerConfig, params: List[torch.Tensor],
                 total_steps: Optional[int] = None):
        if cfg.type != "adam":
            raise NotImplementedError(f"Optimizer type {cfg.type}")
        self.cfg = cfg
        self.schedule = lr_schedule(cfg, total_steps or 10 ** 9)
        #: optimizer steps taken (optax's ``count``)
        self.count = 0
        self.master = [p.detach().float().clone()
                       if p.dtype != torch.float32 else None for p in params]
        self.m = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.v = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.decay = [p.ndim >= 2 for p in params]
        self.device = params[0].device
        #: the state waits on the host (``offload``) until the next step
        self.offloaded = False
        self._host = None  # pinned buffers, made at the first offload

    def _state(self) -> List[torch.Tensor]:
        return [w for w in self.master if w is not None] + self.m + self.v

    def _set_state(self, tensors: List[torch.Tensor]):
        it = iter(tensors)
        self.master = [None if w is None else next(it) for w in self.master]
        self.m = [next(it) for _ in self.m]
        self.v = [next(it) for _ in self.v]

    def state_leaves(self) -> List[Union[int, torch.Tensor]]:
        """The state in the JAX package's leaf order (``jax.tree.leaves``
        of ``make_optimizer``'s state): the fp32 master copies (non-fp32
        params only), adam's step count, the first moments, the second
        moments, the schedule's step count. The counts are ints; the
        tensors are wherever the state is (pinned host memory while
        offloaded)."""
        return ([w for w in self.master if w is not None] + [self.count]
                + self.m + self.v + [self.count])

    def state_spec(self) -> List[Tuple[tuple, np.dtype]]:
        """(shape, numpy dtype) of each of ``state_leaves``."""
        return [((), np.dtype(np.int32)) if isinstance(x, int)
                else (tuple(x.shape), np.dtype(np.float32))
                for x in self.state_leaves()]

    def load_state_leaves(self, leaves: Sequence[np.ndarray]):
        """Install host leaves in ``state_leaves`` order (shapes already
        checked) into the state's tensors, in place."""
        n_master = sum(w is not None for w in self.master)
        k = len(self.m)
        counts = {int(leaves[n_master]), int(leaves[n_master + 1 + 2 * k])}
        if len(counts) != 1:
            raise ValueError(
                f"adam and schedule step counts differ: {sorted(counts)}")
        tensors = [w for w in self.master if w is not None] + self.m + self.v
        values = (list(leaves[:n_master])
                  + list(leaves[n_master + 1:n_master + 1 + 2 * k]))
        for dst, src in zip(tensors, values):
            dst.copy_(numpy_to_tensor(src, copy=False))
        self.count = counts.pop()

    def offload(self):
        """Move master weights and moments to pinned host memory and
        free their device memory (on a CPU engine only the flag moves)."""
        if self.offloaded:
            return
        if self.device.type == "cuda":
            self._host = offload.to_pinned_host(self._state(), self._host)
            self._set_state(self._host)
        self.offloaded = True

    def ensure_on_device(self):
        """Bring offloaded state back before a step."""
        if not self.offloaded:
            return
        if self.device.type == "cuda":
            self._set_state(offload.to_device(self._host, self.device))
        self.offloaded = False

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor]):
        """One update from the fp32 ``grads`` (clipped here, in place);
        offloaded state comes back to the device first."""
        cfg = self.cfg
        self.ensure_on_device()
        if cfg.gradient_clipping and cfg.gradient_clipping > 0:
            gnorm = global_norm(grads)
            if gnorm >= cfg.gradient_clipping:
                for g in grads:
                    g.div_(gnorm).mul_(cfg.gradient_clipping)
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = cfg.beta1, cfg.beta2
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for i, (p, g) in enumerate(zip(params, grads)):
            w = self.master[i] if self.master[i] is not None else p
            m, v = self.m[i], self.v[i]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * (g * g))
            u = (m / c1) / ((v / c2).sqrt_() + cfg.eps)
            if self.decay[i]:
                u.add_(cfg.weight_decay * w)
            w.add_(u.mul_(-lr))
            if self.master[i] is not None:
                p.copy_(w)  # round to the param dtype
