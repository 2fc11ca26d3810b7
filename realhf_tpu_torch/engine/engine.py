"""The per-model execution engine, inference-only in this slice.

One ``Engine`` holds one model's parameters on one device and exposes
the inference forward and batch generation. It holds no optimizer:
training (``train_batch``) comes with the training slice of the port.
"""

from typing import Any, Optional

import numpy as np
import torch

from realhf_tpu_torch.base.device import DeviceLike, resolve_device
from realhf_tpu_torch.engine import generation as gen_mod
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.models.convert import params_from_numpy, params_numpy
from realhf_tpu_torch.ops.sampling import GenerationHyperparameters


class Engine:

    def __init__(self, cfg: TransformerConfig, params: Any,
                 device: DeviceLike = None):
        T.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = None
        self.set_params(params)
        #: stats of each generate call (decode steps, tokens, seconds)
        self.generate_stats = []

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
        """Install new weights (a tensor or numpy tree)."""
        self.params = self._cast_param_dtype(params)

    def params_numpy(self):
        """Host numpy copy with the JAX package's paths and shapes."""
        return params_numpy(self.params)

    def _tensor(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    @torch.inference_mode()
    def forward_hidden(self, input_ids, seg_ids) -> torch.Tensor:
        h, _ = T.forward(self.cfg, self.params, self._tensor(input_ids),
                         self._tensor(seg_ids))
        return h

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
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _tree_map(fn, tree):
    return {k: (_tree_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}
