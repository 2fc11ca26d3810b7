"""Token sampling: temperature, top-k, top-p, greedy, logits mask.

Randomness comes from an explicit ``torch.Generator``. The logits mask
marks the tokens that were sample-able after warping; PPO's inference
pass replays it.
"""

import dataclasses
from typing import Tuple

import torch

# Masked logits. Not the attention sentinel (-2**30): this one must stay
# far below any real logit after temperature scaling.
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class GenerationHyperparameters:
    max_new_tokens: int = 256
    min_new_tokens: int = 0
    greedy: bool = False
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    temperature: float = 1.0
    # Whether generate() skips the per-step logits mask.
    force_no_logits_mask: bool = False

    def __post_init__(self):
        if not self.greedy and self.temperature <= 0.0:
            raise ValueError(
                "temperature must be > 0 for sampling; use greedy=True "
                "for deterministic decoding.")


def top_k_top_p_logits(logits: torch.Tensor, top_k: int = 0,
                       top_p: float = 1.0) -> torch.Tensor:
    """Mask logits outside the top-k / top-p nucleus to NEG_INF.

    The nucleus is taken over the FULL softmax distribution and then
    intersected with the top-k set. With top-k active only a top-k
    selection runs; the probabilities of the k survivors use the
    full-vocabulary log-sum-exp, so their prefix-mass cutoff is exactly
    the full-vocabulary top-p one (clamped to k by the intersection).
    """
    v = logits.shape[-1]
    if (top_k <= 0 or top_k >= v) and top_p >= 1.0:
        return logits
    if 0 < top_k < v:
        topv = torch.topk(logits, top_k, dim=-1).values  # descending
        if top_p < 1.0:
            probs = torch.exp(
                topv - torch.logsumexp(logits, dim=-1, keepdim=True))
            cum = probs.cumsum(-1)
            include = (cum - probs) < top_p
            cutoff_idx = include.sum(-1) - 1
            cutoff = topv.gather(-1, cutoff_idx[..., None])
        else:
            cutoff = topv[..., top_k - 1:top_k]
        return torch.where(logits >= cutoff, logits, NEG_INF)
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = probs.cumsum(-1)
    include = (cum - probs) < top_p
    cutoff_idx = include.sum(-1) - 1
    cutoff = sorted_logits.gather(-1, cutoff_idx[..., None])
    return torch.where(logits >= cutoff, logits, NEG_INF)


def categorical(logits: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits) (masked entries have
    probability 0)."""
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sample_from_logits(logits: torch.Tensor, generator: torch.Generator,
                       gconfig: GenerationHyperparameters
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sampling step -> (tokens [B] int32, logits_mask [B, V] bool)."""
    if gconfig.greedy:
        tokens = logits.argmax(-1)
        return tokens.to(torch.int32), torch.ones_like(logits,
                                                      dtype=torch.bool)
    warped = top_k_top_p_logits(logits / gconfig.temperature,
                                gconfig.top_k, gconfig.top_p)
    tokens = categorical(warped, generator)
    return tokens.to(torch.int32), warped > NEG_INF / 2
