"""PPO math: KL controllers, losses, rewards, value normalization.

The losses are plain functions on ``[S, L]`` stream tensors with a
boolean loss mask; reward preparation and the running statistics run on
the host over flat packed numpy arrays (float64 statistics).
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch


# ----------------------------------------------------------------------
# KL controllers (host-side state)
# ----------------------------------------------------------------------
class KLController:
    value: float

    def update(self, current: float, n_steps: int):
        raise NotImplementedError()


class FixedKLController(KLController):

    def __init__(self, kl_coef: float):
        self.value = kl_coef

    def update(self, current, n_steps):
        pass


class AdaptiveKLController(KLController):
    """The adaptive controller of arXiv 1909.08593."""

    def __init__(self, init_kl_coef: float, target: float, horizon: float):
        self.value = init_kl_coef
        self.target = target
        self.horizon = horizon

    def update(self, current, n_steps):
        proportional_error = float(np.clip(current / self.target - 1,
                                           -0.2, 0.2))
        self.value = self.value * (1 + proportional_error * n_steps /
                                   self.horizon)


# ----------------------------------------------------------------------
# Losses ([S, L] tensors with a boolean loss mask)
# ----------------------------------------------------------------------
def actor_loss_fn(logprobs: torch.Tensor, old_logprobs: torch.Tensor,
                  advantages: torch.Tensor, eps_clip: float,
                  loss_mask: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped PPO surrogate, averaged over the masked positions."""
    m = loss_mask.to(torch.float32)
    denom = m.sum().clamp_min(1.0)
    ratio = torch.where(loss_mask, torch.exp(logprobs - old_logprobs), 0.0)
    clipped = ratio.clamp(1.0 - eps_clip, 1.0 + eps_clip)
    pg1 = -advantages * ratio
    pg2 = -advantages * clipped
    loss = torch.where(loss_mask, torch.maximum(pg1, pg2), 0.0).sum() / denom
    with torch.no_grad():
        clip_mask = pg1 < pg2
        stats = {
            "importance_weight": (ratio * m).sum() / denom,
            "clip_ratio": (clip_mask & loss_mask).sum() / denom,
            "approx_kl": ((logprobs - old_logprobs) * m).sum() / denom,
        }
    return loss, stats


def critic_loss_fn(value: torch.Tensor, old_value: torch.Tensor,
                   target_value: torch.Tensor, value_eps_clip: float,
                   loss_mask: torch.Tensor, loss_fn_type: str = "mse"
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Value loss with clipping around the old value."""
    if loss_fn_type == "mse":
        def f(x, y):
            return 0.5 * (x - y) ** 2
    elif loss_fn_type == "huber":
        delta = 10.0

        def f(x, y):
            d = (x - y).abs()
            return torch.where(d < delta, 0.5 * (x - y) ** 2,
                               delta * (d - 0.5 * delta))
    else:
        raise NotImplementedError(loss_fn_type)
    m = loss_mask.to(torch.float32)
    denom = m.sum().clamp_min(1.0)
    orig = f(value, target_value)
    value_clipped = old_value + (value - old_value).clamp(-value_eps_clip,
                                                          value_eps_clip)
    clip = f(value_clipped, target_value)
    loss = torch.where(loss_mask, torch.maximum(orig, clip), 0.0).sum() / denom
    with torch.no_grad():
        clip_mask = clip > orig
        stats = {"value_clip_ratio": (clip_mask & loss_mask).sum() / denom}
    return loss, stats


# ----------------------------------------------------------------------
# Rewards over flat packed arrays (host-side numpy)
# ----------------------------------------------------------------------
def get_packed_rewards(
    kl_ctl: float,
    clip_reward_value: float,
    log_probs: np.ndarray,      # flat, per-seq length l-1
    ref_log_probs: np.ndarray,
    reward_score: np.ndarray,   # [n_seqs]
    short1cu_seqlens: np.ndarray,  # [n_seqs+1] boundaries of the l-1 arrays
    seq_no_eos_mask: np.ndarray,   # [n_seqs] bool
) -> Tuple[np.ndarray, np.ndarray]:
    """KL penalty per token, plus the clipped score at the last reward
    slot of each sequence that ended in EOS. Returns (kl_rewards,
    total rewards)."""
    kl_rewards = -kl_ctl * (log_probs - ref_log_probs)
    tot = kl_rewards.copy()
    score = np.clip(reward_score, -clip_reward_value, clip_reward_value)
    ends = short1cu_seqlens[1:] - 1
    tot[ends] += np.where(seq_no_eos_mask, 0.0, score)
    return kl_rewards, tot


def get_packed_dense_rewards(
    kl_ctl: float,
    clip_reward_value: float,
    log_probs: np.ndarray,       # flat, per-seq length l-1
    ref_log_probs: np.ndarray,
    dense_rewards: np.ndarray,   # flat l-1: reward at turn boundaries
) -> Tuple[np.ndarray, np.ndarray]:
    """Turn-level variant for multi-turn trajectories: ``dense_rewards``
    already places each turn's reward at that turn's last action token's
    prediction slot, so the total is the KL penalty plus the clipped
    dense rewards. Environment rewards are granted however the sequence
    ended, so no ``seq_no_eos_mask`` gating applies (truncation only
    zeroes the bootstrap value, in GAE)."""
    kl_rewards = -kl_ctl * (log_probs - ref_log_probs)
    tot = kl_rewards + np.clip(dense_rewards, -clip_reward_value,
                               clip_reward_value)
    return kl_rewards, tot


# ----------------------------------------------------------------------
# Running mean and std (value normalization), float64 on the host
# ----------------------------------------------------------------------
class _RunningMeanStd:

    def mean_std(self) -> Tuple[float, float]:
        raise NotImplementedError()

    def normalize(self, x: np.ndarray) -> np.ndarray:
        mean, std = self.mean_std()
        return ((np.asarray(x, np.float64) - mean) / std).astype(np.float32)

    def denormalize(self, x: np.ndarray) -> np.ndarray:
        mean, std = self.mean_std()
        return (np.asarray(x, np.float64) * std + mean).astype(np.float32)


class ExponentialRunningMeanStd(_RunningMeanStd):

    def __init__(self, beta: float = 0.999, epsilon: float = 1e-5):
        self.beta = beta
        self.eps = epsilon
        self._mean = 0.0
        self._mean_sq = 0.0
        self._debias = 0.0

    def update(self, x: np.ndarray, mask: Optional[np.ndarray] = None):
        x = np.asarray(x, np.float64)
        if mask is not None:
            mask = np.asarray(mask, np.float64)
            factor = max(mask.sum(), 1.0)
            mean = (x * mask).sum() / factor
            mean_sq = (x ** 2 * mask).sum() / factor
        else:
            mean = x.mean()
            mean_sq = (x ** 2).mean()
        self._mean = self.beta * self._mean + (1 - self.beta) * mean
        self._mean_sq = self.beta * self._mean_sq + (1 - self.beta) * mean_sq
        self._debias = self.beta * self._debias + (1 - self.beta)

    def mean_std(self) -> Tuple[float, float]:
        if self._debias == 0:
            return 0.0, 1.0
        mean = self._mean / self._debias
        var = max(self._mean_sq / self._debias - mean ** 2, 0.0)
        return mean, float(np.sqrt(var + self.eps))


class MovingAverageRunningMeanStd(_RunningMeanStd):

    def __init__(self, epsilon: float = 1e-5):
        self.eps = epsilon
        self._sum = 0.0
        self._sum_sq = 0.0
        self._count = 0.0

    def update(self, x: np.ndarray, mask: Optional[np.ndarray] = None):
        x = np.asarray(x, np.float64)
        if mask is not None:
            mask = np.asarray(mask, np.float64)
            self._sum += (x * mask).sum()
            self._sum_sq += (x ** 2 * mask).sum()
            self._count += mask.sum()
        else:
            self._sum += x.sum()
            self._sum_sq += (x ** 2).sum()
            self._count += x.size

    def mean_std(self) -> Tuple[float, float]:
        if self._count == 0:
            return 0.0, 1.0
        mean = self._sum / self._count
        var = max(self._sum_sq / self._count - mean ** 2, 0.0)
        return mean, float(np.sqrt(var + self.eps))
