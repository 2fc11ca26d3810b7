"""GRPO: group-relative policy optimization (PPO without a critic).

Each prompt samples a group of responses; every response token's
advantage is the group-normalized reward (r - mean_group) /
(std_group + eps), clipped after normalization; the PPO clipped
surrogate is applied with a direct per-token KL penalty (the unbiased
k3 estimator) against the reference policy in place of KL-shaped
rewards. A group lives as several sequences inside one batch element
(nested seqlens), so the ids are the input's and the runner's data
merge is unchanged.
"""

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from realhf_tpu_torch.api import model as model_api
from realhf_tpu_torch.api.data import SequenceSample
from realhf_tpu_torch.interfaces import common, ppo_functional
from realhf_tpu_torch.interfaces.ppo import (
    PPOActorInterface,
    _mean_stats,
    _shifted_loss_mask,
)
from realhf_tpu_torch.ops import functional as F


def k3_kl(ref_logp: torch.Tensor, logp: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """Mean over the masked positions of exp(ref - pi) - (ref - pi) - 1,
    the unbiased non-negative estimate of KL(pi || ref)."""
    diff = ref_logp - logp
    return (torch.where(mask > 0, torch.exp(diff) - diff - 1.0, 0.0).sum()
            / mask.sum().clamp_min(1.0))


@dataclasses.dataclass
class GRPOInterface(PPOActorInterface):
    """The PPO actor's generate / inference plumbing with group
    sampling, group-relative advantages and the GRPO loss."""
    group_size: int = 4
    kl_coef: float = 0.05

    def __post_init__(self):
        super().__post_init__()
        if self.use_adaptive_kl_ctl or self.early_stop_kl is not None \
                or self.early_stop_imp_ratio is not None:
            raise ValueError(
                "GRPOInterface does not implement adaptive KL control or "
                "early stopping; unset use_adaptive_kl_ctl/early_stop_*.")
        warping = (not self.gconfig.greedy
                   and (self.gconfig.top_k > 0 or self.gconfig.top_p < 1.0))
        if warping and not self.gconfig.force_no_logits_mask:
            raise ValueError(
                "GRPO does not replay the sampling logits mask; either "
                "disable top-k/top-p or set force_no_logits_mask=True "
                "(accepting the warped-vs-raw logprob mismatch).")

    # ------------------------------------------------------------------
    def generate(self, model: model_api.Model, input_: SequenceSample,
                 n_mbs: Optional[int] = None) -> SequenceSample:
        """Sample ``group_size`` responses per prompt. The output keeps
        the input's ids, ``group_size`` sequences nested per element."""
        g = self.group_size
        reps = []
        for piece in input_.unpack():
            for j in range(g):
                reps.append(SequenceSample(
                    keys=piece.keys,
                    trailing_shapes=piece.trailing_shapes,
                    dtypes=piece.dtypes,
                    ids=[f"{piece.ids[0]}#g{j}"],
                    seqlens=piece.seqlens,
                    data=piece.data,
                    metadata={}))
        flat = super().generate(model, SequenceSample.gather(reps),
                                n_mbs=n_mbs)

        # regroup: bs * g one-sequence elements -> bs elements of g
        def nest(key):
            per = flat.seqlens[key]
            return [sum((per[i * g + j] for j in range(g)), [])
                    for i in range(input_.bs)]

        with SequenceSample.disable_validation():
            return SequenceSample(
                keys=flat.keys, trailing_shapes=flat.trailing_shapes,
                dtypes=flat.dtypes, ids=list(input_.ids),
                seqlens={k: nest(k) for k in flat.keys}, data=flat.data,
                metadata={})

    # ------------------------------------------------------------------
    def _advantages(self, input_: SequenceSample, rewards: np.ndarray,
                    seqlens, loss_mask: np.ndarray) -> np.ndarray:
        """Group-relative advantages over the shifted (l - 1) slots:
        unbiased group std, clipping after normalization."""
        g = self.group_size
        grp = rewards.reshape(-1, g)
        lens_m1 = np.asarray(seqlens) - 1
        dense = None
        if self.turn_level_credit and "dense_rewards" in input_.keys \
                and input_.data.get("dense_rewards") is not None:
            dense = np.asarray(input_.data["dense_rewards"], np.float32)
        if dense is not None:
            # turn-level credit: the discounted reward-to-go of the turn
            # rewards, centred and scaled by the group's total-reward
            # statistics (at the first slot the sequence-level form)
            rtg = np.zeros_like(dense)
            off = 0
            for l in lens_m1:
                acc = 0.0
                for t in range(l - 1, -1, -1):
                    acc = float(dense[off + t]) + self.discount * acc
                    rtg[off + t] = acc
                off += l
            mean_seq = np.repeat(np.repeat(grp.mean(axis=1), g), lens_m1)
            std_seq = np.repeat(np.repeat(grp.std(axis=1, ddof=1), g),
                                lens_m1)
            advantages = ((rtg - mean_seq) / (std_seq + 1e-5)) \
                .astype(np.float32)
            advantages = np.clip(advantages, -self.max_reward_clip,
                                 self.max_reward_clip)
        else:
            adv_seq = ((grp - grp.mean(axis=1, keepdims=True))
                       / (grp.std(axis=1, ddof=1, keepdims=True)
                          + 1e-5)).reshape(-1)
            adv_seq = np.clip(adv_seq, -self.max_reward_clip,
                              self.max_reward_clip)
            advantages = np.repeat(adv_seq, lens_m1).astype(np.float32)
            if self.discount != 1.0:
                # the terminal advantage spread backwards with
                # discount^(T-1-t) decay
                decay = np.concatenate([
                    self.discount ** np.arange(l - 1, -1, -1,
                                               dtype=np.float32)
                    for l in lens_m1])
                advantages = advantages * decay
        advantages = advantages * loss_mask
        if self.adv_norm:
            m = loss_mask.astype(np.float64)
            mean = (advantages * m).sum() / max(m.sum(), 1)
            var = ((advantages - mean) ** 2 * m).sum() / max(m.sum(), 1)
            advantages = ((advantages - mean) /
                          np.sqrt(var + 1e-5)).astype(np.float32) * loss_mask
        return advantages

    def train_step(self, model: model_api.Model, input_: SequenceSample,
                   n_mbs: Optional[int] = None) -> Dict:
        seqlens = common.flat_seqlens(input_)
        n_seqs = len(seqlens)
        assert n_seqs % self.group_size == 0, (n_seqs, self.group_size)

        old_logp = np.asarray(input_.data["packed_logprobs"], np.float32)
        ref_logp = np.asarray(input_.data["packed_ref_logprobs"], np.float32)
        prompt_mask = np.asarray(input_.data["prompt_mask"], bool)
        rewards = np.asarray(input_.data["rewards"], np.float32)

        loss_mask = _shifted_loss_mask(prompt_mask, seqlens)
        old_logp = old_logp * loss_mask
        ref_logp = ref_logp * loss_mask
        advantages = self._advantages(input_, rewards, seqlens, loss_mask)

        n_tokens = max(int(loss_mask.sum()), 1)
        global_stats = dict(
            task_reward=float(rewards.mean()),
            advantage=float(advantages.sum() / n_tokens),
            avg_seq_len=float(np.mean(seqlens)),
            n_seqs=n_seqs)

        keys = ("packed_input_ids", "advantages", "old_logp", "ref_logp",
                "ppo_loss_mask")
        nested = input_.seqlens["packed_input_ids"]
        nested_m1 = [[l - 1 for l in lens] for lens in nested]
        with SequenceSample.disable_validation():
            sample = SequenceSample(
                keys=keys,
                trailing_shapes={k: () for k in keys},
                dtypes=dict(packed_input_ids=np.int32,
                            advantages=np.float32, old_logp=np.float32,
                            ref_logp=np.float32, ppo_loss_mask=np.bool_),
                ids=list(input_.ids),
                seqlens=dict(packed_input_ids=nested,
                             advantages=nested_m1, old_logp=nested_m1,
                             ref_logp=nested_m1, ppo_loss_mask=nested_m1),
                data=dict(
                    packed_input_ids=input_.data["packed_input_ids"],
                    advantages=advantages, old_logp=old_logp,
                    ref_logp=ref_logp, ppo_loss_mask=loss_mask),
                metadata={})

        cfg = model.config
        temperature = self.gconfig.temperature
        eps_clip = self.eps_clip
        kl_coef = self.kl_coef

        def loss_fn(params, mb):
            h, aux = common.forward_with_aux(cfg, params, mb["input_ids"],
                                             mb["seg_ids"])
            lp = F.shifted_logprobs_from_hidden(
                cfg, params, h, mb["input_ids"], mb["seg_ids"],
                temperature=temperature)
            loss, stats = ppo_functional.actor_loss_fn(
                logprobs=lp, old_logprobs=mb["old_logp"],
                advantages=mb["advantages"], eps_clip=eps_clip,
                loss_mask=mb["loss_mask"] > 0)
            kl = k3_kl(mb["ref_logp"], lp, mb["loss_mask"])
            return loss + kl_coef * kl + sum(aux.values()), dict(
                grpo_loss=loss.detach(), grpo_kl=kl.detach(),
                importance_weight=stats["importance_weight"],
                clip_ratio=stats["clip_ratio"], **aux)

        def build_sb(minibatch):
            return common.build_stream_batch(
                common.flat_seqlens(minibatch),
                n_streams=model.engine.n_streams,
                token_keys=dict(
                    input_ids=minibatch.data["packed_input_ids"]),
                shifted_keys=dict(
                    advantages=minibatch.data["advantages"],
                    old_logp=minibatch.data["old_logp"],
                    ref_logp=minibatch.data["ref_logp"],
                    loss_mask=minibatch.data["ppo_loss_mask"]
                    .astype(np.float32)))

        all_stats = common.run_train_minibatches(
            model.engine,
            common.split_minibatches(sample, self.n_minibatches),
            build_sb, loss_fn, "grpo", n_mbs)
        model.inc_version()
        agg = _mean_stats(all_stats)
        agg.update(global_stats)
        return agg


model_api.register_interface("grpo", GRPOInterface)
