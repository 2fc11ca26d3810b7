"""REINFORCE with a greedy baseline (ReMax): policy gradient without a
critic.

Each prompt samples one response and decodes one greedy response; the
greedy response's reward is the baseline, so the per-prompt advantage
is ``r_sampled - r_greedy`` over the sampled response's tokens, and the
loss is plain REINFORCE ``-adv * logpi`` (no clipping, no critic, no
GAE), with an optional k3 KL penalty against the reference policy. Both
responses live as two nested sequences of one batch element (sampled
first, greedy second), so the ids are the input's, as in GRPO.
"""

import copy
import dataclasses
from typing import Dict, Optional

import numpy as np

from realhf_tpu_torch.api import model as model_api
from realhf_tpu_torch.api.data import SequenceSample
from realhf_tpu_torch.interfaces import common
from realhf_tpu_torch.interfaces.grpo import k3_kl
from realhf_tpu_torch.interfaces.ppo import (
    PPOActorInterface,
    _mean_stats,
    _shifted_loss_mask,
)
from realhf_tpu_torch.ops import functional as F


@dataclasses.dataclass
class ReinforceInterface(PPOActorInterface):
    """The PPO actor's generate / inference plumbing with paired
    sampled + greedy decoding and the REINFORCE loss."""
    kl_coef: float = 0.0  # optional k3 penalty against the reference

    def __post_init__(self):
        super().__post_init__()
        if self.gconfig.greedy:
            raise ValueError(
                "ReinforceInterface needs a SAMPLED rollout; the greedy "
                "baseline decode is issued internally.")
        if not self.gconfig.force_no_logits_mask:
            # the greedy baseline has no logits mask, so the sampled
            # half's mask cannot ride the interleaved layout
            raise ValueError(
                "ReinforceInterface does not replay the sampling "
                "logits mask; set force_no_logits_mask=True (and "
                "disable top-k/top-p if exact logprob consistency "
                "matters).")

    # ------------------------------------------------------------------
    def generate(self, model: model_api.Model, input_: SequenceSample,
                 n_mbs: Optional[int] = None) -> SequenceSample:
        sampled = super().generate(model, input_, n_mbs=n_mbs)
        # a shallow copy with a greedy gconfig (dataclasses.replace on
        # the interface would rerun __post_init__, which refuses greedy)
        greedy_itf = copy.copy(self)
        greedy_itf.gconfig = dataclasses.replace(
            self.gconfig, greedy=True, force_no_logits_mask=True)
        greedy = PPOActorInterface.generate(greedy_itf, model, input_,
                                            n_mbs=n_mbs)

        # interleave: element i holds [sampled_i, greedy_i]
        keys = [k for k in sampled.keys if k in greedy.keys]
        s_parts = sampled.select(keys).unpack()
        g_parts = greedy.select(keys).unpack()
        data = {k: np.concatenate([
            np.concatenate([np.atleast_1d(s.data[k]),
                            np.atleast_1d(g.data[k])])
            for s, g in zip(s_parts, g_parts)]) for k in keys}
        with SequenceSample.disable_validation():
            return SequenceSample(
                keys=keys,
                trailing_shapes={k: sampled.trailing_shapes[k]
                                 for k in keys},
                dtypes={k: sampled.dtypes[k] for k in keys},
                ids=list(input_.ids),
                seqlens={k: [s.seqlens[k][0] + g.seqlens[k][0]
                             for s, g in zip(s_parts, g_parts)]
                         for k in keys},
                data=data,
                metadata={})

    # ------------------------------------------------------------------
    def train_step(self, model: model_api.Model, input_: SequenceSample,
                   n_mbs: Optional[int] = None) -> Dict:
        seqlens = common.flat_seqlens(input_)
        n_seqs = len(seqlens)
        assert n_seqs % 2 == 0, "sampled+greedy pairs expected"

        prompt_mask = np.asarray(input_.data["prompt_mask"], bool)
        rewards = np.asarray(input_.data["rewards"], np.float32)
        has_ref = "packed_ref_logprobs" in input_.keys and self.kl_coef > 0

        # ReMax advantage r_sampled - r_greedy per pair; the greedy
        # sequences only serve as the baseline and carry no gradient
        pairs = rewards.reshape(-1, 2)
        adv_seq = np.zeros_like(rewards)
        adv_seq[0::2] = np.clip(pairs[:, 0] - pairs[:, 1],
                                -self.max_reward_clip, self.max_reward_clip)

        loss_mask = _shifted_loss_mask(prompt_mask, seqlens)
        lens_m1 = np.asarray(seqlens) - 1
        advantages = np.repeat(adv_seq, lens_m1).astype(np.float32)
        loss_mask = loss_mask & np.repeat(
            np.tile([True, False], n_seqs // 2), lens_m1)
        advantages = advantages * loss_mask

        global_stats = dict(
            task_reward=float(pairs[:, 0].mean()),
            greedy_reward=float(pairs[:, 1].mean()),
            advantage=float(adv_seq[0::2].mean()),
            n_seqs=n_seqs)

        data = dict(packed_input_ids=input_.data["packed_input_ids"],
                    advantages=advantages, ppo_loss_mask=loss_mask)
        if has_ref:
            data["ref_logp"] = np.asarray(
                input_.data["packed_ref_logprobs"], np.float32)
        nested = input_.seqlens["packed_input_ids"]
        nested_m1 = [[l - 1 for l in lens] for lens in nested]
        with SequenceSample.disable_validation():
            sample = SequenceSample(
                keys=list(data),
                trailing_shapes={k: () for k in data},
                dtypes={k: v.dtype for k, v in data.items()},
                ids=list(input_.ids),
                seqlens={k: (nested if k == "packed_input_ids"
                             else nested_m1) for k in data},
                data=data,
                metadata={})

        cfg = model.config
        temperature = self.gconfig.temperature
        kl_coef = self.kl_coef

        def loss_fn(params, mb):
            h, aux = common.forward_with_aux(cfg, params, mb["input_ids"],
                                             mb["seg_ids"])
            lp = F.shifted_logprobs_from_hidden(
                cfg, params, h, mb["input_ids"], mb["seg_ids"],
                temperature=temperature)
            m = mb["loss_mask"]
            pg = -(mb["advantages"] * lp * m).sum() / m.sum().clamp_min(1.0)
            total = pg + sum(aux.values())
            stats = dict(reinforce_loss=pg.detach(), **aux)
            if has_ref:
                kl = k3_kl(mb["ref_logp"], lp, m)
                total = total + kl_coef * kl
                stats["ref_kl"] = kl.detach()
            return total, stats

        def build_sb(minibatch):
            shifted = dict(
                advantages=minibatch.data["advantages"],
                loss_mask=minibatch.data["ppo_loss_mask"]
                .astype(np.float32))
            if has_ref:
                shifted["ref_logp"] = minibatch.data["ref_logp"]
            return common.build_stream_batch(
                common.flat_seqlens(minibatch),
                n_streams=model.engine.n_streams,
                token_keys=dict(
                    input_ids=minibatch.data["packed_input_ids"]),
                shifted_keys=shifted)

        all_stats = common.run_train_minibatches(
            model.engine,
            common.split_minibatches(sample, self.n_minibatches),
            build_sb, loss_fn, "reinforce", n_mbs)
        model.inc_version()
        agg = _mean_stats(all_stats)
        agg.update(global_stats)
        return agg


model_api.register_interface("reinforce", ReinforceInterface)
