"""Paired reward modeling interface (Bradley-Terry).

Each batch element packs interleaved (pos, neg) full sequences; the
score is the critic head's value at each sequence's final token; the
loss is -log sigmoid(score_pos - score_neg) averaged over pairs. The
``inference`` handler scores sequences for PPO's ``rew_inf`` MFC.
"""

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from realhf_tpu_torch.api import model as model_api
from realhf_tpu_torch.api.data import SequenceSample
from realhf_tpu_torch.engine import packing
from realhf_tpu_torch.interfaces import common
from realhf_tpu_torch.models import transformer as T


def _make_loss_fn(cfg):

    def loss_fn(params, mb):
        h, aux = common.forward_with_aux(cfg, params, mb["input_ids"],
                                         mb["seg_ids"])
        values = T.critic_values(cfg, params, h)  # [S, L]
        # per-pair (pos, neg) end-of-sequence scores by (row, col)
        # coordinates, which stream padding does not move; ``pair_valid``
        # (all ones) counts the pairs and weights the microbatch
        pos = values[mb["pos_row"].long(), mb["pos_col"].long()]
        neg = values[mb["neg_row"].long(), mb["neg_col"].long()]
        valid = mb["pair_valid"]
        denom = valid.sum().clamp_min(1)
        losses = -torch.nn.functional.logsigmoid(pos - neg)
        loss = (losses * valid).sum() / denom
        with torch.no_grad():
            stats = {
                "loss": loss,
                "acc": ((pos > neg) & (valid > 0)).sum() / denom,
                "pos_score": (pos * valid).sum() / denom,
                "neg_score": (neg * valid).sum() / denom,
                **aux,
            }
        return loss + sum(aux.values()), stats

    return loss_fn


@dataclasses.dataclass
class PairedRewardInterface(model_api.ModelInterface):
    #: False: ``save`` writes nothing
    enable_save: bool = True
    output_scaling: float = 1.0
    output_bias: float = 0.0

    def _score_batch(self, model, input_: SequenceSample) -> np.ndarray:
        """Value at the final token of every sequence (flattened)."""
        seqlens = common.flat_seqlens(input_)
        sb = common.build_stream_batch(
            seqlens,
            n_streams=model.engine.n_streams,
            token_keys=dict(input_ids=input_.data["packed_input_ids"]))
        values = model.engine.forward_values(
            sb.arrays["input_ids"], sb.arrays["seg_ids"]).cpu().numpy()
        scores = packing.per_seq_gather(
            sb.info, values, [l - 1 for l in seqlens])
        return (scores - self.output_bias) * self.output_scaling

    def inference(self, model: model_api.Model, input_: SequenceSample,
                  n_mbs: Optional[int] = None) -> SequenceSample:
        scores = self._score_batch(model, input_)
        # one score per sequence: an element holding several sequences
        # (paired data) keeps its scores side by side
        n_per_elem = [len(l) for l in input_.seqlens["packed_input_ids"]]
        if sum(n_per_elem) != len(scores):
            raise ValueError(f"{len(scores)} scores for {n_per_elem}")
        return SequenceSample(
            keys=["rewards"],
            trailing_shapes=dict(rewards=()),
            dtypes=dict(rewards=np.float32),
            ids=input_.ids,
            seqlens=dict(rewards=[[1] * n for n in n_per_elem]),
            data=dict(rewards=scores.astype(np.float32)),
        )

    def train_step(self, model: model_api.Model, input_: SequenceSample,
                   n_mbs: Optional[int] = None) -> Dict:

        def build_sb(mb):
            seqlens = common.flat_seqlens(mb)
            sb = common.build_stream_batch(
                seqlens,
                n_streams=model.engine.n_streams,
                token_keys=dict(input_ids=mb.data["packed_input_ids"]))
            # (row, col) of each sequence's final token
            ends = [(sb.info.stream[i], sb.info.offset[i] + ln - 1)
                    for i, ln in enumerate(seqlens)]
            pos, neg, si = [], [], 0
            for lens in mb.seqlens["packed_input_ids"]:
                for p in range(len(lens) // 2):
                    pos.append(ends[si + 2 * p])
                    neg.append(ends[si + 2 * p + 1])
                si += len(lens)
            pos = np.asarray(pos, np.int32).reshape(-1, 2)
            neg = np.asarray(neg, np.int32).reshape(-1, 2)
            sb.arrays.update(pos_row=pos[:, 0], pos_col=pos[:, 1],
                             neg_row=neg[:, 0], neg_col=neg[:, 1],
                             pair_valid=np.ones(len(pos), np.float32))
            return sb

        # a microbatch's gradient is weighted by its number of pairs
        stats = common.run_train_microbatched(
            model.engine, input_, build_sb, _make_loss_fn(model.config),
            "paired_rw", n_mbs, weight_key="pair_valid")
        model.inc_version()
        return stats

    def save(self, model: model_api.Model, save_dir: str, host_params=None):
        if not self.enable_save:
            return
        common.save_checkpoint(model, save_dir, host_params)


model_api.register_interface("paired_rw", PairedRewardInterface)
