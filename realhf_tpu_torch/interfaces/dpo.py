"""Direct Preference Optimization interface.

The reference model's ``inference`` gives each sequence's answer
log-prob sum (``seqlogp``); the train step maximizes
log sigmoid(beta * (pi_logratio - ref_logratio)) over the (pos, neg)
pairs of each batch element.
"""

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from realhf_tpu_torch.api import model as model_api
from realhf_tpu_torch.api.data import SequenceSample
from realhf_tpu_torch.interfaces import common
from realhf_tpu_torch.ops import functional as F


def _answer_masks(sb: common.StreamBatch, seqlens: List[int],
                  prompt_lens_per_seq: List[int]) -> np.ndarray:
    """[S, L] mask of the shifted positions that predict answer tokens:
    for a sequence at (stream, off) of length l and prompt p, positions
    off + p - 1 .. off + l - 2 (predicting tokens p .. l - 1)."""
    s, l = sb.arrays["seg_ids"].shape
    mask = np.zeros((s, l), np.float32)
    for i, (ln, pl) in enumerate(zip(seqlens, prompt_lens_per_seq)):
        row, off = sb.info.stream[i], sb.info.offset[i]
        mask[row, off + pl - 1: off + ln - 1] = 1.0
    return mask


def _make_loss_fn(cfg, n_seqs: int, beta: float):

    def loss_fn(params, mb):
        h, aux = common.forward_with_aux(cfg, params, mb["input_ids"],
                                         mb["seg_ids"])
        lp = F.shifted_logprobs_from_hidden(
            cfg, params, h, mb["input_ids"], mb["seg_ids"])
        masked = (lp * mb["answer_mask"]).reshape(-1)
        # per-sequence sums; stream padding goes to one dustbin slot
        sums = masked.new_zeros(n_seqs + 1).index_add(
            0, mb["seq_index"].reshape(-1).long(), masked)[:n_seqs]
        pi_pos = sums[mb["pos_seq"].long()]
        pi_neg = sums[mb["neg_seq"].long()]
        ref_pos = mb["ref_pos"]
        ref_neg = mb["ref_neg"]
        valid = mb["pair_valid"]
        denom = valid.sum().clamp_min(1)
        logits = beta * ((pi_pos - pi_neg) - (ref_pos - ref_neg))
        loss = (-torch.nn.functional.logsigmoid(logits) * valid).sum() / denom
        with torch.no_grad():
            stats = {
                "loss": loss,
                "pos_score": (beta * (pi_pos - ref_pos) * valid).sum() / denom,
                "neg_score": (beta * (pi_neg - ref_neg) * valid).sum() / denom,
                "kl": (-(pi_pos - ref_pos + pi_neg - ref_neg)
                       * valid).sum() / denom,
                **aux,
            }
        return loss + sum(aux.values()), stats

    return loss_fn


@dataclasses.dataclass
class DPOInterface(model_api.ModelInterface):
    beta: float = 0.1
    #: False: ``save`` writes nothing
    enable_save: bool = True

    def _prompt_lens_per_seq(self, input_: SequenceSample) -> List[int]:
        out = []
        for lens, pl in zip(input_.seqlens["packed_input_ids"],
                            input_.data["prompt_lens"].reshape(-1).tolist()):
            out.extend([int(pl)] * len(lens))
        return out

    def _seq_logp(self, model, input_: SequenceSample) -> np.ndarray:
        """Per-sequence answer log-prob sums under the model."""
        seqlens = common.flat_seqlens(input_)
        sb = common.build_stream_batch(
            seqlens,
            token_keys=dict(input_ids=input_.data["packed_input_ids"]))
        lp = model.engine.forward_logprobs(
            sb.arrays["input_ids"], sb.arrays["seg_ids"]).cpu().numpy()
        mask = _answer_masks(sb, seqlens, self._prompt_lens_per_seq(input_))
        sums = np.zeros(len(seqlens), np.float64)
        masked = lp * mask
        for i, ln in enumerate(seqlens):
            row, off = sb.info.stream[i], sb.info.offset[i]
            sums[i] = masked[row, off:off + ln].sum()
        return sums.astype(np.float32)

    def inference(self, model: model_api.Model, input_: SequenceSample,
                  n_mbs: Optional[int] = None) -> SequenceSample:
        sums = self._seq_logp(model, input_)
        n_per_elem = [len(l) for l in input_.seqlens["packed_input_ids"]]
        return SequenceSample(
            keys=["seqlogp"],
            trailing_shapes=dict(seqlogp=()),
            dtypes=dict(seqlogp=np.float32),
            ids=input_.ids,
            seqlens=dict(seqlogp=[[1] * n for n in n_per_elem]),
            data=dict(seqlogp=sums),
        )

    def train_step(self, model: model_api.Model, input_: SequenceSample,
                   n_mbs: Optional[int] = None) -> Dict:
        mbs = common.split_minibatches(input_, n_mbs or 1)
        n_seqs_max = max(len(common.flat_seqlens(mb)) for mb in mbs)
        batches, weights = [], []
        for mb in mbs:
            seqlens = common.flat_seqlens(mb)
            sb = common.build_stream_batch(
                seqlens,
                token_keys=dict(input_ids=mb.data["packed_input_ids"]))
            sb.arrays["answer_mask"] = _answer_masks(
                sb, seqlens, self._prompt_lens_per_seq(mb))
            # pads map to index n_seqs_max (one shared dustbin segment)
            seg = sb.arrays["seg_ids"]
            sb.arrays["seq_index"] = np.where(
                seg > 0, seg - 1, n_seqs_max).astype(np.int32)
            ref = mb.data["seqlogp"].reshape(-1)
            pos_seq, neg_seq, si = [], [], 0
            for lens in mb.seqlens["packed_input_ids"]:
                for p in range(len(lens) // 2):
                    pos_seq.append(si + 2 * p)
                    neg_seq.append(si + 2 * p + 1)
                si += len(lens)
            sb.arrays.update(
                pos_seq=np.asarray(pos_seq, np.int32),
                neg_seq=np.asarray(neg_seq, np.int32),
                ref_pos=ref[pos_seq].astype(np.float32),
                ref_neg=ref[neg_seq].astype(np.float32),
                pair_valid=np.ones(len(pos_seq), np.float32))
            batches.append(sb)
            weights.append(len(pos_seq))
        batches = common.pad_stream_batches(batches)
        # the pair vectors padded to a common length too (invalid pairs)
        npair = max(b.arrays["pos_seq"].shape[0] for b in batches)
        for b in batches:
            for k in ("pos_seq", "neg_seq", "ref_pos", "ref_neg",
                      "pair_valid"):
                v = b.arrays[k]
                b.arrays[k] = np.pad(v, (0, npair - v.shape[0]))
        stats = model.engine.train_batch(
            [b.arrays for b in batches],
            _make_loss_fn(model.config, n_seqs_max, self.beta),
            loss_weights=weights)
        model.inc_version()
        return stats

    def save(self, model: model_api.Model, save_dir: str, host_params=None):
        if not self.enable_save:
            return
        common.save_checkpoint(model, save_dir, host_params)


model_api.register_interface("dpo", DPOInterface)
