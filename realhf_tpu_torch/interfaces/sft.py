"""Supervised fine-tuning interface: next-token NLL over the answer
tokens of packed prompt + answer sequences."""

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from realhf_tpu_torch.api import model as model_api
from realhf_tpu_torch.api.data import SequenceSample
from realhf_tpu_torch.interfaces import common
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.ops import functional as F


def _answer_mask(seg: torch.Tensor, prompt_mask: torch.Tensor):
    """mask[t] gates predicting token t + 1: valid next-token positions
    whose next token is not a prompt token (the prompt mask shifted by
    one)."""
    no = torch.zeros_like(seg[:, :1], dtype=torch.bool)
    next_same = torch.cat(
        [(seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] != 0), no], 1)
    next_is_prompt = torch.cat([prompt_mask[:, 1:].bool(), no], 1)
    return next_same & ~next_is_prompt


def _make_loss_fn(cfg):

    def loss_fn(params, mb):
        h, _ = T.forward(cfg, params, mb["input_ids"], mb["seg_ids"])
        lp = F.shifted_logprobs_from_hidden(cfg, params, h, mb["input_ids"],
                                            mb["seg_ids"])
        mask = _answer_mask(mb["seg_ids"], mb["prompt_mask"])
        denom = mask.sum().clamp_min(1)
        nll = -(lp * mask).sum() / denom
        return nll, {"nll": nll.detach(), "n_tokens": denom.float()}

    return loss_fn


@dataclasses.dataclass
class SFTInterface(model_api.ModelInterface):
    """One argument, ``enable_save`` (the JAX package's takes none); an
    unknown one raises ``TypeError`` when the interface is made."""
    enable_save: bool = True

    def train_step(self, model: model_api.Model, input_: SequenceSample,
                   n_mbs: Optional[int] = None) -> Dict:
        engine = model.engine
        batches = []
        for mb in common.split_minibatches(input_, n_mbs or 1):
            batches.append(common.build_stream_batch(
                common.flat_seqlens(mb),
                token_keys=dict(input_ids=mb.data["packed_input_ids"],
                                prompt_mask=mb.data["prompt_mask"])))
        batches = common.pad_stream_batches(batches)
        # weight by ANSWER tokens (what each microbatch loss averages
        # over), so the accumulated gradient is the one-big-batch one
        weights = [float((~b.arrays["prompt_mask"].astype(bool)
                          & (b.arrays["seg_ids"] != 0)).sum())
                   for b in batches]
        if not any(w > 0 for w in weights):
            weights = [float(b.n_tokens) for b in batches]
        stats = engine.train_batch([b.arrays for b in batches],
                                   _make_loss_fn(model.config),
                                   loss_weights=weights, loss_fn_key="sft")
        model.inc_version()
        return stats

    def evaluate(self, model: model_api.Model, eval_dataloader) -> Dict:
        losses, tokens = [], []
        for batch in eval_dataloader:
            sb = common.build_stream_batch(
                common.flat_seqlens(batch),
                token_keys=dict(input_ids=batch.data["packed_input_ids"],
                                prompt_mask=batch.data["prompt_mask"]))
            lp = model.engine.forward_logprobs(
                sb.arrays["input_ids"], sb.arrays["seg_ids"]).cpu().numpy()
            mask = _answer_mask(
                torch.from_numpy(sb.arrays["seg_ids"]),
                torch.from_numpy(sb.arrays["prompt_mask"])).numpy()
            losses.append(-(lp * mask).sum())
            tokens.append(mask.sum())
        if not tokens:
            return {}
        loss = float(np.sum(losses) / max(1, np.sum(tokens)))
        return {"loss": loss, "ppl": float(np.exp(loss))}

    def save(self, model: model_api.Model, save_dir: str, host_params=None):
        if not self.enable_save:
            return
        common.save_checkpoint(model, save_dir, host_params)


model_api.register_interface("sft", SFTInterface)
