"""Shared interface plumbing: a SequenceSample minibatch packed into
``[S, L]`` stream arrays for the engine, and the interfaces' save."""

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from realhf_tpu_torch.api.data import SequenceSample
from realhf_tpu_torch.base.datapack import flat2d
from realhf_tpu_torch.engine import packing
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.hf import (
    save_hf_checkpoint,
    save_hf_checkpoint_streamed,
)


def seqlens_of(input_: SequenceSample,
               key: str = "packed_input_ids") -> List[int]:
    """Total length per batch element for a key (an element may hold
    several sequences, e.g. a reward pair)."""
    return [sum(l) for l in input_.seqlens[key]]


def flat_seqlens(input_: SequenceSample,
                 key: str = "packed_input_ids") -> List[int]:
    """Per-sequence lengths, flattened over batch elements."""
    return flat2d(input_.seqlens[key])


@dataclasses.dataclass
class StreamBatch:
    """One packed minibatch ready for the engine."""
    info: packing.PackInfo
    arrays: Dict[str, np.ndarray]
    n_tokens: int


def build_stream_batch(
    seqlens: Sequence[int],
    token_keys: Dict[str, np.ndarray],
    shifted_keys: Optional[Dict[str, np.ndarray]] = None,
    n_streams: int = 1,
    bucket: int = packing.DEFAULT_BUCKET,
) -> StreamBatch:
    """Pack flat per-token arrays into stream layout, with ``seg_ids``.

    ``token_keys`` have per-sequence length l; ``shifted_keys`` have
    length l - 1 (log-probs, advantages, ...) and are aligned to the
    sequence start, so index t belongs to predicting token t + 1.
    """
    info = packing.plan_packing(seqlens, n_streams, bucket)
    arrays = {"seg_ids": packing.segment_ids(info)}
    for k, v in token_keys.items():
        arrays[k] = packing.pack_tokens(info, v)
    if shifted_keys:
        short = [l - 1 for l in seqlens]
        for k, v in shifted_keys.items():
            arrays[k] = packing.pack_tokens(info, v, seqlens=short)
    return StreamBatch(info=info, arrays=arrays,
                       n_tokens=int(np.sum(seqlens)))


def split_minibatches(input_: SequenceSample, n: int,
                      min_size: int = 1) -> List[SequenceSample]:
    """Token-balanced minibatch split (``SequenceSample.split``),
    clamped so tiny batches still work."""
    n = max(1, min(n, input_.bs // max(1, min_size)))
    if n <= 1:
        return [input_]
    return input_.split(n, min_size=min_size)


def forward_with_aux(cfg, params, input_ids, seg_ids):
    """Model forward returning (hidden, aux-loss dict). For a
    mixture-of-experts model the dict carries the router's
    load-balancing / z losses summed over the layers, which a training
    objective must add; a dense model returns an empty dict. A pipeline
    layout's schedule rides on its ``MemberParams`` (the JAX interfaces
    pass ``engine.pipeline_ctx`` here)."""
    h, _, aux = T.forward(cfg, params, input_ids, seg_ids, return_aux=True)
    return h, aux


def run_train_microbatched(engine, sample: SequenceSample, build_sb,
                           loss_fn, loss_fn_key, n_mbs: Optional[int],
                           weight_key: str = "loss_mask") -> Dict:
    """One optimizer step over ``n_mbs`` memory microbatches of
    ``sample``, each built by ``build_sb``; see
    ``run_train_minibatches``."""
    return run_train_minibatches(engine, [sample], build_sb, loss_fn,
                                 loss_fn_key, n_mbs, weight_key)[0]


def run_train_minibatches(engine, minibatch_samples, build_sb, loss_fn,
                          loss_fn_key, n_mbs: Optional[int],
                          weight_key: str = "loss_mask") -> List[Dict]:
    """The PPO-style minibatch loop: one optimizer step per minibatch
    sample, each accumulating over ``n_mbs`` memory microbatches.

    A microbatch's gradient is weighted by its LOSS-MASK token count,
    which makes the accumulated gradient the one-big-batch gradient
    (each microbatch loss is a mean over its own masked tokens;
    weighting by all tokens would over-weight the response tokens of a
    prompt-heavy microbatch). The microbatches of one minibatch are
    padded to a common [S, L]; minibatches keep their own shapes (eager
    PyTorch stacks nothing, and padding tokens change no stat)."""
    stacks, weights = [], []
    for sample in minibatch_samples:
        sbs = pad_stream_batches(
            [build_sb(m) for m in split_minibatches(sample, n_mbs or 1)])
        w = [float(np.asarray(sb.arrays[weight_key]).sum()) for sb in sbs]
        if not any(x > 0 for x in w):  # degenerate batch: avoid 0/0
            w = [float(sb.n_tokens) for sb in sbs]
        stacks.append([sb.arrays for sb in sbs])
        weights.append(w)
    return engine.train_minibatches(stacks, loss_fn, weights, loss_fn_key)


def pad_stream_batches(batches: List[StreamBatch]) -> List[StreamBatch]:
    """Pad stream batches to a common [S, L] (per-pair and per-sequence
    vectors are left as they are)."""
    s = max(b.arrays["seg_ids"].shape[0] for b in batches)
    l = max(b.arrays["seg_ids"].shape[1] for b in batches)
    out = []
    for b in batches:
        arrays = {}
        for k, v in b.arrays.items():
            if v.ndim < 2:  # per-pair / per-sequence vectors
                arrays[k] = v
                continue
            pad = [(0, s - v.shape[0]), (0, l - v.shape[1])] + \
                [(0, 0)] * (v.ndim - 2)
            arrays[k] = np.pad(v, pad)
        out.append(StreamBatch(info=b.info, arrays=arrays,
                               n_tokens=b.n_tokens))
    return out


def save_checkpoint(model, save_dir: str, host_params=None):
    """The body every interface's ``save`` shares: an HF-layout
    checkpoint of the model's family, streamed one layer at a time from
    the device tensors (a data- and tensor-parallel engine's canonical
    tree, gathered on the host), or written whole from ``host_params``
    (a host numpy copy of the weights) when given."""
    if host_params is not None:
        save_hf_checkpoint(save_dir, model.hf_family, model.config,
                           host_params, tokenizer=model.tokenizer)
    else:
        eng = model.engine
        save_hf_checkpoint_streamed(
            save_dir, model.hf_family, model.config,
            eng.gathered_params("cpu") if eng.sharded else eng.params,
            tokenizer=model.tokenizer)
