"""Shared interface plumbing: a SequenceSample minibatch packed into
``[S, L]`` stream arrays for the engine."""

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from realhf_tpu_torch.api.data import SequenceSample
from realhf_tpu_torch.base.datapack import flat2d
from realhf_tpu_torch.engine import packing


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


def pad_stream_batches(batches: List[StreamBatch]) -> List[StreamBatch]:
    """Pad stream batches to a common [S, L] (the JAX package stacks
    its microbatches into one array, so the port keeps its shapes)."""
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
