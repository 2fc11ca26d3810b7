"""Packing variable-length sequences into the model's ``[B, L]``
stream layout, with L rounded up to a bucket multiple so shapes stay
few: training batches pack several sequences per stream (segment ids
tell them apart), generation left-pads one prompt per stream."""

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_BUCKET = 128


@dataclasses.dataclass
class PackInfo:
    """Where each sequence landed: parallel lists over sequences."""
    stream: List[int]
    offset: List[int]
    length: List[int]
    n_streams: int
    max_len: int

    @property
    def n_seqs(self) -> int:
        return len(self.stream)


def plan_packing(seqlens: Sequence[int], n_streams: int,
                 bucket: int = DEFAULT_BUCKET) -> PackInfo:
    """Assign sequences to streams, longest first onto the emptiest
    stream (balanced token counts); L is the fullest stream rounded up
    to the bucket."""
    seqlens = np.asarray(seqlens)
    if len(seqlens) == 0:
        raise ValueError("Cannot pack an empty sequence list.")
    stream_tokens = np.zeros(n_streams, np.int64)
    stream_of = np.zeros(len(seqlens), np.int32)
    offset_of = np.zeros(len(seqlens), np.int32)
    for i in np.argsort(seqlens)[::-1]:
        s = int(stream_tokens.argmin())
        stream_of[i] = s
        offset_of[i] = stream_tokens[s]
        stream_tokens[s] += seqlens[i]
    max_len = int(stream_tokens.max())
    max_len = ((max_len + bucket - 1) // bucket) * bucket
    return PackInfo(stream=stream_of.tolist(), offset=offset_of.tolist(),
                    length=[int(x) for x in seqlens], n_streams=n_streams,
                    max_len=max_len)


def pack_tokens(info: PackInfo, flat: np.ndarray,
                seqlens: Optional[Sequence[int]] = None,
                fill=0) -> np.ndarray:
    """Scatter a 1D packed per-token array (sequences concatenated in
    order) into the [S, L] stream layout; ``seqlens`` defaults to
    info.length (pass shorter ones for keys of length l - 1)."""
    lens = list(seqlens) if seqlens is not None else info.length
    if len(lens) != info.n_seqs:
        raise ValueError(f"{len(lens)} lengths for {info.n_seqs} sequences")
    out = np.full((info.n_streams, info.max_len) + flat.shape[1:], fill,
                  dtype=flat.dtype)
    src = 0
    for i, ln in enumerate(lens):
        s, off = info.stream[i], info.offset[i]
        out[s, off:off + ln] = flat[src:src + ln]
        src += ln
    if src != len(flat):
        raise ValueError(f"lengths sum to {src}, array has {len(flat)}")
    return out


def segment_ids(info: PackInfo) -> np.ndarray:
    """[S, L] int32 segment matrix: sequence i gets id i+1; pads 0."""
    out = np.zeros((info.n_streams, info.max_len), np.int32)
    for i, ln in enumerate(info.length):
        s, off = info.stream[i], info.offset[i]
        out[s, off:off + ln] = i + 1
    return out


def unpack_tokens(info: PackInfo, arr: np.ndarray,
                  seqlens: Optional[Sequence[int]] = None) -> np.ndarray:
    """Gather [S, L, ...] back into the flat packed 1D layout."""
    lens = list(seqlens) if seqlens is not None else info.length
    return np.concatenate(
        [arr[info.stream[i], info.offset[i]:info.offset[i] + ln]
         for i, ln in enumerate(lens)], axis=0)


def per_seq_gather(info: PackInfo, arr: np.ndarray,
                   index_in_seq: Sequence[int]) -> np.ndarray:
    """One element per sequence (e.g. the last token's value)."""
    return np.stack([arr[info.stream[i], info.offset[i] + idx]
                     for i, idx in enumerate(index_in_seq)], axis=0)


def left_padded_prompts(prompts: List[np.ndarray], pad_id: int,
                        bucket: int = DEFAULT_BUCKET
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build the generation prefill batch: [B, Lp] left-padded token
    matrix + segment ids (1 over content) + positions. Left padding
    keeps every stream's last prompt token at column Lp-1 so decode
    appends uniformly (reference pads KV likewise,
    real_llm_generate.py:179)."""
    b = len(prompts)
    lp = max(len(p) for p in prompts)
    lp = ((lp + bucket - 1) // bucket) * bucket
    ids = np.full((b, lp), pad_id, np.int32)
    seg = np.zeros((b, lp), np.int32)
    pos = np.zeros((b, lp), np.int32)
    for i, p in enumerate(prompts):
        ids[i, lp - len(p):] = p
        seg[i, lp - len(p):] = 1
        pos[i, lp - len(p):] = np.arange(len(p))
    return ids, seg, pos


def pad_stream_len(arr: np.ndarray, multiple: int, fill=0) -> np.ndarray:
    """Pad the L axis (axis 1) of ``[S, L, ...]`` up to a multiple of
    ``multiple`` with ``fill``; returned as is when it already is one.
    Context parallelism pads to ``n * 8`` (n members) with segment id 0,
    so that every member's shard has a tile of 8 tokens."""
    arr = np.asarray(arr)
    pad = -arr.shape[1] % multiple
    if pad == 0:
        return arr
    widths = [(0, 0), (0, pad)] + [(0, 0)] * (arr.ndim - 2)
    return np.pad(arr, widths, constant_values=fill)
