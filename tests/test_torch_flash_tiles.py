"""K1's segment-aware tile skipping, stated in PyTorch by
``visited_key_tiles``: sound (no pair the mask allows is skipped) for
any segment ids, and tight on the port's packers.

The kernel itself runs only on the card (``chip_smoke.py`` holds it
against ``flash_attention_plain`` and prints the pairs it walks); these
tests pin down the rule it implements. Exact integer checks, no
tolerance.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from realhf_tpu_torch.engine import packing
from realhf_tpu_torch.ops import flash_attention as fa


def skipped_allowed_pairs(seg, causal, bq, bk) -> int:
    """Pairs ``segment_mask`` allows that lie in a skipped tile pair."""
    vis = fa.visited_key_tiles(seg, causal, bq, bk)
    l = seg.shape[1]
    tq, tk = torch.arange(l) // bq, torch.arange(l) // bk
    per_pair = vis[:, tq][:, :, tk]
    return int((fa.segment_mask(seg, seg, causal) & ~per_pair).sum())


def walked_over_allowed(seg, causal=True) -> float:
    return (chip_smoke.walked_pairs(seg, causal)
            / chip_smoke.allowed_pairs(seg, causal))


def _contiguous(rng, l):
    cuts = np.sort(rng.choice(np.arange(1, l), min(l - 1, 4), replace=False))
    seg = np.zeros(l, np.int32)
    for i, (lo, hi) in enumerate(zip([0, *cuts], [*cuts, l])):
        seg[lo:hi] = i + 1
    seg[l - int(rng.integers(0, l // 3 + 1)):] = 0      # padded tail
    return seg


def _left_padded(rng, l):
    seg = np.zeros(l, np.int32)
    seg[int(rng.integers(0, l + 1)):] = 1
    return seg


def _recurring(rng, l, top=5):
    """Pieces whose ids recur out of order (3, 1, 3, 0, 2, ...)."""
    seg = np.zeros(l, np.int32)
    off = 0
    while off < l:
        n = int(rng.integers(1, 40))
        seg[off:off + n] = int(rng.integers(0, top))
        off += n
    return seg


LAYOUTS = dict(contiguous=_contiguous, left_padded=_left_padded,
               recurring=_recurring,
               # ids 64 apart share a residue (1, 65, 129)
               recurring_residues=lambda rng, l: _recurring(rng, l, 200),
               all_padding=lambda rng, l: np.zeros(l, np.int32))


@settings(max_examples=60, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 31 - 1),
       l=st.integers(1, 300),
       layouts=st.lists(st.sampled_from(sorted(LAYOUTS)), min_size=1,
                        max_size=3),
       causal=st.booleans(),
       tiles=st.sampled_from([(8, 8), (16, 8), (8, 32), (64, 64)]))
def test_visited_tiles_cover_every_allowed_pair(seed, l, layouts, causal,
                                                tiles):
    rng = np.random.default_rng(seed)
    seg = torch.from_numpy(np.stack([LAYOUTS[k](rng, l) for k in layouts]))
    assert skipped_allowed_pairs(seg, causal, *tiles) == 0


def test_default_tiles_are_the_kernels():
    assert (fa.K1_BQ, fa.K1_BK) == (64, 64)
    seg = torch.ones((1, 130), dtype=torch.int32)
    assert tuple(fa.visited_key_tiles(seg, True).shape) == (1, 3, 3)


@pytest.mark.parametrize("causal", [True, False])
def test_rule_on_hand_made_ids(causal):
    # tiles of 4: q tile 0 holds ids {1}, tile 1 {1, 2}, tile 2 pads,
    # tile 3 {3}; ragged last tile of 2 holds {1} again (out of order)
    seg = torch.tensor([[1, 1, 1, 1, 1, 1, 2, 2, 0, 0, 0, 0, 3, 3, 3, 3,
                         1, 1]], dtype=torch.int32)
    vis = fa.visited_key_tiles(seg, causal, 4, 4)[0]
    want = torch.tensor([[1, 1, 0, 0, 1],
                         [1, 1, 0, 0, 1],
                         [0, 0, 0, 0, 0],
                         [0, 0, 0, 1, 0],
                         [1, 1, 0, 0, 1]], dtype=torch.bool)
    if causal:
        want = want & torch.ones(5, 5, dtype=torch.bool).tril()
    assert torch.equal(vis, want)
    assert skipped_allowed_pairs(seg, causal, 4, 4) == 0


def test_ids_sharing_a_residue_are_visited():
    # q tile {1, 70} (residues 1, 6) and key tile {65}: ranges and
    # residues meet, so it is visited though no pair is allowed; key tile
    # {2}: the range meets, the residue does not, skipped
    seg = torch.tensor([[1, 70, 65, 65, 2, 2, 1, 1]], dtype=torch.int32)
    vis = fa.visited_key_tiles(seg, False, 2, 2)[0]
    assert vis[0].tolist() == [True, True, False, True]
    assert skipped_allowed_pairs(seg, False, 2, 2) == 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tight_on_the_sft_stream_layout(seed):
    # chip_smoke's sft microbatch: one stream of 4096 tokens, 8 segments
    seg = chip_smoke.sft_stream_seg(np.random.default_rng(seed), 8, 4096,
                                    "cpu")
    ratio = walked_over_allowed(seg)
    assert 1.0 <= ratio <= 1.5
    # the whole causal triangle, which a kernel without skipping walks, is ~7x
    l = seg.shape[1]
    assert (l * (l + 1) / 2) / chip_smoke.allowed_pairs(seg, True) > 6


@pytest.mark.parametrize("lo,hi", [(200, 800), (100, 640)])
def test_tight_on_the_port_packer(lo, hi):
    # the port's packer over sft-like and ppo-like sequence lengths
    rng = np.random.default_rng(lo)
    seqlens = [int(x) for x in rng.integers(lo, hi, size=16)]
    info = packing.plan_packing(seqlens, 1, packing.DEFAULT_BUCKET)
    seg = torch.from_numpy(np.asarray(packing.segment_ids(info)))
    assert skipped_allowed_pairs(seg, True, fa.K1_BQ, fa.K1_BK) == 0
    assert walked_over_allowed(seg) <= 1.5
