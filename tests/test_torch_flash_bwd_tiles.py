"""K3's tile skipping, stated in PyTorch by ``visited_q_tiles``: the
(key tile, q tile) pairs the dk/dv kernel computes, marked from the key
side. Sound (no pair the mask allows is skipped) for any segment ids,
exactly the transpose of K1's and K2's rule (``visited_key_tiles``), and
tight on the sft layout and the port's packer.

The kernels themselves run only on the card (``chip_smoke.py`` holds K2
and K3 against the plain backward and prints the pairs each walks);
these tests pin down the rule K3 implements. Exact integer checks, no
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
from test_torch_flash_tiles import LAYOUTS


def skipped_allowed_pairs(seg, causal, bk, bq) -> int:
    """Pairs ``segment_mask`` allows whose (key tile, q tile) pair
    ``visited_q_tiles`` skips."""
    vis = fa.visited_q_tiles(seg, causal, bk, bq)
    l = seg.shape[1]
    tq, tk = torch.arange(l) // bq, torch.arange(l) // bk
    per_pair = vis[:, tk][:, :, tq].transpose(1, 2)       # [B, q, key]
    return int((fa.segment_mask(seg, seg, causal) & ~per_pair).sum())


@settings(max_examples=60, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 31 - 1),
       l=st.integers(1, 300),
       layouts=st.lists(st.sampled_from(sorted(LAYOUTS)), min_size=1,
                        max_size=3),
       causal=st.booleans(),
       tiles=st.sampled_from([(8, 8), (16, 8), (8, 32), (64, 64)]))
def test_visited_q_tiles_cover_every_allowed_pair(seed, l, layouts, causal,
                                                  tiles):
    rng = np.random.default_rng(seed)
    seg = torch.from_numpy(np.stack([LAYOUTS[k](rng, l) for k in layouts]))
    assert skipped_allowed_pairs(seg, causal, *tiles) == 0


@settings(max_examples=60, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 31 - 1),
       l=st.integers(1, 300),
       layouts=st.lists(st.sampled_from(sorted(LAYOUTS)), min_size=1,
                        max_size=3),
       causal=st.booleans(),
       tiles=st.sampled_from([(8, 8), (16, 8), (8, 32), (64, 64)]))
def test_visited_q_tiles_is_the_transpose_of_k1s_rule(seed, l, layouts,
                                                      causal, tiles):
    rng = np.random.default_rng(seed)
    seg = torch.from_numpy(np.stack([LAYOUTS[k](rng, l) for k in layouts]))
    bk, bq = tiles
    assert torch.equal(fa.visited_q_tiles(seg, causal, bk, bq),
                       fa.visited_key_tiles(seg, causal, bq, bk)
                       .transpose(-1, -2))


@pytest.mark.parametrize("causal", [True, False])
def test_rule_on_hand_made_ids(causal):
    # tiles of 4: key tile 0 holds ids {1}, tile 1 {1, 2}, tile 2 pads,
    # tile 3 {3}; ragged last tile of 2 holds {1} again (out of order)
    seg = torch.tensor([[1, 1, 1, 1, 1, 1, 2, 2, 0, 0, 0, 0, 3, 3, 3, 3,
                         1, 1]], dtype=torch.int32)
    vis = fa.visited_q_tiles(seg, causal, 4, 4)[0]
    want = torch.tensor([[1, 1, 0, 0, 1],
                         [1, 1, 0, 0, 1],
                         [0, 0, 0, 0, 0],
                         [0, 0, 0, 1, 0],
                         [1, 1, 0, 0, 1]], dtype=torch.bool)
    if causal:  # a key tile sees only the q tiles from its own on
        want = want & torch.ones(5, 5, dtype=torch.bool).triu()
    assert torch.equal(vis, want)
    assert skipped_allowed_pairs(seg, causal, 4, 4) == 0


def test_default_tiles_are_the_kernels():
    seg = torch.ones((1, 130), dtype=torch.int32)
    assert tuple(fa.visited_q_tiles(seg, True).shape) == (1, 3, 3)
    assert chip_smoke.dkv_walked_pairs(seg, True) \
        == chip_smoke.walked_pairs(seg, True)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tight_on_the_sft_stream_layout(seed):
    # chip_smoke's sft microbatch: one stream of 4096 tokens, 8 segments
    seg = chip_smoke.sft_stream_seg(np.random.default_rng(seed), 8, 4096,
                                    "cpu")
    walked = chip_smoke.dkv_walked_pairs(seg, True)
    assert walked == chip_smoke.walked_pairs(seg, True)
    assert 1.0 <= walked / chip_smoke.allowed_pairs(seg, True) <= 1.5


@pytest.mark.parametrize("lo,hi", [(200, 800), (100, 640)])
def test_tight_on_the_port_packer(lo, hi):
    # the port's packer over sft-like and ppo-like sequence lengths
    rng = np.random.default_rng(lo)
    seqlens = [int(x) for x in rng.integers(lo, hi, size=16)]
    info = packing.plan_packing(seqlens, 1, packing.DEFAULT_BUCKET)
    seg = torch.from_numpy(np.asarray(packing.segment_ids(info)))
    assert skipped_allowed_pairs(seg, True, fa.K1_BK, fa.K1_BQ) == 0
    walked = chip_smoke.dkv_walked_pairs(seg, True)
    assert walked / chip_smoke.allowed_pairs(seg, True) <= 1.5
