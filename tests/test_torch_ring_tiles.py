"""K6's segment-aware tile skipping on global offsets, stated in PyTorch
by ``visited_key_tiles`` with ``seg_k``, ``q_off``, ``k_off`` and
``window``: sound over every member, round and direction of a ring (no
pair the mask allows on global positions is skipped), tight on the ctx
stream and the port's packer, and K1's rule when those arguments keep
their defaults.

The kernel itself runs only on the card (``chip_smoke.py`` holds it
against ``ring_attention_plain`` and prints the pairs it walks); these
tests pin down the rule it implements and the ring offsets it is given.
Exact integer checks, no tolerance.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from realhf_tpu_torch.engine import packing
from realhf_tpu_torch.ops import flash_attention as fa
from realhf_tpu_torch.ops import ring_attention_fused as rf


def ring_plan(n, lc, bidirectional):
    """(n_dirs, lch) as ``ring_attention_fused`` picks them."""
    if n == 1:
        return 1, lc
    return rf._plan_dirs(lc, 512, bidirectional)[:2]


def _documents(rng, l):
    cuts = np.sort(rng.choice(np.arange(1, l), min(l - 1, 5), replace=False))
    seg = np.zeros(l, np.int32)
    for i, (lo, hi) in enumerate(zip([0, *cuts], [*cuts, l])):
        seg[lo:hi] = i + 1
    seg[l - int(rng.integers(0, l // 4 + 1)):] = 0      # padded tail
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


def _longest_first(rng, l):
    """The packer's order: sequences longest first, ids not ascending."""
    lens = rng.integers(1, max(2, l // 3), size=8)
    info = packing.plan_packing([int(x) for x in lens], 1, 1)
    seg = packing.segment_ids(info)[0][:l]
    return np.pad(seg, (0, l - len(seg)))


LAYOUTS = dict(documents=_documents, recurring=_recurring,
               # ids 64 apart share a residue (1, 65, 129)
               recurring_residues=lambda rng, l: _recurring(rng, l, 200),
               longest_first=_longest_first,
               all_padding=lambda rng, l: np.zeros(l, np.int32))


def _k1_rule(seg_ids, causal, bq, bk):
    """K1's rule as it stood before K6 shared it: one stream, local
    offsets, no window."""
    b, l = seg_ids.shape
    n_q, n_k = -(-l // bq), -(-l // bk)
    big = torch.iinfo(torch.int64).max

    def tiles(n, t):
        s = torch.nn.functional.pad(seg_ids.to(torch.int64),
                                    (0, n * t - l)).reshape(b, n, t)
        nz = s != 0
        residues = torch.nn.functional.one_hot(s & 63, 64) & nz[..., None]
        return (torch.where(nz, s, big).amin(-1),
                torch.where(nz, s, -big).amax(-1),
                residues.any(-2).to(torch.float32))

    q_lo, q_hi, q_res = tiles(n_q, bq)
    k_lo, k_hi, k_res = tiles(n_k, bk)
    vis = ((k_lo[:, None, :] <= q_hi[:, :, None])
           & (k_hi[:, None, :] >= q_lo[:, :, None])
           & (q_res @ k_res.transpose(1, 2) > 0))
    if causal:
        last_q = (torch.arange(1, n_q + 1) * bq).clamp(max=l) - 1
        k0 = torch.arange(n_k) * bk
        vis = vis & (k0[None, :] <= last_q[:, None])[None]
    return vis


@settings(max_examples=80, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 31 - 1),
       n=st.sampled_from([1, 2, 4, 8]),
       lc=st.integers(8, 72),
       bidirectional=st.booleans(),
       causal=st.booleans(),
       window=st.one_of(st.none(), st.integers(1, 300)),
       layouts=st.lists(st.sampled_from(sorted(LAYOUTS)), min_size=1,
                        max_size=2),
       tiles=st.sampled_from([(8, 8), (16, 8), (8, 32), (64, 64)]))
def test_ring_tiles_cover_every_allowed_pair(seed, n, lc, bidirectional,
                                             causal, window, layouts, tiles):
    rng = np.random.default_rng(seed)
    seg = torch.from_numpy(np.stack([LAYOUTS[k](rng, n * lc)
                                     for k in layouts]))
    n_dirs, lch = ring_plan(n, lc, bidirectional)
    bq, bk = tiles
    mask = fa.segment_mask(seg, seg, causal, window)   # global positions
    seen = torch.zeros(mask.shape, dtype=torch.int64)
    tq, tk = torch.arange(lc) // bq, torch.arange(lch) // bk
    for j in range(n):
        rows = slice(j * lc, (j + 1) * lc)
        for r in range(n):
            for k_off in rf.round_key_offsets(j, r, n, lc, lch, n_dirs):
                keys = slice(k_off, k_off + lch)
                vis = fa.visited_key_tiles(
                    seg[:, rows], causal, bq, bk, seg_k=seg[:, keys],
                    q_off=j * lc, k_off=k_off, window=window)
                per_pair = vis[:, tq][:, :, tk]
                assert not (mask[:, rows, keys] & ~per_pair).any()
                seen[:, rows, keys] += 1
    # the member's rounds and directions hold every key of the stream once
    assert bool((seen == 1).all())


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("causal", [True, False])
def test_default_arguments_are_k1s_rule(layout, causal):
    rng = np.random.default_rng(7)
    seg = torch.from_numpy(np.stack([LAYOUTS[layout](rng, 333)
                                     for _ in range(2)]))
    for bq, bk in ((64, 64), (16, 8), (8, 32)):
        want = _k1_rule(seg, causal, bq, bk)
        assert torch.equal(fa.visited_key_tiles(seg, causal, bq, bk), want)
        assert torch.equal(fa.visited_key_tiles(
            seg, causal, bq, bk, seg_k=seg, q_off=0, k_off=0, window=None),
            want)


def test_offsets_and_window_on_hand_made_ids():
    # one q tile of 4 rows at global 8..11 (ids 2) against key tiles of
    # 4 at global 0..3 (id 2), 4..7 (id 2), 12..15 (id 2)
    seg_q = torch.tensor([[2, 2, 2, 2]], dtype=torch.int32)
    seg_k = torch.tensor([[2, 2, 2, 2, 2, 2, 2, 2]], dtype=torch.int32)
    vis = fa.visited_key_tiles(seg_q, True, 4, 4, seg_k=seg_k, q_off=8,
                               k_off=0)
    assert vis[0, 0].tolist() == [True, True]
    # keys 12..19 start after the q tile's last row (11): causal skips
    vis = fa.visited_key_tiles(seg_q, True, 4, 4, seg_k=seg_k, q_off=8,
                               k_off=12)
    assert vis[0, 0].tolist() == [False, False]
    assert fa.visited_key_tiles(seg_q, False, 4, 4, seg_k=seg_k, q_off=8,
                                k_off=12)[0, 0].tolist() == [True, True]
    # window 5: key tile 0..3 ends 5 behind the first row (8): skipped;
    # 4..7 ends 1 behind: visited
    vis = fa.visited_key_tiles(seg_q, True, 4, 4, seg_k=seg_k, q_off=8,
                               k_off=0, window=5)
    assert vis[0, 0].tolist() == [False, True]


def test_tight_on_the_ctx_stream():
    seg = chip_smoke.doc_stream_seg(chip_smoke.CTX_DOCS, chip_smoke.CTX_PAD,
                                    "cpu")
    n = chip_smoke.CTX_MEMBERS
    n_dirs, lch = ring_plan(n, seg.shape[1] // n, True)
    assert (n_dirs, lch) == (2, 4096)
    # per document of m tokens the causal mask allows m (m + 1) / 2 pairs
    allowed = sum(m * (m + 1) // 2 for m in chip_smoke.CTX_DOCS)
    walked = chip_smoke.ring_walked_pairs(seg, n, n_dirs, True)
    assert allowed <= walked <= 1.01 * allowed
    # the causal triangle of the whole stream, which the kernel walked
    # before it skipped by segment, is ~4x the allowed
    l = seg.shape[1]
    assert l * (l + 1) / 2 / allowed > 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tight_on_the_port_packer_over_a_ring(seed):
    # the ppo_ctx path's stream: 16 sequences of prompt + answer, packed
    # longest first into one stream, padded to a multiple of 8 n
    rng = np.random.default_rng(seed)
    seqlens = [int(x) for x in rng.integers(132, 640, size=16)]
    info = packing.plan_packing(seqlens, 1, packing.DEFAULT_BUCKET)
    seg = packing.pad_stream_len(packing.segment_ids(info), 32)
    seg = torch.from_numpy(np.asarray(seg))
    n = 4
    n_dirs, _ = ring_plan(n, seg.shape[1] // n, True)
    walked = chip_smoke.ring_walked_pairs(seg, n, n_dirs, True)
    allowed = chip_smoke.allowed_pairs(seg, True)
    assert allowed <= walked <= 1.6 * allowed
