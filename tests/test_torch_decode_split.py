"""The flash-decode kernel's walk, stated in PyTorch: ``decode_split_plan``
(which 64-slot tiles a stream's CTA walks), ``warp_slots`` (the 16 slots
of each that one warp takes) and ``decode_attention_split_plain`` (a
softmax per warp, then the flash merge), held against
``decode_attention_plain`` and against the JAX package's Pallas decode
kernel in interpret mode, under hypothesis over batch, cache length (not
a multiple of 64), left padding, empty streams, single slots, interior
holes, windows and GQA groups, and on the layouts of ``chip_smoke``'s
K4 cases. The plan is held sound (every kept slot walked by exactly one
warp) and tight (only tiles that hold a kept slot; on the gen path's
layout at most 1.2x the kept slots), and the merge's planted fault (one
warp's part left out) is held to move the rows. Then the CUDA wrapper's
checks, on CPU tensors that say they are on the card.

Tolerances: fp32 on both sides, summed in different orders; 2e-5 as in
the port's other decode tests, the statistics' l relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from realhf_tpu.ops.decode_attention import (
    flash_decode_attention as jax_flash_decode,
)
from realhf_tpu_torch.ops import decode_attention as da

TOL = dict(atol=2e-5, rtol=2e-5)
SETTINGS = dict(deadline=None, derandomize=True,
                suppress_health_check=[HealthCheck.too_slow])


def make_valid(rng, b, s, kinds):
    """[b, s] bool: per stream an empty, single-slot, left-padded or
    holed layout."""
    valid = np.zeros((b, s), bool)
    for i, kind in enumerate(kinds):
        if kind == "single":
            valid[i, rng.integers(0, s)] = True
        elif kind == "left_pad":
            lo = int(rng.integers(0, s))
            valid[i, lo:int(rng.integers(lo + 1, s + 1))] = True
        elif kind == "holes":
            valid[i] = rng.random(s) < 0.3
            valid[i, rng.integers(0, s, size=3)] = False
        elif kind == "full":
            valid[i] = True
    return valid


layouts = st.lists(st.sampled_from(["empty", "single", "left_pad", "holes",
                                    "full"]), min_size=1, max_size=4)


def make_case(seed, kinds, s, nkv, group, hd, window):
    rng = np.random.default_rng(seed)
    b = len(kinds)
    q = rng.standard_normal((b, nkv * group, hd)).astype(np.float32)
    k = rng.standard_normal((b, nkv, s, hd)).astype(np.float32)
    v = rng.standard_normal((b, nkv, s, hd)).astype(np.float32)
    valid = make_valid(rng, b, s, kinds)
    slot = np.asarray([int(np.flatnonzero(r)[-1]) if r.any() else 0
                       for r in valid], np.int32)
    return q, k, v, valid, slot, window


def _keep(valid, slot, window):
    return da.window_keep(torch.from_numpy(valid), window,
                          torch.from_numpy(slot))


@settings(max_examples=40, **SETTINGS)
@given(seed=st.integers(0, 2 ** 16), kinds=layouts,
       s=st.integers(1, 300), nkv=st.sampled_from([1, 2]),
       group=st.sampled_from([1, 2, 4, 8, 16]),
       window=st.sampled_from([None, 1, 17, 64, 100]))
def test_split_plain_matches_plain(seed, kinds, s, nkv, group, window):
    q, k, v, valid, slot, window = make_case(seed, kinds, s, nkv, group, 8,
                                             window)
    keep = _keep(valid, slot, window)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ref = da.decode_attention_plain(tq, tk, tv, keep, return_stats=True)
    got = da.decode_attention_split_plain(tq, tk, tv, keep,
                                          return_stats=True)
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), **TOL)
    np.testing.assert_allclose(got[1].numpy(), ref[1].numpy(), **TOL)
    np.testing.assert_allclose(got[2].numpy(), ref[2].numpy(), rtol=2e-5)
    empty = ~keep.bool().any(-1)
    assert torch.all(got[0][empty] == 0)
    assert torch.all(got[2][empty] == s)       # l = S for an empty stream
    assert torch.all(got[1][empty] == da.NEG_INF)


@settings(max_examples=8, **SETTINGS)
@given(seed=st.integers(0, 2 ** 16), kinds=layouts,
       s=st.sampled_from([70, 200]), group=st.sampled_from([1, 4, 16]),
       window=st.sampled_from([None, 33]))
def test_split_plain_matches_jax_kernel(seed, kinds, s, group, window):
    """S below the JAX kernel's block, so it takes the whole cache in one
    block with no padding and its l counts exactly the S slots."""
    q, k, v, valid, slot, window = make_case(seed, kinds, s, 2, group, 16,
                                             window)
    ref = jax_flash_decode(*(jnp.asarray(a) for a in (q, k, v, valid)),
                           sliding_window=window, slot=jnp.asarray(slot),
                           interpret=True, return_stats=True)
    keep = _keep(valid, slot, window)
    got = da.decode_attention_split_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), keep, return_stats=True)
    for g, r, name in zip(got, ref, ("out", "m", "l")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)


@settings(max_examples=60, **SETTINGS)
@given(seed=st.integers(0, 2 ** 16), kinds=layouts, s=st.integers(1, 700),
       window=st.sampled_from([None, 1, 50, 300]))
def test_plan_is_sound_and_tight(seed, kinds, s, window):
    _, _, _, valid, slot, window = make_case(seed, kinds, s, 1, 1, 1, window)
    keep = _keep(valid, slot, window).bool()
    plan = da.decode_split_plan(keep)
    assert len(plan) == len(kinds)
    for row, tiles in zip(keep, plan):
        # tight: every walked tile holds a kept slot, so none lies
        # outside [first kept, last kept]; and every such tile is walked
        need = sorted({int(i) // da.TILE for i in row.nonzero().flatten()})
        assert tiles == need
        # sound: the warps' slots cover the walked tiles' in-cache slots,
        # each exactly once, so every kept slot is walked once
        walked = torch.cat([da.warp_slots(tiles, w, s)
                            for w in range(da.WARPS)])
        cover = sorted(i for t in tiles
                       for i in range(t * da.TILE, min(t * da.TILE + da.TILE,
                                                       s)))
        assert sorted(walked.tolist()) == cover
        kept = set(row.nonzero().flatten().tolist())
        assert kept <= set(cover)


def test_plan_on_the_gen_layout():
    """The gen path's cache: 8 prompts of 100-512 words left-padded to
    512, then t new tokens (t = 1..128) in a cache of 640 slots. Each
    stream walks at most its partial first and last tiles beyond what it
    keeps; over all decode steps the walked slots are at most 1.2x the
    kept ones (1.16 on these prompts), at most 1.45x in any one step."""
    rng = np.random.default_rng(0)
    walked_all = kept_all = 0
    for _ in range(3):
        lengths = rng.integers(100, 513, size=8)
        for t in range(1, 129):
            valid = torch.zeros((8, 640), dtype=torch.bool)
            for i, n in enumerate(lengths):
                valid[i, 512 - n:512 + t] = True
            walked = [da.TILE * len(p) for p in da.decode_split_plan(valid)]
            kept = valid.sum(-1).tolist()
            assert all(0 <= w - k < 2 * da.TILE
                       for w, k in zip(walked, kept))
            assert sum(walked) <= 1.45 * sum(kept)
            walked_all += sum(walked)
            kept_all += sum(kept)
    assert walked_all <= 1.2 * kept_all


def test_plan_walks_the_tiles_in_order():
    keep = torch.zeros((2, 300), dtype=torch.int32)
    keep[0, 70:71] = 1
    keep[0, 299] = 1
    keep[1, 5:140] = 1
    assert da.decode_split_plan(keep) == [[1, 4], [0, 1, 2]]
    # tile 4 holds slots 256..299: warp 2 takes 288..299, warp 3 none
    assert da.warp_slots([1, 4], 0, 300).tolist() == (
        list(range(64, 80)) + list(range(256, 272)))
    assert da.warp_slots([1, 4], 2, 300).tolist() == (
        list(range(96, 112)) + list(range(288, 300)))
    assert da.warp_slots([1, 4], 3, 300).tolist() == list(range(112, 128))
    assert da.warp_slots([], 1, 300).tolist() == []


#: the K4/K5 layouts of ``chip_smoke.phase_kernels`` at a narrow width:
#: (B, S, nq, nkv, hd, spans, window)
#: the gen layout: prompts left-padded to 512, 64 new slots, stream 5 empty
GEN_SPANS = [(512 - n, 576) for n in (100, 180, 260, 340, 420, 0, 500, 512)]
GEN_SPANS[5] = (0, 0)
CHIP_LAYOUTS = {
    "main_decode_mha": (8, 640, 2, 2, 16, GEN_SPANS, None),
    "gqa_32_8": (8, 640, 8, 2, 16, GEN_SPANS, None),
    "hd64_ragged_s": (4, 200, 2, 2, 16,
                      [(10, 150), (0, 200), (0, 0), (199, 200)], None),
    "b1": (1, 640, 2, 2, 16, [(212, 576)], None),
    "window_96": (8, 640, 8, 2, 16, GEN_SPANS, 96),
    "last_tile_only": (4, 640, 8, 2, 16,
                       [(639, 640), (0, 640), (300, 400), (0, 0)], None),
    "interior_holes": (4, 700, 4, 1, 16,
                       [[(10, 60), (300, 310), (600, 700)],
                        [(0, 64), (192, 256)], [(5, 6), (699, 700)],
                        [(130, 131), (131, 140), (450, 460)]], None),
    "ppo_decode": (16, 640, 2, 2, 16, GEN_SPANS * 2, None),
}


@pytest.mark.parametrize("case", sorted(CHIP_LAYOUTS))
def test_split_plain_on_chip_smoke_layouts(case):
    """Each K4 layout of the card's checks: the warp split equals the
    plain function (out, m, l, empty streams included), and leaving warp
    1's part out (the merge's planted fault) moves some row by far more
    than the card's 0.08 row limit."""
    import chip_smoke
    b, s, nq, nkv, hd, spans, window = CHIP_LAYOUTS[case]
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((b, nq, hd), generator=gen)
    k = torch.randn((b, nkv, s, hd), generator=gen)
    v = torch.randn((b, nkv, s, hd), generator=gen)
    valid = chip_smoke.decode_valid(b, s, spans, "cpu")
    slot = (s - 1 - valid.flip(-1).int().argmax(-1)).int()
    keep = da.window_keep(valid, window, slot)
    ref = da.decode_attention_plain(q, k, v, keep, return_stats=True)
    got = da.decode_attention_split_plain(q, k, v, keep, return_stats=True)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=2e-5, rtol=2e-5)
    rows = keep.any(-1)[:, None].expand(b, nq)
    fault = da.decode_attention_split_plain(q, k, v, keep, drop_warp=1)
    assert chip_smoke.row_rel_err(fault, ref[0], rows) > 0.08
    assert chip_smoke.row_rel_err(got[0], ref[0], rows) < 1e-4


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: drives the CUDA
    wrapper's checks without a device."""

    @property
    def is_cuda(self):
        return True


def _stub(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)).as_subclass(_OnCard)
            for a in arrs]


def test_cuda_wrapper_checks_before_it_launches(monkeypatch):
    calls = []

    def kernel(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(da, "_kernel", lambda: kernel)
    monkeypatch.setattr(da, "_stream", lambda dev: 0)
    rng = np.random.default_rng(0)
    q, k, v, valid, slot, _ = make_case(0, ["left_pad", "full"], 96, 2, 4,
                                        64, None)
    bf = torch.bfloat16
    tq, tk, tv, tvalid, tslot = _stub(q, k, v, valid, slot)
    tq, tk, tv = (t.to(bf) for t in (tq, tk, tv))
    with pytest.raises(TypeError, match="bf16 q"):
        da.flash_decode_attention(tq.float(), tk, tv, tvalid)
    with pytest.raises(ValueError, match="hd 64, 128 or 256"):
        da.flash_decode_attention(tq[..., :32].contiguous(),
                                  tk[..., :32].contiguous(),
                                  tv[..., :32].contiguous(), tvalid)
    with pytest.raises(ValueError, match="needs slot"):
        da.flash_decode_attention(tq, tk, tv, tvalid, sliding_window=8)
    with pytest.raises(ValueError, match="sliding_window must be >= 1"):
        da.flash_decode_attention(tq, tk, tv, tvalid, sliding_window=0,
                                  slot=tslot)
    with pytest.raises(ValueError, match="valid_mask must be"):
        da.flash_decode_attention(tq, tk, tv, tvalid[:, :90].contiguous())
    with pytest.raises(ValueError, match="slot must be"):
        da.flash_decode_attention(tq, tk, tv, tvalid, sliding_window=8,
                                  slot=tslot[:1])
    assert not calls
    before = da.launches
    da.flash_decode_attention(tq, tk, tv, tvalid, return_stats=True)
    da.flash_decode_attention(tq, tk, tv, tvalid.int(), sliding_window=8,
                              slot=tslot.long())
    assert da.launches == before + 2 and len(calls) == 2
    for args, window in zip(calls, (0, 8)):
        (pq, pk, pv, pvalid, pslot, win, pout, pm, pl, b, nq, nkv, s, hd,
         sb, sh, ss, scale, drop, stream) = args
        assert (pq, pk, pv) == (tq.data_ptr(), tk.data_ptr(), tv.data_ptr())
        assert (win, b, nq, nkv, s, hd) == (window, 2, 8, 2, 96, 64)
        assert (sb, sh, ss) == tuple(tk.stride()[:3])
        assert drop == -1 and scale == 64 ** -0.5
        assert (pm is None) == (window == 8) and (pslot is None) == (not win)
    # the bool mask goes to the kernel as it is, no int32 copy
    assert calls[0][3] == tvalid.data_ptr()
    before = da.stacked_launches
    da.flash_decode_attention_stacked(tq, tk[None], tv[None], tvalid, 0)
    assert da.stacked_launches == before + 1
    assert calls[-1][1] == tk.data_ptr()


def test_chip_smoke_decode_layouts():
    """``chip_smoke``'s K4 layouts: ``decode_valid`` builds the spans (one
    interval or a list of them a stream) and ``walked_slots`` counts the
    slots of the tiles the plan walks, the ragged last tile cut at S."""
    import chip_smoke
    spans = [[(10, 60), (300, 310), (600, 700)], [(0, 64), (192, 256)],
             [(5, 6), (699, 700)], (0, 0)]
    valid = chip_smoke.decode_valid(4, 700, spans, "cpu")
    assert valid.sum(-1).tolist() == [160, 128, 2, 0]
    assert valid[0, 10] and not valid[0, 60] and not valid[3].any()
    # tiles 0, 4, 9, 10 (60 slots); 0, 3; 0, 10; none
    assert chip_smoke.walked_slots(valid) == (64 * 3 + 60) + 128 + (64 + 60)
