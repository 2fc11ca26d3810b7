"""Sliding-window attention in the port's flash attention (K1, K2/K3):
the plain forward and backward the kernels are held to on the card,
against the JAX package's XLA path with the same window (the JAX Pallas
kernel has none; its windowed prefill runs there); the tile walk with a
window (``visited_key_tiles`` and ``visited_q_tiles``) against a
brute-force count; and the CUDA wrappers, on tensors that say they are
on the card, handing the window to every kernel.

Tolerances: fp32 on the CPU on both sides, sums in different orders
(blocked softmax against one softmax): 2e-4, as in
``test_torch_flash_attention.py``; a masking fault is an O(1) error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realhf_tpu.ops.attention import packed_attention_xla
from realhf_tpu_torch.ops import flash_attention as fa
from realhf_tpu_torch.ops.attention import packed_attention
from test_torch_flash_attention import make_inputs

TOL = dict(rtol=2e-4, atol=2e-4)


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [1, 17, 64, 1000])
def test_plain_forward_and_backward_match_jax_xla(window, causal):
    """o on valid rows, and dq/dk/dv of sum(o * do) with do zero on
    padding rows (the XLA path spreads a padding row over every key),
    through ``FlashAttentionFn`` (the kernels' wiring on CPU tensors)."""
    rng = np.random.default_rng(window)
    q, k, v, seg = make_inputs(rng, l=150, nq=4, nkv=2, hd=16)
    do = rng.standard_normal(q.shape).astype(np.float32) \
        * (seg != 0)[:, :, None, None]

    def jax_loss(q_, k_, v_):
        o = packed_attention_xla(q_, k_, v_, jnp.asarray(seg),
                                 causal=causal, sliding_window=window)
        return (o * do).sum(), o

    (_, o_j), g_j = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    o = fa.FlashAttentionFn.apply(tq, tk, tv, torch.from_numpy(seg), causal,
                                  None, window)
    (o * torch.from_numpy(do)).sum().backward()
    valid = seg != 0
    np.testing.assert_allclose(o.detach().numpy()[valid],
                               np.asarray(o_j)[valid], **TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), g_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # a window of L or more is no window
    if window >= q.shape[1]:
        full, _ = fa.flash_attention(*_t(q, k, v, seg), causal=causal)
        np.testing.assert_array_equal(o.detach().numpy(), full.numpy())


def _brute_visited(seg, causal, window, bq, bk):
    """[B, q tiles, key tiles]: whether the tile pair holds a (query,
    key) pair that the mask allows."""
    mask = fa.segment_mask(seg, seg, causal, window)
    b, lq, lk = mask.shape
    nq, nk = -(-lq // bq), -(-lk // bk)
    pad = torch.zeros((b, nq * bq, nk * bk), dtype=torch.bool)
    pad[:, :lq, :lk] = mask
    return pad.reshape(b, nq, bq, nk, bk).any(4).any(2)


@pytest.mark.parametrize("window", [1, 24, 64, 100, 300])
@pytest.mark.parametrize("layout", ["one_segment", "packed"])
def test_tile_walk_with_window_against_brute_force(layout, window):
    """On one segment the rule is exact: it visits just the tile pairs
    that hold an allowed pair. On packed segments it is sound: it visits
    every such pair. K3's walk is K1's transposed, and the pairs counted
    (``chip_smoke.walked_pairs``) are at least those allowed."""
    import chip_smoke
    rng = np.random.default_rng(window)
    L = 700
    if layout == "one_segment":
        seg = torch.ones((1, L), dtype=torch.int32)
    else:
        seg = torch.from_numpy(make_inputs(rng, b=2, l=L, n_segs=4)[3])
    for causal in (True, False):
        want = _brute_visited(seg, causal, window, fa.K1_BQ, fa.K1_BK)
        got = fa.visited_key_tiles(seg, causal, window=window)
        if layout == "one_segment":
            assert torch.equal(got, want)
        else:
            assert not (want & ~got).any()
        assert torch.equal(fa.visited_q_tiles(seg, causal, window=window),
                           got.transpose(1, 2))
        allowed = chip_smoke.allowed_pairs(seg, causal, window)
        walked = chip_smoke.walked_pairs(seg, causal, window)
        assert walked == chip_smoke.dkv_walked_pairs(seg, causal, window)
        assert allowed <= walked
        if layout == "one_segment" and causal:
            # a window of w over L keys leaves each row min(w, row + 1)
            assert allowed == sum(min(window, i + 1) for i in range(L))


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: drives the CUDA
    wrappers without a device."""

    @property
    def is_cuda(self):
        return True


def test_cuda_wrappers_hand_the_window_to_every_kernel(monkeypatch):
    calls = []

    def kernel(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(fa, "_kernel", kernel)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    q, k, v, seg = make_inputs(np.random.default_rng(0), l=64, hd=64)
    tq, tk, tv = (torch.from_numpy(x).bfloat16().as_subclass(_OnCard)
                  for x in (q, k, v))
    tseg = torch.from_numpy(seg).as_subclass(_OnCard)
    with torch.no_grad():
        for window, want in ((None, -1), (300, 300)):
            calls.clear()
            packed_attention(tq, tk, tv, tseg, sliding_window=window)
            o = torch.zeros_like(tq)
            lse = torch.zeros((2, 4, 64), dtype=torch.float32).as_subclass(
                _OnCard)
            fa.flash_attention_bwd(tq, tk, tv, tseg, o, lse, tq,
                                   window=window)
            names = [c[0] for c in calls]
            assert names == ["flash_fwd_bf16", "flash_bwd_dq_bf16",
                             "flash_bwd_dkv_bf16"]
            # ... B, L, nq, nkv, hd, scale, causal, window, stream
            assert all(c[1][-2] == want and c[1][-3] == 1 for c in calls)
        with pytest.raises(ValueError, match="window must be >= 1"):
            fa.flash_attention(tq, tk, tv, tseg, window=0)
        with pytest.raises(NotImplementedError, match="soft-cap"):
            packed_attention(tq, tk, tv, tseg, logits_soft_cap=5.0)
