"""The port's plain flash-decode (what the CUDA kernel computes, run on
the CPU) against the JAX package's Pallas decode kernels in interpret
mode, per-layer and stacked, and the port's plain decode path against
the JAX XLA decode path.

Tolerances: fp32 on both sides, summed in different orders; 2e-5 as in
the JAX package's own decode-kernel tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realhf_tpu.ops.attention import decode_attention as jax_decode_xla
from realhf_tpu.ops.decode_attention import (
    flash_decode_attention as jax_flash_decode,
    flash_decode_attention_stacked as jax_flash_decode_stacked,
)
from realhf_tpu_torch.ops import decode_attention as da
from realhf_tpu_torch.ops.attention import decode_attention

TOL = dict(atol=2e-5, rtol=2e-5)


def make_inputs(rng, b=4, s=96, nq=8, nkv=2, hd=64, spans=None, nl=None):
    q = rng.standard_normal((b, nq, hd)).astype(np.float32)
    shape = ((nl,) if nl else ()) + (b, nkv, s, hd)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    valid = np.zeros((b, s), bool)
    if spans is None:
        spans = [(0, int(n)) for n in rng.integers(1, s + 1, size=b)]
    for i, (lo, hi) in enumerate(spans):  # low invalid slots = left pad
        valid[i, lo:hi] = True
    return q, k, v, valid


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("nq,nkv,hd", [(8, 2, 64), (4, 4, 64), (8, 1, 64),
                                       (4, 1, 256)],
                         ids=["gqa4", "mha", "mqa", "gqa4_hd256"])
def test_plain_matches_jax_kernel_with_stats(nq, nkv, hd):
    rng = np.random.default_rng(0)
    spans = [(10, 90), (0, 96), (0, 0), (95, 96)]  # stream 2 is empty
    q, k, v, valid = make_inputs(rng, nq=nq, nkv=nkv, hd=hd, spans=spans)
    ref = jax_flash_decode(*_j(q, k, v, valid), block_k=32, interpret=True,
                           return_stats=True)
    got = da.flash_decode_attention(*_t(q, k, v, valid), return_stats=True)
    for g, r, name in zip(got, ref, ("out", "m", "l")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)
    assert np.all(got[0].numpy()[2] == 0.0)  # empty stream -> 0


def test_ragged_s_and_sliding_window():
    rng = np.random.default_rng(1)
    q, k, v, valid = make_inputs(rng, s=70, spans=[(0, 40), (5, 60),
                                                   (0, 70), (0, 8)])
    slot = np.asarray([39, 59, 69, 7], np.int32)
    for window in (None, 16):
        ref = jax_flash_decode(*_j(q, k, v, valid), sliding_window=window,
                               slot=jnp.asarray(slot), block_k=32,
                               interpret=True)
        got = da.flash_decode_attention(*_t(q, k, v, valid),
                                        sliding_window=window,
                                        slot=torch.from_numpy(slot))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("layer", [0, 2])
def test_stacked_matches_jax_stacked_kernel(layer):
    rng = np.random.default_rng(2)
    q, k, v, valid = make_inputs(rng, s=64, nl=3)
    ref = jax_flash_decode_stacked(*_j(q, k, v, valid),
                                   jnp.int32(layer), interpret=True,
                                   return_stats=True)
    got = da.flash_decode_attention_stacked(*_t(q, k, v, valid), layer,
                                            return_stats=True)
    for g, r, name in zip(got, ref, ("out", "m", "l")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("kw", [dict(), dict(scale=0.2),
                                dict(logits_soft_cap=3.0),
                                dict(sliding_window=9)],
                         ids=["default", "scale", "softcap", "window"])
def test_dispatcher_plain_matches_jax_xla(kw):
    """On CPU tensors the dispatcher runs the port of the XLA path."""
    rng = np.random.default_rng(3)
    q, k, v, valid = make_inputs(rng, spans=[(3, 50), (0, 96), (0, 1),
                                             (20, 21)])
    slot = np.asarray([49, 95, 0, 20], np.int32)
    extra = dict(slot=slot) if "sliding_window" in kw else {}
    ref = jax_decode_xla(*_j(q, k, v, valid), **kw,
                         **{n: jnp.asarray(a) for n, a in extra.items()})
    got = decode_attention(*_t(q, k, v, valid), **kw,
                           **{n: torch.from_numpy(a)
                              for n, a in extra.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_window_needs_slots_and_cpu_never_launches():
    rng = np.random.default_rng(4)
    q, k, v, valid = make_inputs(rng)
    with pytest.raises(ValueError):
        da.window_keep(torch.from_numpy(valid), 4, None)
    before = (da.launches, da.stacked_launches)
    da.flash_decode_attention(*_t(q, k, v, valid))
    assert (da.launches, da.stacked_launches) == before
