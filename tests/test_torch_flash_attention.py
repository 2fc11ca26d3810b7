"""The port's plain flash-attention forward (what the CUDA kernel
computes, run on the CPU) against the JAX package: its Pallas kernel in
interpret mode (o and lse) and its XLA path.

Tolerances: everything is fp32 on the CPU; the two sides sum in
different orders (blocked online softmax against one softmax), so
values agree to ~1e-5. 2e-4 leaves room without hiding a masking or
indexing fault, which shows up as O(1) errors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from realhf_tpu.ops import flash_attention as jfa
from realhf_tpu.ops.attention import packed_attention_xla
from realhf_tpu_torch.ops import flash_attention as fa
from realhf_tpu_torch.ops.attention import (
    packed_attention,
    packed_attention_plain,
)

TOL = dict(rtol=2e-4, atol=2e-4)


def make_inputs(rng, b=2, l=128, nq=4, nkv=2, hd=32, n_segs=3,
                pad_rows=()):
    q = rng.standard_normal((b, l, nq, hd)).astype(np.float32)
    k = rng.standard_normal((b, l, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, l, nkv, hd)).astype(np.float32)
    seg = np.zeros((b, l), np.int32)
    for bi in range(b):
        if bi in pad_rows:
            continue
        cuts = np.sort(rng.choice(np.arange(1, l - 1), n_segs - 1,
                                  replace=False))
        cuts = np.concatenate([[0], cuts, [l]])
        for s in range(n_segs):
            seg[bi, cuts[s]:cuts[s + 1]] = s + 1
        seg[bi, l - int(rng.integers(1, l // 4)):] = 0  # padded tail
    return q, k, v, seg


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("nq,nkv", [(4, 2), (4, 4)])
def test_plain_matches_jax_kernel_interpret(causal, nq, nkv):
    rng = np.random.default_rng(0)
    q, k, v, seg = make_inputs(rng, nq=nq, nkv=nkv, pad_rows=(1,))
    scale = 32 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        o_j, lse_j = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(seg), scale,
                                    causal, 64, 64)
    o, lse = fa.flash_attention(*_t(q, k, v, seg), causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[..., 0],
                               **TOL)
    # the all-padding row: o = 0 and lse = NEG_INF exactly
    assert np.all(o.numpy()[1] == 0.0)
    assert np.all(lse.numpy()[1] == fa.NEG_INF)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("l", [200, 128])
def test_plain_matches_xla_any_length(causal, l):
    """L need not be a multiple of 128 (the kernel masks its ragged
    tile); checked against the XLA path, which takes any L."""
    rng = np.random.default_rng(1)
    q, k, v, seg = make_inputs(rng, l=l, nq=6, nkv=2)
    ref = np.asarray(packed_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        causal=causal))
    o, _ = fa.flash_attention(*_t(q, k, v, seg), causal=causal)
    valid = seg != 0  # rows of padding are unspecified on the XLA path
    np.testing.assert_allclose(o.numpy()[valid], ref[valid], **TOL)


@pytest.mark.parametrize("kw", [
    dict(), dict(causal=False), dict(scale=0.3),
    dict(logits_soft_cap=5.0), dict(sliding_window=17)],
    ids=["default", "noncausal", "scale", "softcap", "window"])
def test_packed_attention_plain_matches_xla(kw):
    """The CPU dispatch target is the port of the XLA path, all rows."""
    rng = np.random.default_rng(2)
    q, k, v, seg = make_inputs(rng, l=96, nq=4, nkv=2, pad_rows=(0,))
    ref = np.asarray(packed_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        **kw))
    got = packed_attention(*_t(q, k, v, seg), **kw)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_array_equal(
        got.numpy(), packed_attention_plain(*_t(q, k, v, seg), **kw).numpy())


def test_cpu_tensors_never_launch_the_kernel():
    rng = np.random.default_rng(3)
    q, k, v, seg = make_inputs(rng, l=64)
    before = fa.launches
    fa.flash_attention(*_t(q, k, v, seg))
    packed_attention(*_t(q, k, v, seg))
    assert fa.launches == before
