"""The port's flash-attention backward on the CPU: the plain version of
the backward kernels against the JAX package's Pallas backward in
interpret mode, ``FlashAttentionFn``'s gradients against autograd and
``jax.grad``, and the guards of the CUDA wrappers.

Tolerances: fp32 on both sides, sums in different orders (the Pallas
kernel walks 64-row blocks, the plain version one einsum), so values of
order 1 agree to ~1e-5. 2e-4 leaves room without hiding a masking or
indexing fault, which shows up as O(1) errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from realhf_tpu.ops import flash_attention as jfa
from realhf_tpu.ops.attention import packed_attention_xla
from realhf_tpu_torch.ops import flash_attention as fa
from realhf_tpu_torch.ops.attention import packed_attention
from test_torch_flash_attention import make_inputs

TOL = dict(rtol=2e-4, atol=2e-4)


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("nq,nkv", [(4, 2), (4, 4)])
def test_bwd_plain_matches_jax_kernel_interpret(causal, nq, nkv):
    """dq, dk, dv from the same saved o and lse: multi-segment rows with
    padded tails and one all-padding row."""
    rng = np.random.default_rng(10)
    q, k, v, seg = make_inputs(rng, nq=nq, nkv=nkv, pad_rows=(1,))
    do = rng.standard_normal(q.shape).astype(np.float32)
    scale = 32 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        o, lse = jfa._flash_fwd(*map(jnp.asarray, (q, k, v, seg)), scale,
                                causal, 64, 64)
        want = jfa._flash_bwd((*map(jnp.asarray, (q, k, v, seg)), o, lse),
                              jnp.asarray(do), scale, causal, 64, 64)[:3]
    got = fa.flash_attention_bwd_plain(
        *_t(q, k, v, seg, np.array(o), np.array(lse)[..., 0], do),
        causal=causal, scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)
    # the all-padding row's gradients are exactly zero, never NaN
    for g in got:
        assert np.all(g.numpy()[1] == 0.0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("nq,nkv", [(4, 2), (6, 6)])
def test_function_gradients_match_autograd_and_jax(causal, nq, nkv):
    """FlashAttentionFn on CPU tensors (forward and backward plain
    versions through the Function's wiring) against autograd through
    ``flash_attention_plain`` and ``jax.grad`` of the XLA path. The loss
    weights padding rows by 0: the XLA path averages a masked row where
    the kernels return 0."""
    rng = np.random.default_rng(11)
    q, k, v, seg = make_inputs(rng, l=96, nq=nq, nkv=nkv, pad_rows=(0,))
    w = (rng.standard_normal(q.shape) * (seg != 0)[..., None, None]
         ).astype(np.float32)

    def grads(fn):
        ts = [t.requires_grad_() for t in _t(q, k, v)]
        (fn(*ts) * torch.from_numpy(w)).sum().backward()
        return [t.grad.numpy() for t in ts]

    segt = torch.from_numpy(seg)
    got = grads(lambda a, b, c: fa.FlashAttentionFn.apply(a, b, c, segt,
                                                          causal, None))
    ref = grads(lambda a, b, c: fa.flash_attention_plain(
        a, b, c, segt, causal=causal)[0])
    jref = jax.grad(lambda a, b, c: (packed_attention_xla(
        a, b, c, jnp.asarray(seg), causal=causal) * w).sum(),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for name, g, r, j in zip("qkv", got, ref, jref):
        np.testing.assert_allclose(g, r, **TOL, err_msg=f"d{name} autograd")
        np.testing.assert_allclose(g, np.asarray(j), **TOL,
                                   err_msg=f"d{name} jax")


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: drives the CUDA
    wrappers' checks without a device."""

    @property
    def is_cuda(self):
        return True


def test_bare_wrapper_refuses_inputs_that_need_a_gradient(monkeypatch):
    launched = []
    monkeypatch.setattr(fa, "_launch", lambda *a, **kw: launched.append(a))
    q, k, v, seg = make_inputs(np.random.default_rng(12), l=64)
    q, k, v = (t.as_subclass(_OnCard).requires_grad_() for t in _t(q, k, v))
    seg = torch.from_numpy(seg).as_subclass(_OnCard)
    with pytest.raises(RuntimeError, match="no gradient"):
        fa.flash_attention(q, k, v, seg)
    with torch.no_grad():  # no gradient asked: on to the kernel's checks
        with pytest.raises(TypeError, match="bf16"):
            fa.flash_attention(q, k, v, seg)
    assert not launched


def test_cpu_tensors_never_move_a_launch_counter():
    q, k, v, seg = make_inputs(np.random.default_rng(13), l=64)
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    ts = [t.requires_grad_() for t in _t(q, k, v)]
    fa.FlashAttentionFn.apply(*ts, torch.from_numpy(seg), True, None) \
        .sum().backward()
    packed_attention(*_t(q, k, v, seg)).sum()
    qt, kt, vt, segt = _t(q, k, v, seg)
    o, lse = fa.flash_attention(qt, kt, vt, segt)
    delta = fa.attention_delta(o, o)
    fa.flash_bwd_dq(qt, kt, vt, segt, o, lse, delta)
    fa.flash_bwd_dkv(qt, kt, vt, segt, o, lse, delta)
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == before
