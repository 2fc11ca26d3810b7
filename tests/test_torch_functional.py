"""The port's ops over packed streams (``ops/functional.py``) against
the JAX package's on the same numpy inputs: chunked next-token
log-probs (L not a multiple of the chunk, temperature, logits mask) and
their gradient, entropy, masked normalization and mean.

Tolerances: fp32 on both sides, sums in different orders; log-probs of
order 5 and gradients of order 1e-2 agree to ~1e-6, so 1e-5 relative
and absolute. Normalization: the port's statistics are float64, the
JAX package's float32 (64-bit mode is off), 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realhf_tpu.models.config import TransformerConfig as JConfig
from realhf_tpu.ops import functional as JF
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.ops import functional as F

TOL = dict(rtol=1e-5, atol=1e-5)
KW = dict(n_layers=1, n_kv_heads=2, n_q_heads=2, hidden_dim=16,
          intermediate_dim=32, vocab_size=97, param_dtype="float32",
          compute_dtype="float32")


def _inputs(seed=0, s=2, l=23, h=16, v=97):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((s, l, h)).astype(np.float32)
    w = (0.3 * rng.standard_normal((h, v))).astype(np.float32)
    ids = rng.integers(0, v, size=(s, l)).astype(np.int32)
    seg = np.zeros((s, l), np.int32)
    seg[0, :9], seg[0, 9:20] = 1, 2
    seg[1, 2:] = 3
    mask = rng.random((s, l, v)) > 0.3
    mask[np.arange(s)[:, None], np.arange(l)[None],
         np.concatenate([ids[:, 1:], ids[:, :1]], 1)] = True
    return hidden, w, ids, seg, mask


@pytest.mark.parametrize("kw", [dict(), dict(temperature=0.7),
                                dict(masked=True)],
                         ids=["plain", "temperature", "logits_mask"])
def test_shifted_logprobs_and_gradient(kw):
    """chunk 10 over L 23: two full chunks and a ragged one."""
    hidden, w, ids, seg, mask = _inputs()
    temp = kw.get("temperature", 1.0)
    mask = mask if kw.get("masked") else None
    jcfg, tcfg = JConfig(**KW), TransformerConfig(**KW)
    g = np.random.default_rng(1).standard_normal(ids.shape) \
        .astype(np.float32)

    def jloss(h, wh):
        lp = JF.shifted_logprobs_from_hidden(
            jcfg, {"head": {"w": wh}}, h, jnp.asarray(ids), jnp.asarray(seg),
            chunk=10, temperature=temp,
            logits_mask=None if mask is None else jnp.asarray(mask))
        return (lp * g).sum(), lp

    (_, jlp), jgrads = jax.value_and_grad(jloss, argnums=(0, 1),
                                          has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(w))
    th = torch.from_numpy(hidden).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    lp = F.shifted_logprobs_from_hidden(
        tcfg, {"head": {"w": tw}}, th, torch.from_numpy(ids),
        torch.from_numpy(seg), chunk=10, temperature=temp,
        logits_mask=None if mask is None else torch.from_numpy(mask))
    (lp * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jlp), **TOL)
    assert np.all(lp.detach().numpy()[seg == 0] == 0)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgrads[0]), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgrads[1]), **TOL)


def test_entropy_from_hidden():
    hidden, w, *_ = _inputs(seed=2)
    want = JF.entropy_from_hidden(JConfig(**KW), {"head": {"w": w}},
                                  jnp.asarray(hidden), chunk=10,
                                  temperature=1.3)
    got = F.entropy_from_hidden(TransformerConfig(**KW),
                                {"head": {"w": torch.from_numpy(w)}},
                                torch.from_numpy(hidden), chunk=10,
                                temperature=1.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("unbiased", [True, False])
def test_masked_normalization_and_mean(masked, unbiased):
    rng = np.random.default_rng(3)
    x = (3 + 2 * rng.standard_normal((4, 33))).astype(np.float32)
    m = rng.random((4, 33)) > 0.4 if masked else None
    want = JF.masked_normalization(
        jnp.asarray(x), None if m is None else jnp.asarray(m),
        unbiased=unbiased)
    got = F.masked_normalization(
        torch.from_numpy(x), None if m is None else torch.from_numpy(m),
        unbiased=unbiased)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if masked:
        np.testing.assert_allclose(
            float(F.masked_mean(torch.from_numpy(x), torch.from_numpy(m))),
            float(JF.masked_mean(jnp.asarray(x), jnp.asarray(m))), rtol=1e-6)
