"""The ring at head dim 256 (Gemma's) on the CPU: the port's ring entry
and the CUDA members' schedule with plain rounds against the JAX
package's fused ring kernel in Pallas interpret mode, and the
differentiable ring (``RingAttentionFn``: the forward's lse, then the
plain K2/K3 rounds with the keys' ids, global offsets and fp32
partials) against ``jax.vjp`` of the JAX package's ring; then a
Gemma-shaped model (one KV head of 256) at c2 and d1t2c2 against the
JAX engine at the same layout: log-probs and two train steps.

Inputs come from a numpy seed, fp32 on both sides. Tolerances: the
ring's outputs and gradients 2e-5 absolute and relative (two fp32
softmax computations that sum in other orders, values of order 1;
``test_torch_ring_backward.py``'s); the engines' log-probs 1e-5, loss
1e-6 and grad norm 1e-5 relative, weights 1e-5 absolute after two AdamW
steps (``test_torch_ctx_train.py``'s).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from realhf_tpu.ops import ring_attention_fused as jrf
from realhf_tpu_torch.ops import ring_attention_fused as rf
from test_torch_ctx_train import _jax_run, _port_run
from test_torch_gemma import GEMMA
from test_torch_ring_attention import _port, _schedule
from test_torch_ring_backward import _jax_ring, _port_ring

TOL = dict(rtol=2e-5, atol=2e-5)
HD = 256


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops over several members: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, nq, nkv, b=2, l=64):
    """q/k/v/do [b, l, ., 256] and segment ids: records that cross the
    shard boundaries of 2 and 4 members (cuts at 13, 37, 50), trailing
    padding, and a second stream of padding only (an empty row)."""
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, l, nq, HD)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, l, nkv, HD)).astype(np.float32)
            for _ in range(2))
    seg = np.zeros((b, l), np.int32)
    seg[0, :13], seg[0, 13:37], seg[0, 37:50], seg[0, 50:60] = 1, 2, 3, 4
    return q, k, v, seg, do


#: (q heads, KV heads, window): GQA groups 1 and 8, a window
CASES = {"group1": (2, 2, None), "group8": (8, 1, None),
         "group8_window20": (8, 1, 20)}


@functools.lru_cache(maxsize=None)
def _fused_interpret(case):
    nq, nkv, window = CASES[case]
    q, k, v, seg, _ = _inputs(len(case), nq, nkv)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("ctx",))
    out = jax.jit(lambda *a: jrf.ring_attention_fused(
        *a, mesh=mesh, interpret=True, sliding_window=window))(
            *map(jnp.asarray, (q, k, v, seg)))
    return (q, k, v, seg), np.asarray(out)


@pytest.mark.parametrize("case", ["group1", "group8_window20"])
def test_ring_at_hd256_matches_jax_fused_interpret(case):
    """The entry on CPU members (the plain ring) and the CUDA schedule
    with plain rounds, at 4 members, against the Pallas kernel; the empty
    row's outputs exactly 0."""
    inputs, want = _fused_interpret(case)
    window = CASES[case][2]
    got = _port(rf.ring_attention_fused, inputs, 4, sliding_window=window)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        _schedule(*inputs, sliding_window=window), want, **TOL)
    assert not got[1].any()


@pytest.mark.parametrize("case,n", [("group1", 2), ("group8", 4),
                                    ("group8_window20", 4)])
def test_ring_vjp_at_hd256_matches_jax_vjp(case, n):
    """``RingAttentionFn``'s forward and backward against ``jax.vjp`` of
    the JAX ring; the empty row's gradients exactly 0, never NaN."""
    nq, nkv, window = CASES[case]
    args = _inputs(len(case) + n, nq, nkv)
    got = _port_ring(*args, n, window)
    want = _jax_ring(*args, n, window)
    valid = args[3] != 0
    np.testing.assert_allclose(got[0][valid], want[0][valid], **TOL)
    for g, w, name in zip(got[1:], want[1:], ("dq", "dk", "dv")):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
        assert not g[1].any(), name


@pytest.fixture(scope="module")
def gemma_weights():
    from realhf_tpu.models import transformer as JT
    from realhf_tpu.models.config import TransformerConfig as JConfig
    return jax.tree.map(np.asarray, JT.init_params(
        JConfig(**GEMMA), jax.random.PRNGKey(2)))


@pytest.mark.parametrize("layout", ["c2", "d1t2c2"])
def test_gemma_shaped_model_at_layout_matches_jax(gemma_weights, layout,
                                                  monkeypatch):
    """Gemma's single KV head of 256 on the ring (replicated over t at
    d1t2c2, each member's ring carrying it): ``forward_logprobs`` and two
    train steps against the JAX engine at the same layout."""
    import test_torch_ctx_train as ct
    monkeypatch.setattr(ct, "CFG", dict(GEMMA, compute_dtype="float32"))
    ids, seg = ct._batch()
    ids = ids % GEMMA["vocab_size"]
    jlp, jsteps, jw = _jax_run(layout, gemma_weights, ids, seg)
    lp, steps, w, _ = _port_run(layout, gemma_weights, ids, seg)
    np.testing.assert_allclose(lp, jlp, rtol=1e-5, atol=1e-5)
    for got, want in zip(steps, jsteps):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-5)
    for a, b in zip(jax.tree.leaves(w), jax.tree.leaves(jw)):
        np.testing.assert_allclose(a, b, atol=1e-5)
