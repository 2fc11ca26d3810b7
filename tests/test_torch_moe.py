"""The port's mixture-of-experts ops (``ops/moe.py``) against the JAX
package's on the same numpy inputs: routing (aux_loss / none / sinkhorn
at top-1 and top-2), sinkhorn, the load-balancing and z losses over a
valid mask, and the MoE layer in its three dispatch modes (ragged,
dense, capacity) with its losses, forward and gradients.

Tolerances: fp32 on the CPU on both sides, sums in other orders. Outputs
and losses of order 1 agree to ~1e-6 relative: 1e-5. Gradients go
through the softmax, the experts and the losses: 1e-4, relative to each
leaf's largest element. Routing indices must be equal: the inputs are
drawn so no two experts tie.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realhf_tpu.models.config import MoEConfig as JMoE
from realhf_tpu.models.config import TransformerConfig as JConfig
from realhf_tpu.ops import moe as jmoe
from realhf_tpu_torch.models.config import MoEConfig, TransformerConfig
from realhf_tpu_torch.ops import moe

RTOL = 1e-5
GRAD_TOL = 1e-4
BASE = dict(n_layers=1, n_kv_heads=2, n_q_heads=4, hidden_dim=32,
            intermediate_dim=48, vocab_size=64, apply_rotary=True,
            layer_norm_type="rms", mlp_type="moe", use_attention_bias=False,
            use_attn_proj_bias=False, use_mlp_bias=False,
            activation_function="silu", param_dtype="float32",
            compute_dtype="float32")


def _cfgs(**moe_kw):
    kw = dict(dict(num_experts=4, top_k=2, aux_loss_coeff=0.01,
                   z_loss_coeff=0.001), **moe_kw)
    return (JConfig(**BASE, moe=JMoE(**kw)),
            TransformerConfig(**BASE, moe=MoEConfig(**kw)))


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("routing", ["aux_loss", "none", "sinkhorn"])
def test_router_probs_match_jax(routing, top_k):
    logits = np.random.default_rng(top_k).standard_normal(
        (40, 6)).astype(np.float32) * 2
    jcfg = JMoE(num_experts=6, top_k=top_k, routing_type=routing)
    tcfg = MoEConfig(num_experts=6, top_k=top_k, routing_type=routing)
    jp, ji = jmoe.router_probs(jcfg, jnp.asarray(logits))
    tp, ti = moe.router_probs(tcfg, torch.from_numpy(logits))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL)


def test_sinkhorn_and_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((24, 4)).astype(np.float32)
    np.testing.assert_allclose(
        moe.sinkhorn(torch.from_numpy(logits)).numpy(),
        np.asarray(jmoe.sinkhorn(jnp.asarray(logits))), rtol=RTOL,
        atol=1e-6)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
    idx = np.argsort(-probs, -1)[:, :2].astype(np.int32)
    valid = (rng.random(24) > 0.3).astype(np.float32)
    for v in (None, valid):
        jv = None if v is None else jnp.asarray(v)
        tv = None if v is None else torch.from_numpy(v)
        np.testing.assert_allclose(
            float(moe.load_balancing_loss(torch.from_numpy(probs),
                                          torch.from_numpy(idx).long(), 4,
                                          2, tv)),
            float(jmoe.load_balancing_loss(jnp.asarray(probs),
                                           jnp.asarray(idx), 4, 2, jv)),
            rtol=RTOL)
        np.testing.assert_allclose(
            float(moe.z_loss(torch.from_numpy(logits), tv)),
            float(jmoe.z_loss(jnp.asarray(logits), jv)), rtol=RTOL)


MODES = {
    "ragged": dict(),
    "dense": dict(use_grouped_gemm=False),
    "capacity_ample": dict(capacity_factor=4.0),
    "capacity_drops": dict(capacity_factor=0.5),
    "sinkhorn_top1": dict(routing_type="sinkhorn", top_k=1),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_moe_layer_matches_jax(mode):
    """Output, aux losses and the gradients of sum(out^2) + aux with
    respect to the router, the expert weights and x, over a batch whose
    valid mask leaves padding out."""
    jcfg, tcfg = _cfgs(**MODES[mode])
    assert moe.ragged_dispatch_enabled(tcfg) == (
        mode in ("ragged", "sinkhorn_top1"))
    rng = np.random.default_rng(len(mode))
    e, h, f = 4, BASE["hidden_dim"], BASE["intermediate_dim"]
    m = {"router": rng.standard_normal((h, e)) * 0.3,
         "wg": rng.standard_normal((e, h, f)) * 0.2,
         "wu": rng.standard_normal((e, h, f)) * 0.2,
         "wd": rng.standard_normal((e, f, h)) * 0.2}
    m = {k: v.astype(np.float32) for k, v in m.items()}
    x = rng.standard_normal((2, 12, h)).astype(np.float32)
    valid = rng.random((2, 12)) > 0.25

    def jloss(m_, x_):
        out, aux = jmoe.moe_mlp_with_losses(jcfg, m_, x_,
                                            valid_mask=jnp.asarray(valid))
        return (out ** 2).sum() + sum(aux.values()), (out, aux)

    (_, (jout, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, m), jnp.asarray(x))
    tm = {k: torch.from_numpy(v).requires_grad_() for k, v in m.items()}
    tx = torch.from_numpy(x).requires_grad_()
    tout, taux = moe.moe_mlp_with_losses(tcfg, tm, tx,
                                         valid_mask=torch.from_numpy(valid))
    ((tout ** 2).sum() + sum(taux.values())).backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=1e-6)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]),
                                   rtol=RTOL, err_msg=k)
    for k in m:
        want = np.asarray(jg[0][k])
        np.testing.assert_allclose(tm[k].grad.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max(),
                                   err_msg=k)
    want = np.asarray(jg[1])
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=0,
                               atol=GRAD_TOL * np.abs(want).max())
    if mode == "capacity_drops":  # some (token, expert) pairs were dropped
        _, full = _cfgs(capacity_factor=None, use_grouped_gemm=False)
        dense, _ = moe.moe_mlp_with_losses(full, tm, tx,
                                           valid_mask=torch.from_numpy(valid))
        assert not torch.allclose(dense, tout)


def test_ragged_counts_one_host_read_a_call_and_raises_what_is_not_wired():
    _, tcfg = _cfgs()
    rng = np.random.default_rng(3)
    m = {"router": torch.randn(32, 4), "wg": torch.randn(4, 32, 48),
         "wu": torch.randn(4, 32, 48), "wd": torch.randn(4, 48, 32)}
    before = moe.host_reads
    moe.moe_mlp_with_losses(tcfg, m, torch.from_numpy(
        rng.standard_normal((1, 5, 32)).astype(np.float32)))
    assert moe.host_reads == before + 1
    cfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, input_jitter_eps=0.01))
    with pytest.raises(NotImplementedError, match="input_jitter_eps"):
        moe.moe_mlp_with_losses(cfg, m, torch.zeros(1, 2, 32))
    # expert parallelism is a layout: one shard holding every expert
    # computes what it computed without it
    x = torch.from_numpy(rng.standard_normal((2, 3, 32)).astype(np.float32))
    cfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, expert_parallel=True))
    for a, b in zip(moe.moe_mlp_with_losses(cfg, m, x),
                    moe.moe_mlp_with_losses(tcfg, m, x)):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            a, b = list(a.values()), list(b.values())
        for u, v in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b]):
            assert torch.equal(u, v)
