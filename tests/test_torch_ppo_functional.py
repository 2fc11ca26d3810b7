"""The port's PPO math (``ops/gae.py``, ``interfaces/ppo_functional.py``)
against the JAX package's on the same numpy inputs made from a seed.

Tolerances: fp32 on the CPU on both sides. GAE is a recurrence of up to
40 fp32 multiply-adds per sequence with values of order 1: 2e-6
absolute. The losses are fp32 means over ~100 masked terms of order 1
(the actor's cancel to ~1e-2), and their gradients are of order 1e-2:
1e-6 relative or 1e-7 absolute. The
reward builders, KL controllers and running statistics are the same
numpy / float64 expressions on both sides: equal to 1e-12 or exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realhf_tpu.interfaces import ppo_functional as jpf
from realhf_tpu.ops.gae import gae_packed_numpy as jax_gae
from realhf_tpu_torch.interfaces import ppo_functional as pf
from realhf_tpu_torch.ops.gae import gae_packed_numpy


@pytest.mark.parametrize("gamma,lam", [(1.0, 1.0), (0.99, 0.95), (0.9, 0.5)])
def test_gae_matches_jax(gamma, lam):
    rng = np.random.default_rng(0)
    lens = rng.integers(1, 40, size=7)
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    rewards = rng.standard_normal(cu[-1]).astype(np.float32)
    values = rng.standard_normal(cu[-1] + len(lens)).astype(np.float32)
    bootstrap = np.array([0, 1, 1, 0, 1, 0, 0], np.float32)
    want_adv, want_ret = jax_gae(rewards, values, cu, bootstrap, gamma, lam)
    adv, ret = gae_packed_numpy(rewards, values, cu, bootstrap, gamma, lam)
    assert adv.dtype == ret.dtype == np.float32
    np.testing.assert_allclose(adv, want_adv, rtol=0, atol=2e-6)
    np.testing.assert_allclose(ret, want_ret, rtol=0, atol=2e-6)


def test_gae_bootstrap_keeps_or_zeroes_the_last_value():
    """One sequence of one reward: A = r + gamma * b * V1 - V0."""
    r, v = np.array([0.5], np.float32), np.array([0.25, 2.0], np.float32)
    cu = np.array([0, 1])
    for b, want in ((0.0, 0.25), (1.0, 0.25 + 0.9 * 2.0)):
        adv, ret = gae_packed_numpy(r, v, cu, np.array([b]), 0.9, 0.7)
        np.testing.assert_allclose(adv, [want], rtol=1e-6)
        np.testing.assert_allclose(ret, [want + 0.25], rtol=1e-6)


def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    shape = (3, 48)
    return dict(
        new=(-rng.random(shape) * 3).astype(np.float32),
        old=(-rng.random(shape) * 3).astype(np.float32),
        adv=rng.standard_normal(shape).astype(np.float32),
        target=rng.standard_normal(shape).astype(np.float32),
        mask=rng.random(shape) > 0.3)


def test_actor_loss_and_gradient_match_jax():
    x = _loss_inputs(1)
    # keep the ratios near the clip range so that both branches occur
    x["new"] = x["old"] + 0.4 * x["adv"]

    def jloss(lp):
        return jpf.actor_loss_fn(lp, jnp.asarray(x["old"]),
                                 jnp.asarray(x["adv"]), 0.2,
                                 jnp.asarray(x["mask"]))

    (want, want_stats), want_grad = jax.value_and_grad(
        jloss, has_aux=True)(jnp.asarray(x["new"]))
    lp = torch.from_numpy(x["new"]).requires_grad_(True)
    loss, stats = pf.actor_loss_fn(
        lp, torch.from_numpy(x["old"]), torch.from_numpy(x["adv"]), 0.2,
        torch.from_numpy(x["mask"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6,
                               atol=1e-7)
    assert set(stats) == set(want_stats)
    for k in want_stats:
        assert not stats[k].requires_grad
        np.testing.assert_allclose(stats[k].item(), float(want_stats[k]),
                                   rtol=1e-6, err_msg=k)
    assert 0 < stats["clip_ratio"].item() < 1
    np.testing.assert_allclose(lp.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-6, atol=1e-7)
    assert not lp.grad.numpy()[~x["mask"]].any()


@pytest.mark.parametrize("kind", ["mse", "huber"])
def test_critic_loss_and_gradient_match_jax(kind):
    x = _loss_inputs(2)
    scale = 30.0 if kind == "huber" else 1.0  # reach huber's linear part
    target = x["target"] * scale

    def jloss(v):
        return jpf.critic_loss_fn(v, jnp.asarray(x["old"]),
                                  jnp.asarray(target), 0.2,
                                  jnp.asarray(x["mask"]), loss_fn_type=kind)

    (want, want_stats), want_grad = jax.value_and_grad(
        jloss, has_aux=True)(jnp.asarray(x["new"]))
    v = torch.from_numpy(x["new"]).requires_grad_(True)
    loss, stats = pf.critic_loss_fn(
        v, torch.from_numpy(x["old"]), torch.from_numpy(target), 0.2,
        torch.from_numpy(x["mask"]), loss_fn_type=kind)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(stats["value_clip_ratio"].item(),
                               float(want_stats["value_clip_ratio"]),
                               rtol=1e-6)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(NotImplementedError):
        pf.critic_loss_fn(v, v, v, 0.2, torch.from_numpy(x["mask"]),
                          loss_fn_type="l1")


def test_reward_builders_match_jax():
    rng = np.random.default_rng(3)
    lens = rng.integers(2, 20, size=5)
    short1 = np.concatenate([[0], np.cumsum(lens - 1)]).astype(np.int64)
    n = int(short1[-1])
    lp = (-rng.random(n)).astype(np.float32)
    ref = (-rng.random(n)).astype(np.float32)
    score = (rng.standard_normal(5) * 15).astype(np.float32)  # some clipped
    no_eos = np.array([0, 1, 0, 0, 1], bool)
    dense = np.where(rng.random(n) > 0.8, rng.standard_normal(n) * 15,
                     0).astype(np.float32)
    kw = dict(kl_ctl=0.1, clip_reward_value=20.0, log_probs=lp,
              ref_log_probs=ref)
    for got, want in zip(
            pf.get_packed_rewards(reward_score=score, short1cu_seqlens=short1,
                                  seq_no_eos_mask=no_eos, **kw),
            jpf.get_packed_rewards(reward_score=score,
                                   short1cu_seqlens=short1,
                                   seq_no_eos_mask=no_eos, **kw)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for got, want in zip(pf.get_packed_dense_rewards(dense_rewards=dense, **kw),
                         jpf.get_packed_dense_rewards(dense_rewards=dense,
                                                      **kw)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_kl_controllers_match_jax():
    fixed, jfixed = pf.FixedKLController(0.1), jpf.FixedKLController(0.1)
    adapt = pf.AdaptiveKLController(0.1, 6.0, 100.0)
    jadapt = jpf.AdaptiveKLController(0.1, 6.0, 100.0)
    for current in (0.5, 9.0, 30.0, 5.9):
        for c in (fixed, jfixed, adapt, jadapt):
            c.update(current, n_steps=16)
        assert fixed.value == jfixed.value == 0.1
        np.testing.assert_allclose(adapt.value, jadapt.value, rtol=1e-12)
    assert adapt.value != 0.1


@pytest.mark.parametrize("kind", ["exp", "ma"])
def test_running_mean_std_matches_jax(kind):
    rng = np.random.default_rng(4)
    if kind == "exp":
        got = pf.ExponentialRunningMeanStd(beta=0.9, epsilon=1e-5)
        want = jpf.ExponentialRunningMeanStd(beta=0.9, epsilon=1e-5)
    else:
        got = pf.MovingAverageRunningMeanStd(epsilon=1e-5)
        want = jpf.MovingAverageRunningMeanStd(epsilon=1e-5)
    x = rng.standard_normal(50).astype(np.float32)
    assert got.mean_std() == want.mean_std() == (0.0, 1.0)
    np.testing.assert_array_equal(got.denormalize(x), x)
    for i in range(3):
        batch = (rng.standard_normal(64) * (i + 1) + i).astype(np.float32)
        mask = (rng.random(64) > 0.4) if i != 1 else None
        got.update(batch, mask=mask)
        want.update(batch, mask=mask)
        np.testing.assert_allclose(got.mean_std(), want.mean_std(),
                                   rtol=1e-12)
    for fn in ("normalize", "denormalize"):
        out = getattr(got, fn)(x)
        assert out.dtype == np.float32
        np.testing.assert_array_equal(out, getattr(want, fn)(x))
