"""The port's optimizer (``engine/optim.py``) against the JAX package's
``make_optimizer`` (optax) over five steps on the same params and
gradients: every schedule with and without warmup, clipping on and
off, the decay mask over a stacked tree, bf16 params with fp32 master
weights.

Tolerances: fp32 updates of size ~lr agree to a few ulps of the params
(the schedule and bias corrections are taken in float64 here and in
float32 by optax), so 1e-6 absolute on params of order 1. bf16 params
are both round(master): they may differ by one bf16 ulp where the
masters straddle a rounding boundary, 2**-8 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from realhf_tpu.engine import optim as joptim
from realhf_tpu_torch.engine import optim

SHAPES = {"embed": {"wte": (11, 6)},
          "blocks": {"ln1": {"scale": (2, 6)}, "attn": {"wq": (2, 6, 6)}},
          "ln_f": {"scale": (6,)}}


def _tree(fn, t=SHAPES):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in t.items()}


def _flat(tree):
    """Leaves in jax.tree order (sorted keys)."""
    return [x for k in sorted(tree)
            for x in (_flat(tree[k]) if isinstance(tree[k], dict)
                      else [tree[k]])]


def _port_config(jcfg):
    """The port's OptimizerConfig with the JAX config's values."""
    return optim.OptimizerConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(optim.OptimizerConfig)
        if f.name not in ("offload", "zero1")})


def _run(cfg, bf16, grad_scale, steps=5, total=10):
    rng = np.random.default_rng(0)
    params = _tree(lambda s: (1 + 0.1 * rng.standard_normal(s))
                   .astype(np.float32))
    grads = [_tree(lambda s: (grad_scale * rng.standard_normal(s))
                   .astype(np.float32)) for _ in range(steps)]
    dt = jnp.bfloat16 if bf16 else jnp.float32
    jp = jax.tree.map(lambda a: jnp.asarray(a, dt), params)
    tx = joptim.make_optimizer(cfg, total, master_weights=bf16)
    state = tx.init(jp)
    tp = [torch.from_numpy(a).to(torch.bfloat16 if bf16 else torch.float32)
          for a in _flat(params)]
    opt = optim.AdamW(_port_config(cfg), tp, total)
    for g in grads:
        upd, state = tx.update(jax.tree.map(lambda a: jnp.asarray(a, dt), g),
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        tg = [torch.from_numpy(a).to(tp[0].dtype).float() for a in _flat(g)]
        opt.step(tp, tg)
    return jp, state, tp, opt


@pytest.mark.parametrize("sched", ["constant", "linear", "cosine"])
@pytest.mark.parametrize("warmup", [0.0, 0.3])
@pytest.mark.parametrize("clip", [1e3, 0.5], ids=["noclip", "clip"])
def test_five_steps_match_optax_fp32(sched, warmup, clip):
    jcfg = joptim.OptimizerConfig(lr=1e-2, lr_scheduler_type=sched,
                                  warmup_steps_proportion=warmup,
                                  gradient_clipping=clip, min_lr_ratio=0.1)
    jp, _, tp, opt = _run(jcfg, False, grad_scale=1.0)
    assert opt.count == 5
    for a, b in zip(_flat(jax.device_get(jp)), tp):
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-6)
    # the schedule itself, past its end; with warmup, step 0 has lr 0
    js = joptim.lr_schedule(jcfg, 10)
    ts = optim.lr_schedule(_port_config(jcfg), 10)
    for step in range(12):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6,
                                   atol=1e-12)
    if warmup:
        assert ts(0) == 0.0


def test_decay_mask_covers_stacked_norm_scales():
    """Zero gradients: only weight decay moves a param. The stacked
    [n_layers, H] ln scales decay (ndim 2); ln_f's [H] scale does not."""
    jcfg = joptim.OptimizerConfig(lr=1e-1, lr_scheduler_type="constant",
                                  warmup_steps_proportion=0.0)
    jp, _, tp, _ = _run(jcfg, False, grad_scale=0.0)
    rng = np.random.default_rng(0)
    start = _tree(lambda s: (1 + 0.1 * rng.standard_normal(s))
                  .astype(np.float32))
    got = dict(zip(["wq", "ln1", "wte", "ln_f"], tp))
    assert not np.allclose(got["ln1"].numpy(),
                           start["blocks"]["ln1"]["scale"])
    np.testing.assert_array_equal(got["ln_f"].numpy(),
                                  start["ln_f"]["scale"])
    for a, b in zip(_flat(jax.device_get(jp)), tp):
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-6)


def test_bf16_params_with_master_weights():
    jcfg = joptim.OptimizerConfig(lr=1e-2, warmup_steps_proportion=0.0)
    jp, state, tp, opt = _run(jcfg, True, grad_scale=1.0)
    jmaster = _flat(jax.device_get(state.master))
    for a, b, m in zip(_flat(jax.device_get(jp)), tp, opt.master):
        assert b.dtype == torch.bfloat16 and m.dtype == torch.float32
        np.testing.assert_allclose(m.numpy(), jmaster.pop(0), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), rtol=2 ** -8,
                                   atol=0)
        assert torch.equal(b, m.to(torch.bfloat16))
