"""What PPO needs of the port's engine, against the JAX engine and
against the port's own ``train_batch``: several optimizer steps in one
``train_minibatches`` call, weight offload, optimizer-state offload, and
the learning-rate schedule past its last step (PPO takes
``ppo_n_minibatches`` optimizer steps per train call while the runner
sizes the schedule in train calls, so every PPO run leaves it).

Tolerances: fp32 on the CPU on both sides, sums in different orders.
Losses of order 5 agree to ~1e-6 relative: 1e-5. After n AdamW steps at
lr 1e-2 a relative gradient difference of ~1e-5 moves a param by ~1e-7
per step: 5e-5 absolute after up to six steps. The port against itself
(``train_minibatches`` against the same ``train_batch`` calls, offload on
against off) runs the same operations in the same order: bit-equal.
"""

import jax
import numpy as np
import pytest
import torch

from realhf_tpu.api.config import ModelName
from realhf_tpu.engine.engine import Engine as JEngine
from realhf_tpu.engine.optim import OptimizerConfig as JOpt
from realhf_tpu.interfaces import sft as jsft
from realhf_tpu.models import transformer as JT
from realhf_tpu.models.config import TransformerConfig as JConfig
from realhf_tpu.parallel.mesh import (
    MeshContext,
    ParallelismConfig,
    default_devices,
    make_mesh,
)
from realhf_tpu_torch.engine.engine import Engine
from realhf_tpu_torch.engine.optim import OptimizerConfig
from realhf_tpu_torch.interfaces import common
from realhf_tpu_torch.interfaces import sft
from realhf_tpu_torch.models.config import TransformerConfig

TINY = dict(n_layers=2, n_kv_heads=2, n_q_heads=4, hidden_dim=32,
            intermediate_dim=64, vocab_size=97, apply_rotary=True,
            layer_norm_type="rms", mlp_type="llama",
            use_attention_bias=False, use_attn_proj_bias=False,
            use_mlp_bias=False, activation_function="silu",
            param_dtype="float32", compute_dtype="float32",
            gradient_checkpointing=True)
OPT = dict(lr=1e-2, lr_scheduler_type="cosine", warmup_steps_proportion=0.0,
           min_lr_ratio=0.1)


def _minibatches(seed=0):
    """Three minibatches of two microbatches each (SFT-shaped: the loss
    is beside the point here), all padded to one shape as the JAX
    engine's stacking needs, with their answer-token weights."""
    rng = np.random.default_rng(seed)
    sbs = []
    for lens, plens in (([20, 13], [5, 9]), ([31], [4]), ([17, 9], [12, 3]),
                        ([25, 6], [20, 2]), ([8, 8, 8], [1, 2, 3]),
                        ([30], [7])):
        ids = rng.integers(2, 97, size=sum(lens)).astype(np.int32)
        pm = np.concatenate([np.arange(n) < p for n, p in zip(lens, plens)])
        sbs.append(common.build_stream_batch(
            lens, dict(input_ids=ids, prompt_mask=pm), bucket=16))
    sbs = common.pad_stream_batches(sbs)
    weights = [float((~b.arrays["prompt_mask"] & (b.arrays["seg_ids"] != 0))
                     .sum()) for b in sbs]
    arrays = [b.arrays for b in sbs]
    return ([arrays[i:i + 2] for i in (0, 2, 4)],
            [weights[i:i + 2] for i in (0, 2, 4)])


def _jax_engine(total):
    jcfg = JConfig(**TINY)
    parallel = ParallelismConfig()
    mesh = make_mesh(parallel, devices=default_devices()[:1])
    ctx = MeshContext(ModelName("ppo", 0), mesh, parallel)
    return JEngine(jcfg, ctx, JT.init_params(jcfg, jax.random.PRNGKey(0)),
                   optimizer=JOpt(**OPT), total_train_steps=total)


def _port_engine(weights, total, **opt):
    return Engine(TransformerConfig(**TINY), weights, device="cpu",
                  optimizer=OptimizerConfig(**dict(OPT, **opt)),
                  total_train_steps=total)


def _assert_params(eng, want, atol):
    want = jax.tree_util.tree_leaves_with_path(want)
    got = dict(jax.tree_util.tree_leaves_with_path(eng.params_numpy()))
    for path, a in want:
        np.testing.assert_allclose(got[path], a, rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def jax_run():
    """Three minibatches through the JAX engine's fused
    ``train_minibatches`` with a schedule of TWO steps (so the third
    step lies past its end), then three more through ``train_batch``."""
    jeng = _jax_engine(total=2)
    start = jeng.params_numpy()
    mbs, weights = _minibatches()
    loss_fn = jsft._make_loss_fn(jeng.cfg)
    stats = jeng.train_minibatches(mbs, loss_fn, weights, "sft")
    after3 = jeng.params_numpy()
    for m, w in zip(mbs, weights):
        stats.append(jeng.train_batch(m, loss_fn, w, "sft"))
    return dict(start=start, stats=stats, after3=after3,
                after6=jeng.params_numpy(), version=jeng.version)


def test_train_minibatches_matches_jax_engine_and_train_batch(jax_run):
    mbs, weights = _minibatches()
    eng = _port_engine(jax_run["start"], total=2)
    loss_fn = sft._make_loss_fn(eng.cfg)
    got = eng.train_minibatches(mbs, loss_fn, weights, "ignored-key")
    assert len(got) == 3 and eng.version == 3 and eng.optimizer.count == 3
    for g, w in zip(got, jax_run["stats"]):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    _assert_params(eng, jax_run["after3"], atol=5e-5)

    # the same three steps as train_batch calls: the same bits
    one = _port_engine(jax_run["start"], total=2)
    singles = [one.train_batch(m, loss_fn, w) for m, w in zip(mbs, weights)]
    assert singles == got
    jax.tree.map(np.testing.assert_array_equal, one.params_numpy(),
                 eng.params_numpy())
    # a single minibatch, and no weights (equal ones)
    assert len(one.train_minibatches(mbs[:1], loss_fn)) == 1
    assert one.version == 4


def test_lr_schedule_past_its_last_step_matches_jax_trajectory(jax_run):
    """Six optimizer steps on a two-step cosine schedule: from the third
    step on the lr is optax's end value, ``lr * min_lr_ratio``."""
    mbs, weights = _minibatches()
    eng = _port_engine(jax_run["start"], total=2)
    loss_fn = sft._make_loss_fn(eng.cfg)
    got = eng.train_minibatches(mbs + mbs, loss_fn, weights + weights)
    assert jax_run["version"] == eng.version == 6
    for g, w in zip(got, jax_run["stats"]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4)
    _assert_params(eng, jax_run["after6"], atol=5e-5)
    lrs = [eng.optimizer.schedule(i) for i in range(6)]
    assert lrs[0] == 1e-2 and lrs[1] < lrs[0]
    np.testing.assert_allclose(lrs[2:], [1e-3] * 4, rtol=1e-12)
    # the params went on moving past the schedule's end
    moved = jax.tree.map(lambda a, b: np.abs(a - b).max(),
                         jax_run["after3"], eng.params_numpy())
    assert min(jax.tree.leaves(moved)) > 0


def test_weight_offload_round_trip_keeps_bits(jax_run):
    eng = _port_engine(jax_run["start"], total=2)
    mbs, _ = _minibatches()
    before = eng.params_numpy()
    lp = eng.forward_logprobs(mbs[0][0]["input_ids"], mbs[0][0]["seg_ids"])
    assert not eng.offloaded
    eng.offload()
    eng.offload()  # idempotent
    assert eng.offloaded
    jax.tree.map(np.testing.assert_array_equal, eng.params_numpy(), before)
    eng.ensure_on_device()
    eng.ensure_on_device()
    assert not eng.offloaded
    jax.tree.map(np.testing.assert_array_equal, eng.params_numpy(), before)
    assert all(p.device.type == "cpu" for p in jax.tree.leaves(eng.params))
    again = eng.forward_logprobs(mbs[0][0]["input_ids"],
                                 mbs[0][0]["seg_ids"])
    assert torch.equal(lp, again)
    eng.offload()
    eng.set_params(before)  # new weights arrive on the device
    assert not eng.offloaded


def test_optimizer_offload_changes_no_number(jax_run):
    mbs, weights = _minibatches()
    plain = _port_engine(jax_run["start"], total=6)
    off = _port_engine(jax_run["start"], total=6, offload=True)
    loss_fn = sft._make_loss_fn(plain.cfg)
    assert not off.optimizer.offloaded
    for _ in range(2):
        want = plain.train_minibatches(mbs, loss_fn, weights)
        got = off.train_minibatches(mbs, loss_fn, weights)
        assert got == want
        assert off.optimizer.offloaded and not plain.optimizer.offloaded
    assert off.optimizer.count == plain.optimizer.count == 6
    for a, b in zip(off.optimizer.m + off.optimizer.v,
                    plain.optimizer.m + plain.optimizer.v):
        assert torch.equal(a, b)
    jax.tree.map(np.testing.assert_array_equal, off.params_numpy(),
                 plain.params_numpy())
    # a direct step brings the state back by itself
    off.optimizer.step(list(jax.tree.leaves(off.params)),
                       [torch.zeros_like(p) for p in
                        jax.tree.leaves(off.params)])
    assert not off.optimizer.offloaded


def test_options_of_later_slices_still_raise(jax_run):
    """ZeRO-1 is on by default, as in the JAX package; at d = 1 it is
    the same math as without: the JAX engine's three minibatches."""
    assert OptimizerConfig().zero1
    z = _port_engine(jax_run["start"], total=2, zero1=True)
    mbs, weights = _minibatches()
    z.train_minibatches(mbs, sft._make_loss_fn(z.cfg), weights)
    _assert_params(z, jax_run["after3"], atol=5e-5)
    eng = Engine(TransformerConfig(**TINY), jax_run["start"], device="cpu")
    with pytest.raises(RuntimeError, match="no optimizer"):
        eng.train_minibatches(_minibatches()[0], sft._make_loss_fn(eng.cfg))
