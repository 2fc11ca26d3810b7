"""Optimizer state across the two packages (``engine/opt_checkpoint.py``).

The port's AdamW state is written and read in the JAX package's leaf
order (``jax.tree.leaves`` of ``make_optimizer``'s state: the fp32 master
copies when the params are bf16, adam's 0-d int32 count, the first and
second moments in sorted-key order, the schedule's count), so either
package resumes from the other's ``optimizer_state.npz``. The order the
port writes is held here against ``jax.tree.structure`` of a JAX
engine's state. After one train step in one package, the other restores
the state (bit for bit) and both take one more step on the same
microbatches: the losses agree to 1e-5 relative and, for fp32 params,
the params as a fresh pair of engines does (``test_torch_sft.py``: 1e-5
absolute). For bf16 params ``_assert_bf16_step`` holds each package's
step to the Adam rule applied to the restored state and the two
packages' gradients to each other. A state saved for another layer
count is refused with the JAX package's reason, and a short or cut file
with a reason.
"""

import math

import logging

import jax
import ml_dtypes
import numpy as np
import pytest

from realhf_tpu.api.config import ModelName
from realhf_tpu.engine import opt_checkpoint as jopt
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
from realhf_tpu_torch.engine import opt_checkpoint
from realhf_tpu_torch.engine.engine import Engine
from realhf_tpu_torch.engine.optim import OptimizerConfig
from realhf_tpu_torch.models.config import TransformerConfig
from test_torch_sft import TINY, _microbatches, _train

OPT = dict(lr=1e-2, lr_scheduler_type="cosine", warmup_steps_proportion=0.0)
#: the second step's lr: cosine over 10 steps, no warmup, at count 1
LR_STEP2 = OPT["lr"] * 0.5 * (1 + math.cos(math.pi / 10))
#: fp32 rounding allowed in the optimizer's arithmetic: units of 2^-23
#: of the values involved (readings: <= 3.7, JAX -> port and port -> JAX,
#: microbatch seeds 0 and 1)
F32_ULPS = 8
#: bf16 engines: each leaf's gradient, as Adam saw it, may differ between
#: the packages by this share of the leaf's largest gradient (readings
#: 3.3e-3 to 6.6e-3 over microbatch seeds 0-3 in both directions, all in
#: the embedding rows; every other leaf <= 1.2e-4; 3x the largest)
BF16_GRAD_SHARE = 2e-2


def _engines(dtype="float32", n_layers=2, total=10):
    kw = dict(TINY, param_dtype=dtype, n_layers=n_layers)
    jcfg = JConfig(**kw)
    parallel = ParallelismConfig()
    mesh = make_mesh(parallel, devices=default_devices()[:1])
    ctx = MeshContext(ModelName("sft", 0), mesh, parallel)
    jeng = JEngine(jcfg, ctx, JT.init_params(jcfg, jax.random.PRNGKey(0)),
                   optimizer=JOpt(**OPT), total_train_steps=total)
    eng = Engine(TransformerConfig(**kw), jeng.params_numpy(), device="cpu",
                 optimizer=OptimizerConfig(**OPT), total_train_steps=total)
    return jeng, eng


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_states_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=str(i))


def _assert_close(jeng, eng, dtype, restored):
    """fp32: every param within 1e-5 absolute, as a fresh pair of engines
    after the same steps (``test_torch_sft.py``). bf16: see
    ``_assert_bf16_step``."""
    if dtype != "float32":
        return _assert_bf16_step(jeng, eng, restored)
    for g, w in zip(jax.tree.leaves(eng.params_numpy()),
                    jax.tree.leaves(jeng.params_numpy())):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def _assert_bf16_step(jeng, eng, restored):
    """The step after a restore on bf16 params, from the ``restored``
    state (the same bits in both packages) to each package's state now.

    In each package the gradient ``g = (mu - b1 mu0) / (1 - b1)`` that
    Adam took must give the second moments, ``nu = b2 nu0 + (1 - b2) g^2``,
    and the fp32 master copies must be the AdamW rule applied to the
    restored masters and these moments, both within ``F32_ULPS``: so the
    restored moments, masters and count all entered the step. Between the
    packages, each leaf's ``g`` agrees within ``BF16_GRAD_SHARE`` of its
    largest element: the packages round the bf16 backward differently
    (the embedding rows' gradient most), which is the whole of the
    difference in the masters, held within 2 lr. Each package's bf16
    params are its masters rounded."""
    jopt_cfg = JOpt()
    b1, b2, eps, wd = (jopt_cfg.beta1, jopt_cfg.beta2, jopt_cfg.eps,
                       jopt_cfg.weight_decay)
    s0 = [np.asarray(x, np.float64) for x in restored]
    n = (len(s0) - 2) // 3
    ulp = 2.0 ** -23
    grads, masters = [], []
    for e in (jeng, eng):
        s1 = [np.asarray(x, np.float64) for x in e.opt_state_numpy()]
        assert int(s1[n]) == int(s0[n]) + 1 == int(s1[-1])
        gs = []
        for i in range(n):
            m0, mu0, nu0 = s0[i], s0[n + 1 + i], s0[2 * n + 1 + i]
            m1, mu1, nu1 = s1[i], s1[n + 1 + i], s1[2 * n + 1 + i]
            g = (mu1 - b1 * mu0) / (1 - b1)
            want_nu = b2 * nu0 + (1 - b2) * g * g
            assert np.all(np.abs(nu1 - want_nu)
                          <= F32_ULPS * ulp * np.abs(nu1)), i
            u = mu1 / (1 - b1 ** 2) / (np.sqrt(nu1 / (1 - b2 ** 2)) + eps)
            if m0.ndim >= 2:
                u = u + wd * m0
            want = m0 - LR_STEP2 * u
            assert np.all(np.abs(m1 - want) <= F32_ULPS * ulp * (
                np.abs(want) + LR_STEP2 * np.abs(u))), i
            gs.append(g)
        grads.append(gs)
        masters.append(s1[:n])
        for p, m in zip(jax.tree.leaves(e.params_numpy()), s1[:n]):
            np.testing.assert_array_equal(
                _bits(p), _bits(m.astype(np.float32).astype(
                    ml_dtypes.bfloat16)))
    for i, (gj, gp) in enumerate(zip(*grads)):
        share = np.abs(gp - gj).max() / np.abs(gj).max()
        assert share <= BF16_GRAD_SHARE, (i, share)
    for mj, mp in zip(*masters):
        assert np.abs(mp - mj).max() <= 2 * LR_STEP2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_state_has_the_jax_leaf_order(dtype):
    """Leaf for leaf the shapes, dtypes and 0-d counts of
    ``jax.tree.leaves`` of the JAX engine's state, before and after a
    step (then bit-equal)."""
    jeng, eng = _engines(dtype)
    spec = [(tuple(l.shape), np.dtype(l.dtype))
            for l in jax.tree.leaves(jeng.opt_state)]
    assert eng.opt_state_spec() == spec
    n = len(jax.tree.leaves(jeng.params))
    kinds = ["count" if s == () else "tensor" for s, _ in spec]
    master = n if dtype == "bfloat16" else 0
    assert kinds == (["tensor"] * master + ["count"] + ["tensor"] * 2 * n
                     + ["count"])
    _assert_states_equal(eng.opt_state_numpy(), jeng.opt_state_numpy())
    mbs, weights = _microbatches()
    _train(jeng, eng, mbs, weights)
    got, want = eng.opt_state_numpy(), jeng.opt_state_numpy()
    assert [int(x) for x in (got[master], got[-1])] == [1, 1]
    assert [(g.shape, g.dtype) for g in got] == [(w.shape, w.dtype)
                                                 for w in want]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_state_resumes_in_port(tmp_path, dtype):
    jeng, eng = _engines(dtype)
    mbs, weights = _microbatches()
    jeng.train_batch(mbs, jsft._make_loss_fn(jeng.cfg),
                     loss_weights=weights, loss_fn_key="sft")
    jopt.save_opt_state(str(tmp_path), jeng.opt_state_numpy())
    eng.set_params(jeng.params_numpy())
    assert opt_checkpoint.restore_engine_opt_state(eng, str(tmp_path))
    assert eng.optimizer.count == 1
    restored = eng.opt_state_numpy()
    _assert_states_equal(restored, jeng.opt_state_numpy())
    want, got = _train(jeng, eng, mbs, weights)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _assert_close(jeng, eng, dtype, restored)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_state_resumes_in_jax(tmp_path, dtype):
    from realhf_tpu_torch.interfaces import sft
    jeng, eng = _engines(dtype)
    mbs, weights = _microbatches(seed=1)
    eng.train_batch(mbs, sft._make_loss_fn(eng.cfg), loss_weights=weights)
    opt_checkpoint.save_opt_state_iter(str(tmp_path),
                                       eng.iter_opt_state_numpy())
    jeng.set_params(jax.tree.map(np.asarray, eng.params_numpy()))
    assert jopt.restore_engine_opt_state(jeng, str(tmp_path))
    restored = jeng.opt_state_numpy()
    _assert_states_equal(restored, eng.opt_state_numpy())
    want, got = _train(jeng, eng, mbs, weights)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _assert_close(jeng, eng, dtype, restored)


class _Records(logging.Handler):

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _logged(name, fn):
    h = _Records()
    logger = logging.getLogger(name)
    logger.addHandler(h)
    try:
        return fn(), h.messages
    finally:
        logger.removeHandler(h)


def test_structure_mismatch_is_refused_with_the_jax_reason(tmp_path):
    """A state saved for 2 layers, restored into 3-layer engines: both
    packages refuse it with the same warning and keep a fresh state."""
    jeng, eng = _engines()
    jopt.save_opt_state(str(tmp_path), jeng.opt_state_numpy())
    jeng3, eng3 = _engines(n_layers=3)
    fresh = eng3.opt_state_numpy()
    ok_j, msgs_j = _logged("realhf_tpu.opt_checkpoint",
                           lambda: jopt.restore_engine_opt_state(
                               jeng3, str(tmp_path)))
    ok, msgs = _logged("realhf_tpu_torch.opt_checkpoint",
                       lambda: opt_checkpoint.restore_engine_opt_state(
                           eng3, str(tmp_path)))
    assert ok is ok_j is False
    assert msgs == msgs_j and "does not match" in msgs[0]
    _assert_states_equal(eng3.opt_state_numpy(), fresh)


def test_short_or_missing_file_gives_a_reason(tmp_path):
    jeng, eng = _engines()
    leaves, reason = opt_checkpoint.load_opt_state_checked(str(tmp_path))
    assert leaves is None and "no optimizer state" in reason
    assert not opt_checkpoint.restore_engine_opt_state(eng, str(tmp_path))
    # a file cut in half
    import json
    opt_checkpoint.save_opt_state(str(tmp_path), eng.opt_state_numpy())
    f = tmp_path / opt_checkpoint.FILENAME
    f.write_bytes(f.read_bytes()[:f.stat().st_size // 2])
    leaves, reason = opt_checkpoint.load_opt_state_checked(str(tmp_path))
    assert leaves is None and str(f) in reason
    assert not opt_checkpoint.restore_engine_opt_state(eng, str(tmp_path))
    # 3 leaves where the meta promises 4
    meta = np.frombuffer(json.dumps({"n": 4, "dtypes": ["float32"] * 4})
                         .encode(), np.uint8)
    np.savez(str(f)[:-4], l0=np.zeros(2), l1=np.zeros(2), l2=np.zeros(2),
             __meta__=meta)
    leaves, reason = opt_checkpoint.load_opt_state_checked(str(tmp_path))
    assert leaves is None and "short file: 3 of 4" in reason
    jleaves, jreason = jopt.load_opt_state_checked(str(tmp_path))
    assert jleaves is None and jreason == reason


def test_bf16_and_0d_leaves_round_trip_between_packages(tmp_path):
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal((3, 4)).astype(ml_dtypes.bfloat16),
              np.asarray(7, np.int32), rng.standard_normal(5)
              .astype(np.float32)]
    opt_checkpoint.save_opt_state(str(tmp_path), leaves)
    _assert_states_equal(jopt.load_opt_state(str(tmp_path)), leaves)
    jopt.save_opt_state(str(tmp_path), leaves)
    got, reason = opt_checkpoint.load_opt_state_checked(str(tmp_path))
    assert reason is None
    _assert_states_equal(got, leaves)


def test_offloaded_state_saves_from_the_host():
    """An engine with ``offload`` saves between steps without bringing the
    state back (on the CPU the flag shows it)."""
    from realhf_tpu_torch.interfaces import sft
    _, eng = _engines()
    eng.optimizer.cfg.offload = True
    mbs, weights = _microbatches()
    eng.train_batch(mbs, sft._make_loss_fn(eng.cfg), loss_weights=weights)
    assert eng.optimizer.offloaded
    assert len(list(eng.iter_opt_state_numpy())) == len(eng.opt_state_spec())
    assert eng.optimizer.offloaded
