"""Mixture-of-experts models inside pipeline stages: more than one model
member in a stage (t2p2) and data groups with pipelines (d2p2), against
the JAX package on the same numpy weights and inputs.

A pipelined MoE microbatch is the JAX package's: rows ``[m Bm, (m + 1)
Bm)`` of the whole batch, whichever data groups hold them, routed as one
set (capacity over Bm * L tokens), its router losses weighted by its
real-stream share (``models/transformer.py``
``_forward_members_pipeline``).

- Inference at t2p2 (ragged and capacity dispatch) against the JAX d1t1
  engine run on each microbatch's rows, padded to Bm with padding
  streams (JAX's own forward at p > 1 raises on jax 0.9,
  ``realhf_tpu/models/sharding.py:253``).
- GPipe train steps at d2t1p2, d1t2p2 and d2t2p2, and with sequence
  parallelism at d1t2p2s and d2t2p2s (each stage's blocks
  ``_sp_block``: the router sees the group's all-gathered tokens),
  ragged and capacity, against the JAX engine's GPipe at the same
  layout: loss, grad norm, nll, both router losses, and the weights
  after two steps (the router losses' gradients included); at M 3 over
  two data groups a microbatch spans both. JAX's 1F1B VJP refuses aux
  cotangents (ROADMAP queue 3), so the port's 1F1B is held against the
  port's GPipe at one microbatch count.
- Expert parallelism at d2t1p2 (capacity dispatch, 8 experts) against
  JAX's d2t1p2 GPipe without it (JAX's EP constraint raises inside the
  pipeline on jax 0.9); the port's 1F1B refuses it.

Tolerances: fp32 on both sides, sums in other orders. Log-probs 1e-5
absolute, losses and grad norms 1e-5 relative, weights after two AdamW
steps at lr 1e-2 1e-5 absolute (as ``test_torch_moe_parallel.py``).
"""

import dataclasses

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
from realhf_tpu.parallel.mesh import MeshContext
from realhf_tpu.parallel.mesh import make_mesh as jmake_mesh
from realhf_tpu.parallel.mesh import parse_parallelism as jparse
from realhf_tpu_torch.engine.engine import Engine
from realhf_tpu_torch.engine.optim import OptimizerConfig
from realhf_tpu_torch.interfaces import sft
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.parallel.mesh import parse_parallelism
from test_torch_moe_parallel import EP_BASE, EP_MOE, _cfgs
from test_torch_tp_engine import OPT, _batch, _sft_microbatches

ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops over several members: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(jkw, layout, params=None, opt=None, schedule="gpipe", n_mb=0):
    par = dataclasses.replace(jparse(layout), pipeline_schedule=schedule,
                              pipeline_microbatches=n_mb)
    ctx = MeshContext(ModelName("m", 0), jmake_mesh(
        par, jax.devices("cpu")[:par.world_size]), par)
    cfg = JConfig(**jkw)
    if params is None:
        params = jax.tree.map(np.asarray, JT.init_params(
            cfg, jax.random.PRNGKey(0)))
    return JEngine(cfg, ctx, jax.tree.map(np.copy, params),
                   optimizer=None if opt is None else JOpt(**opt),
                   total_train_steps=10)


def _port(kw, layout, params, opt=None, schedule="gpipe", n_mb=0):
    par = dataclasses.replace(parse_parallelism(layout),
                              pipeline_schedule=schedule,
                              pipeline_microbatches=n_mb)
    return Engine(TransformerConfig(**kw), params, device="cpu",
                  parallel=par, devices=["cpu"] * par.world_size,
                  optimizer=None if opt is None else OptimizerConfig(**opt),
                  total_train_steps=10)


def _jloss(jeng):
    """JAX's SFT loss as its interface builds it: through the engine's
    pipeline (its aux weighted per microbatch)."""
    return jsft._make_loss_fn(jeng.cfg, jeng.attention_fn, jeng.pipeline_ctx,
                              jeng.moe_constraint)


def _train_close(jeng, engs, n_steps=2):
    for _ in range(n_steps):
        mbs, w = _sft_microbatches(jeng.n_streams)
        want = jeng.train_batch(mbs, _jloss(jeng), loss_weights=w,
                                loss_fn_key="sft")
        for eng in engs:
            got = eng.train_batch(mbs, sft._make_loss_fn(eng.cfg), w)
            for k in ("loss", "grad_norm", "nll", "moe_aux_loss",
                      "moe_z_loss"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           err_msg=k)
    want = jax.tree.leaves(jeng.params_numpy())
    for eng in engs:
        for a, b in zip(jax.tree.leaves(eng.params_numpy()), want):
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["ragged", "capacity"])
def test_inference_at_t2p2_matches_jax_per_microbatch(mode):
    """Five streams in four microbatches of two: the last holds one real
    stream and one padding stream."""
    jkw, kw = _cfgs(mode, aux_loss_coeff=0.01)
    one = _jax(jkw, "d1t1")
    w = one.params_numpy()
    ids, seg, _ = _batch(s=5)
    eng = _port(kw, "d1t2p2", w)
    assert eng.pipeline_ctx_infer.n_microbatches == 4
    want = []
    for m in range(3):
        i, s = ids[2 * m:2 * m + 2], seg[2 * m:2 * m + 2]
        if len(i) < 2:
            i = np.concatenate([i, np.zeros_like(i)])
            s = np.concatenate([s, np.zeros_like(s)])
        want.append(np.asarray(one.forward_logprobs(i, s))[:len(ids) - 2 * m])
    np.testing.assert_allclose(eng.forward_logprobs(ids, seg).numpy(),
                               np.concatenate(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("layout,mode", [("d2t1p2", "ragged"),
                                         ("d2t1p2", "capacity"),
                                         ("d1t2p2", "capacity"),
                                         ("d2t2p2", "ragged"),
                                         ("d1t2p2s", "ragged"),
                                         ("d1t2p2s", "capacity"),
                                         ("d2t2p2s", "ragged"),
                                         ("d2t2p2s", "capacity")])
def test_gpipe_train_steps_match_jax_gpipe_at_layout(layout, mode):
    jkw, kw = _cfgs(mode, aux_loss_coeff=0.01)
    jeng = _jax(jkw, layout, opt=OPT)
    eng = _port(kw, layout, jeng.params_numpy(), OPT)
    assert eng.n_streams == jeng.n_streams
    _train_close(jeng, [eng])


@pytest.mark.parametrize("layout", ["d2t1p2", "d2t2p2s"])
def test_microbatches_spanning_data_groups_match_jax_gpipe(layout):
    """Six streams in three microbatches of two over two data groups of
    three rows: microbatch 1 is row 2 of group 0 and row 3 of group 1,
    so its capacity dispatch queues group 1's tokens after group 0's
    (``MoEShards.base``), and its router losses sum both groups'."""
    jkw, kw = _cfgs("capacity", aux_loss_coeff=0.01)
    jeng = _jax(jkw, layout, opt=OPT, n_mb=3)
    eng = _port(kw, layout, jeng.params_numpy(), OPT, n_mb=3)
    assert eng.n_streams == jeng.n_streams == 6
    _train_close(jeng, [eng])


def test_1f1b_matches_gpipe_at_d2t2p2():
    """The port's two schedules at one microbatch count: the router sums'
    cotangents enter each stage-tick's recompute."""
    _, kw = _cfgs("capacity", aux_loss_coeff=0.01)
    cfg = TransformerConfig(**kw)
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.models.convert import params_numpy
    w = params_numpy(T.init_params(cfg, torch.Generator().manual_seed(3)))
    engs = {s: _port(kw, "d2t2p2", w, OPT, s, n_mb=4)
            for s in ("gpipe", "1f1b")}
    for _ in range(2):
        mbs, wt = _sft_microbatches(engs["gpipe"].n_streams, seed=3)
        got = {s: e.train_batch(mbs, sft._make_loss_fn(e.cfg), wt)
               for s, e in engs.items()}
        for k in ("loss", "grad_norm", "moe_aux_loss", "moe_z_loss"):
            np.testing.assert_allclose(got["1f1b"][k], got["gpipe"][k],
                                       rtol=1e-5, err_msg=k)
    for a, b in zip(jax.tree.leaves(engs["1f1b"].params_numpy()),
                    jax.tree.leaves(engs["gpipe"].params_numpy())):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def test_expert_parallel_in_pipeline_matches_jax():
    """JAX's expert-parallel constraint raises inside the pipeline's
    ``shard_map`` on jax 0.9 (``realhf_tpu/models/sharding.py:270``), so
    the port's EP is held against JAX's d2t1p2 GPipe without it: the
    constraint moves no number."""
    jkw, _ = _cfgs(base=EP_BASE, **dict(EP_MOE, expert_parallel=False))
    _, kw = _cfgs(base=EP_BASE, **EP_MOE)
    jeng = _jax(jkw, "d2t1p2", opt=OPT)
    eng = _port(kw, "d2t1p2", jeng.params_numpy(), OPT)
    assert eng.params.ep
    _train_close(jeng, [eng])
    one = _port(kw, "d2t1p2", jeng.params_numpy(), OPT, "1f1b")
    mbs, w = _sft_microbatches(one.n_streams)
    with pytest.raises(NotImplementedError, match="trains under GPipe"):
        one.train_batch(mbs, sft._make_loss_fn(one.cfg), w)


def test_moe_layouts_in_pipelines_build():
    """The layouts the port refused before: MoE at t2 in a stage, and
    router losses at d2 with p2 (one forward each, finite losses)."""
    _, kw = _cfgs("ragged", aux_loss_coeff=0.01)
    cfg = TransformerConfig(**kw)
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.models.convert import params_numpy
    w = params_numpy(T.init_params(cfg, torch.Generator().manual_seed(4)))
    ids, seg, _ = _batch(s=8)
    for layout in ("d1t2p2", "d2t1p2"):
        eng = _port(kw, layout, w)
        _, _, aux = T.forward(cfg, eng.params, torch.from_numpy(ids),
                              torch.from_numpy(seg), return_aux=True)
        assert sorted(aux) == ["moe_aux_loss", "moe_z_loss"]
        assert all(bool(torch.isfinite(v)) for v in aux.values())
