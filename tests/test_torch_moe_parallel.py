"""Mixture-of-experts models over the members of a layout, against the
JAX package's ``Engine`` at the same layout (on the virtual CPU devices
``tests/conftest.py`` forces) from the same numpy weights.

- Capacity dispatch at d2t1 and c2: the capacity and each token's place
  in its expert's queue are taken over the whole batch, as JAX takes
  them under GSPMD (``ops/moe.py`` ``MoEShards``). The c2 batch has an L
  (24) that the port pads (to 32, a multiple of 8c) and JAX does not.
- The three dispatch modes (ragged, dense, capacity) at d1t2 and d2t2:
  each model member runs its slice of every expert's FFN width.
- Train steps with the router losses formed from every data shard's
  (d2t1, d2t2) and context shard's (c2) sums.
- Expert parallelism at d2t1 and d2t2 on ``tests/ops/test_moe_ep.py``'s
  config (8 experts, capacity 2): a forward and a train step against
  JAX's EP engine, the JAX engine's refusals with its messages, and the
  weights moved between EP and one-device layouts, saved and gathered
  bit-equal to a d1t1 engine's.

Tolerances: fp32 on both sides, sums in other orders. Log-probs 1e-5
absolute (the fault: 0.019 at d2t1, 0.0049 at c2 before the repair),
losses and grad norms 1e-5 relative, weights after two AdamW steps at lr
1e-2 1e-5 absolute (as ``test_torch_tp_engine.py``); moves and saves
bit-equal.
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
from realhf_tpu.models.config import MoEConfig as JMoE
from realhf_tpu.models.config import TransformerConfig as JConfig
from realhf_tpu.parallel.mesh import MeshContext
from realhf_tpu.parallel.mesh import make_mesh as jmake_mesh
from realhf_tpu.parallel.mesh import parse_parallelism as jparse
from realhf_tpu_torch.engine.engine import Engine
from realhf_tpu_torch.engine.optim import OptimizerConfig
from realhf_tpu_torch.interfaces import sft
from realhf_tpu_torch.models.config import MoEConfig, TransformerConfig
from realhf_tpu_torch.models.hf import save_hf_checkpoint_streamed
from realhf_tpu_torch.parallel.mesh import parse_parallelism
from realhf_tpu_torch.parallel.realloc import reallocate
from test_torch_tp_engine import (
    OPT,
    TINY,
    _batch,
    _files,
    _sft_microbatches,
)

ATOL = 1e-5
MODES = {
    "ragged": dict(),
    "dense": dict(use_grouped_gemm=False),
    "capacity": dict(capacity_factor=0.5, use_grouped_gemm=False),
}
# tests/ops/test_moe_ep.py's config
EP_BASE = dict(n_layers=2, n_kv_heads=2, n_q_heads=4, hidden_dim=32,
               intermediate_dim=64, vocab_size=128, apply_rotary=True,
               layer_norm_type="rms", mlp_type="moe",
               use_attention_bias=False, use_attn_proj_bias=False,
               use_mlp_bias=False, activation_function="silu",
               compute_dtype="float32")
EP_MOE = dict(num_experts=8, top_k=2, capacity_factor=2.0,
              aux_loss_coeff=0.01, z_loss_coeff=0.001,
              use_grouped_gemm=False, expert_parallel=True)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops over several members: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(mode="ragged", base=TINY, **moe):
    """(JAX config kwargs, port config kwargs) of a MoE model."""
    kw = dict(num_experts=4, top_k=2, z_loss_coeff=1e-3, **MODES[mode])
    kw.update(moe)
    return (dict(base, mlp_type="moe", moe=JMoE(**kw)),
            dict(base, mlp_type="moe", moe=MoEConfig(**kw)))


def _jax(jkw, layout, params=None, opt=None):
    par = jparse(layout)
    ctx = MeshContext(ModelName("m", 0), jmake_mesh(
        par, jax.devices("cpu")[:par.world_size]), par)
    cfg = JConfig(**jkw)
    if params is None:
        params = jax.tree.map(np.asarray, JT.init_params(
            cfg, jax.random.PRNGKey(0)))
    return JEngine(cfg, ctx, jax.tree.map(np.copy, params),
                   optimizer=None if opt is None else JOpt(**opt),
                   total_train_steps=10)


def _port(kw, layout, params, opt=None):
    par = parse_parallelism(layout)
    return Engine(TransformerConfig(**kw), params, device="cpu",
                  parallel=par, devices=["cpu"] * par.world_size,
                  optimizer=None if opt is None else OptimizerConfig(**opt),
                  total_train_steps=10)


def _jloss(jeng):
    return jsft._make_loss_fn(jeng.cfg, jeng.attention_fn, None,
                              jeng.moe_constraint)


def _steps(jeng, eng, mbs, weights, n=2):
    for _ in range(n):
        want = jeng.train_batch(mbs, _jloss(jeng), loss_weights=weights,
                                loss_fn_key="sft")
        got = eng.train_batch(mbs, sft._make_loss_fn(eng.cfg), weights)
        for k in ("loss", "grad_norm", "nll", "moe_aux_loss",
                  "moe_z_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)
    for a, b in zip(jax.tree.leaves(eng.params_numpy()),
                    jax.tree.leaves(jeng.params_numpy())):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("layout", ["d2t1", "c2"])
def test_capacity_dispatch_matches_jax_at_layout(layout):
    """The fault: per-shard capacity and queue positions gave log-probs
    0.019 (d2t1) and 0.0049 (c2) away from JAX's at the same layout."""
    jkw, kw = _cfgs("capacity")
    jeng = _jax(jkw, layout)
    w = jeng.params_numpy()
    ids, seg, _ = _batch(3)
    assert ids.shape[1] % 16  # the port pads c2's streams, JAX does not
    np.testing.assert_allclose(
        _port(kw, layout, w).forward_logprobs(ids, seg).numpy(),
        np.asarray(jeng.forward_logprobs(ids, seg)), atol=ATOL, rtol=0)


@pytest.mark.parametrize("layout", ["d1t2", "d2t2"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_dispatch_modes_over_model_members_match_jax(mode, layout):
    jkw, kw = _cfgs(mode)
    jeng = _jax(jkw, layout)
    w = jeng.params_numpy()
    ids, seg, mask = _batch(4)
    np.testing.assert_allclose(
        _port(kw, layout, w).forward_logprobs(ids, seg,
                                              logits_mask=mask).numpy(),
        np.asarray(jeng.forward_logprobs(ids, seg, logits_mask=mask)),
        atol=ATOL, rtol=0)


@pytest.mark.parametrize("layout,mode", [("d2t1", "ragged"),
                                         ("d2t2", "capacity")])
def test_router_losses_over_data_shards_train_as_jax(layout, mode):
    jkw, kw = _cfgs(mode)
    jeng = _jax(jkw, layout, opt=OPT)
    eng = _port(kw, layout, jeng.params_numpy(), opt=OPT)
    mbs, weights = _sft_microbatches(eng.n_streams, seed=6)
    _steps(jeng, eng, mbs, weights)


@pytest.mark.parametrize("mode", ["ragged", "capacity"])
def test_router_losses_over_context_shards_train_as_jax(mode):
    jkw, kw = _cfgs(mode)
    jeng = _jax(jkw, "c2", opt=OPT)
    eng = _port(kw, "c2", jeng.params_numpy(), opt=OPT)
    ids, seg, _ = _batch(6)
    mb = dict(input_ids=ids, seg_ids=seg,
              prompt_mask=np.zeros_like(ids, dtype=bool))
    _steps(jeng, eng, [mb], [1.0])


@pytest.mark.parametrize("layout", ["d2t1", "d2t2"])
def test_expert_parallel_matches_the_jax_ep_engine(layout):
    jkw, kw = _cfgs(base=EP_BASE, **EP_MOE)
    jeng = _jax(jkw, layout, opt=OPT)
    w = jeng.params_numpy()
    eng = _port(kw, layout, w, opt=OPT)
    # data member g holds experts [4 g, 4 g + 4), model member j half of
    # each one's FFN width
    d, t = eng.parallel.data_parallel_size, eng.parallel.tensor_parallel_size
    for i, tr in enumerate(eng.params.trees):
        g, j = i // t, i % t
        np.testing.assert_array_equal(
            tr["blocks"]["mlp"]["wg"].numpy(),
            np.split(np.split(w["blocks"]["mlp"]["wg"], d, 1)[g], t, 3)[j])
    ids, seg, _ = _batch(7)
    np.testing.assert_allclose(eng.forward_logprobs(ids, seg).numpy(),
                               np.asarray(jeng.forward_logprobs(ids, seg)),
                               atol=ATOL, rtol=0)
    mbs, weights = _sft_microbatches(d, seed=7)
    _steps(jeng, eng, mbs, weights, n=1)


def test_expert_parallel_refusals_carry_the_jax_messages():
    for layout, moe in (("d2t1", dict(capacity_factor=None,
                                      use_grouped_gemm=True)),
                        ("d3t1", dict())):
        jkw, kw = _cfgs(base=EP_BASE, **dict(EP_MOE, **moe))
        with pytest.raises(ValueError) as want:
            _jax(jkw, layout)
        with pytest.raises(ValueError) as got:
            _port(kw, layout, None)
        assert str(got.value) == str(want.value)


def test_expert_parallel_moves_and_saves_as_d1t1(tmp_path):
    """d1t1 -> EP d2t2 -> d1t2 -> d1t1 by reallocation, bit-equal; an EP
    d2t2 engine's weights and optimizer state after a step save file for
    file as the d1t1 engine's they were copied from."""
    from realhf_tpu_torch.engine import opt_checkpoint
    _, kw = _cfgs(base=EP_BASE, **EP_MOE)
    cfg = TransformerConfig(**kw)
    one = _port(kw, "d1t1", jax.tree.map(np.asarray, JT.init_params(
        JConfig(**_cfgs(base=EP_BASE, **EP_MOE)[0]),
        jax.random.PRNGKey(1))), opt=OPT)
    mbs, weights = _sft_microbatches(1, seed=8)
    one.train_batch(mbs, sft._make_loss_fn(cfg), weights)
    w = one.params_numpy()
    ep = _port(kw, "d2t2", w, opt=OPT)
    ep.load_opt_state(one.opt_state_numpy())
    paths = [path for path, _, _ in ep._leaf_specs()]
    # ZeRO-1 does not split an expert leaf's state again
    assert ep.params.ep and ep._zero1[0][paths.index(
        ("blocks", "mlp", "wg"))] is None
    for name, e in (("one", one), ("ep", ep)):
        d = str(tmp_path / name)
        save_hf_checkpoint_streamed(
            d, "mixtral", cfg, e.gathered_params("cpu") if e.sharded
            else e.params)
        opt_checkpoint.save_opt_state_iter(d, e.iter_opt_state_numpy())
    assert _files(str(tmp_path / "one")) == _files(str(tmp_path / "ep"))
    t2 = _port(kw, "d1t2", w)
    back = _port(kw, "d1t1", w)
    for e in (t2, back):
        for tr in (e.params.trees if e.sharded else [e.params]):
            for leaf in jax.tree.leaves(tr):
                leaf.zero_()
    reallocate(cfg, ep.params, t2)
    reallocate(cfg, t2.params, back)
    for a, b in zip(jax.tree.leaves(back.params_numpy()),
                    jax.tree.leaves(w)):
        np.testing.assert_array_equal(a, b)
    ep2 = _port(kw, "d2t2", None)
    reallocate(cfg, back.params, ep2)
    for a, b in zip(jax.tree.leaves(ep2.params_numpy()),
                    jax.tree.leaves(w)):
        np.testing.assert_array_equal(a, b)
