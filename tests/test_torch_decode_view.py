"""The decode view (``Engine.decode_engine``): generation on pipeline and
context-parallel layouts and at a decode degree ``g``, against
``tests/engine/test_pp_generate.py``'s cases, and the PPO allocation
``actor_gen_alloc="d2t2p2g4"`` with ``drop_decode_view_after_rollout``
against ``tests/system/test_pp_gen_e2e.py``'s assertions.

The port's engines sit on ``[cpu] * n``; a dense layout of the port, and
the JAX package's d1t1 engine, generate from the same numpy weights.
Tolerances: fp32 on the CPU, greedy tokens equal, log-probs 1e-5
absolute against the port's dense layouts (the same arithmetic but for
the order of the model members' sums) and 1e-4 against JAX.
"""

import jax
import numpy as np
import pytest
import torch

from realhf_tpu.api.config import ModelName
from realhf_tpu.engine.engine import Engine as JEngine
from realhf_tpu.models.config import TransformerConfig as JConfig
from realhf_tpu.ops.sampling import GenerationHyperparameters as JGen
from realhf_tpu.parallel.mesh import MeshContext
from realhf_tpu.parallel.mesh import ParallelismConfig as JPar
from realhf_tpu.parallel.mesh import make_mesh as jmake_mesh
from realhf_tpu_torch.engine import packing
from realhf_tpu_torch.engine.engine import Engine
from realhf_tpu_torch.engine.optim import OptimizerConfig
from realhf_tpu_torch.interfaces import sft
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.models.convert import params_numpy
from realhf_tpu_torch.ops.sampling import GenerationHyperparameters
from realhf_tpu_torch.parallel.mesh import parse_parallelism

TINY = dict(n_layers=2, n_kv_heads=4, n_q_heads=8, hidden_dim=64,
            intermediate_dim=96, vocab_size=64, apply_rotary=True,
            layer_norm_type="rms", mlp_type="llama",
            use_attention_bias=False, use_attn_proj_bias=False,
            use_mlp_bias=False, activation_function="silu",
            param_dtype="float32", compute_dtype="float32")
TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its many small ops over
    several members run faster so, above all beside the other test
    workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(seed=0):
    return params_numpy(T.init_params(TransformerConfig(**TINY),
                                      torch.Generator().manual_seed(seed)))


def _engine(layout, w, opt=None):
    par = parse_parallelism(layout)
    return Engine(TransformerConfig(**TINY), w, device="cpu", parallel=par,
                  devices=["cpu"] * par.world_size,
                  optimizer=None if opt is None else OptimizerConfig(**opt),
                  total_train_steps=10)


def _prompts():
    rng = np.random.default_rng(0)
    return packing.left_padded_prompts(
        [rng.integers(1, 60, size=int(n)).astype(np.int32)
         for n in rng.integers(3, 9, size=4)], pad_id=0)


def _generate(eng, max_new=8):
    out = eng.generate(*_prompts(), None, GenerationHyperparameters(
        max_new_tokens=max_new, min_new_tokens=1, greedy=True), None, 0)
    return out.tokens.numpy(), out.logprobs.numpy(), out.lengths.numpy()


@pytest.fixture(scope="module")
def weights():
    return _weights()


@pytest.fixture(scope="module")
def dense(weights):
    """Greedy output of a d4t2 engine and of the JAX d1t1 engine."""
    jpar = JPar()
    jeng = JEngine(JConfig(**TINY), MeshContext(
        ModelName("m", 0), jmake_mesh(jpar, jax.devices("cpu")[:1]), jpar),
        weights)
    ids, seg, pos = _prompts()
    jout = jax.device_get(jeng.generate(
        ids, seg, pos, jax.random.PRNGKey(7), JGen(
            max_new_tokens=8, min_new_tokens=1, greedy=True), None, 0))
    return _generate(_engine("d4t2", weights)), jout


@pytest.mark.parametrize("layout,view", [("d2t2p2", "d4t2p1"),
                                         ("c4", "d4t1p1"),
                                         ("d2t2p2g4", "d2t4p1"),
                                         ("d4t2g4", "d2t4p1"),
                                         ("c4g2", "d2t2p1")])
def test_generation_through_the_view_matches_dense(weights, dense, layout,
                                                   view):
    """Pipeline and ctx layouts, the ``g`` override, and ``g`` on a plain
    mesh: each generates on a view at d' = n / g, t' = g over the same
    members, and decodes as the dense layouts do."""
    (rt, rl, rn), jout = dense
    eng = _engine(layout, weights)
    assert eng.decode_view_param_bytes() == 0  # built on first use
    t, lp, n = _generate(eng)
    v = eng.decode_engine()
    assert v is not eng and str(v.parallel) == view
    assert v.members == eng.members and v.pipeline_ctx is None
    assert eng.decode_engine() is v  # kept, not rebuilt
    np.testing.assert_array_equal(n, rn)
    np.testing.assert_array_equal(t, rt)
    np.testing.assert_allclose(lp, rl, **TOL)
    np.testing.assert_array_equal(t, np.asarray(jout.tokens))
    np.testing.assert_allclose(lp, np.asarray(jout.logprobs), atol=1e-4)


def test_dense_layouts_decode_in_place(weights):
    eng = _engine("d4t2", weights)
    assert eng.decode_engine() is eng
    _generate(eng)
    assert eng.decode_view_param_bytes() == 0
    eng.drop_decode_view()  # nothing to drop, no error


def test_parse_gen_tp():
    p = parse_parallelism("d2t2p2g4")
    assert p.gen_tp_size == 4 and p.pipeline_parallel_size == 2
    assert "g4" in str(p)
    assert parse_parallelism("d4t2").gen_tp_size == 0
    eng = _engine("p2", _weights())
    with pytest.raises(ValueError, match="does not divide"):
        eng.set_gen_tp(3)
    with pytest.raises(ValueError, match="does not divide"):
        _engine("p2g4", _weights())


def test_view_follows_set_params_and_train_steps(weights):
    """The same view object decodes with the new weights after
    ``set_params`` and after a train step (the port updates in place,
    so the refresh keys on the version and the installs, never on the
    weights object's identity)."""
    eng = _engine("p2", weights, opt=dict(
        lr=1e-1, lr_scheduler_type="constant", warmup_steps_proportion=0))
    t0, _, _ = _generate(eng)
    view = eng.decode_engine()
    fresh = _weights(5)
    eng.set_params(fresh)
    t1, _, _ = _generate(eng)
    assert eng.decode_engine() is view
    np.testing.assert_array_equal(_generate(_engine("d1t1", fresh))[0], t1)
    assert (t0 != t1).any()
    rng = np.random.default_rng(2)
    from realhf_tpu_torch.interfaces import common
    sb = common.build_stream_batch(
        [20, 13], dict(input_ids=rng.integers(1, 60, 33).astype(np.int32),
                       prompt_mask=np.zeros(33, bool)), bucket=16,
        n_streams=eng.n_streams)
    eng.train_batch([sb.arrays], sft._make_loss_fn(eng.cfg), [1.0])
    t2, _, _ = _generate(eng)
    assert eng.decode_engine() is view
    np.testing.assert_array_equal(
        _generate(_engine("d1t1", eng.params_numpy()))[0], t2)
    assert (t2 != t1).any()


def test_drop_frees_and_rebuilds(weights):
    eng = _engine("d2t2p2", weights)
    tok1, lp1, _ = _generate(eng)
    held = eng.decode_view_param_bytes()
    # one logical copy split over the view's t (each model member its
    # own copy of a replicated leaf), replicated over its d: a d4t2 view
    # of the d2t2p2 layout holds 4 copies
    from realhf_tpu_torch.models import sharding
    logical = sum(a.nbytes for a in jax.tree.leaves(weights))
    rep = sum(a.nbytes for (_, spec), a in zip(
        sharding.flat_specs(eng.cfg), jax.tree.leaves(weights))
        if sharding.split_dim(spec) is None)
    assert held == 4 * (logical + rep)
    eng.drop_decode_view()
    assert eng.decode_view_param_bytes() == 0
    assert eng._decode_view.params is None
    tok2, lp2, _ = _generate(eng)  # moved in again
    assert eng.decode_view_param_bytes() == held
    np.testing.assert_array_equal(tok1, tok2)
    np.testing.assert_allclose(lp1, lp2, rtol=0, atol=0)


def test_ppo_with_pipeline_actor_generating_on_g4(tmp_path, monkeypatch):
    """PPO with ``actor_gen_alloc="d2t2p2g4"``: the actor trains at
    d2t2p2 and rolls out on a d2t4 view (an allocation that only adds
    ``g`` is not a replica), dropped after every rollout; the other
    roles at d2t4. Two steps; the rollout ran on the current actor
    weights (importance weight ~1)."""
    import json

    from realhf_tpu_torch.base import constants
    from realhf_tpu_torch.base.testing import IntegerTokenizer
    from realhf_tpu_torch.experiments.common import apply_overrides
    from realhf_tpu_torch.experiments.ppo_exp import PPOConfig
    from realhf_tpu_torch.system.inline import InlineRunner
    monkeypatch.setattr(constants, "ROOT_DIR", str(tmp_path / "root"))
    rng = np.random.default_rng(1)
    path = tmp_path / "prompts.jsonl"
    with open(path, "w") as f:
        for i in range(16):
            f.write(json.dumps({"id": i, "prompt": " ".join(
                f"w{int(x)}" for x in rng.integers(0, 50, 4))}) + "\n")
    cfg = PPOConfig(experiment_name="ppgene2e", trial_name="t0",
                    total_train_epochs=1, benchmark_steps=2,
                    actor_gen_alloc="d2t2p2g4", device="cpu")
    apply_overrides(cfg, {
        "dataset.path": str(path), "dataset.train_bs_n_seqs": "8",
        "dataset.max_seqlen": "16", "ppo.max_new_tokens": "8",
        "ppo.min_new_tokens": "1", "ppo.ppo_n_minibatches": "2",
        "actor.drop_decode_view_after_rollout": "true"})
    spec = cfg.build()
    assert spec.models["actor"].drop_decode_view_after_rollout
    tiny = dict(n_layers=2, n_kv_heads=4, n_q_heads=4, hidden_dim=32,
                intermediate_dim=64, vocab_size=1000, apply_rotary=True,
                layer_norm_type="rms", mlp_type="llama",
                use_attention_bias=False, use_attn_proj_bias=False,
                use_mlp_bias=False, activation_function="silu")
    for role, mspec in spec.models.items():
        mspec.path = None
        mspec.random_init_config = dict(tiny)
        mspec.bf16 = False
        mspec.parallel = parse_parallelism(
            "d2t2p2" if role == "actor" else "d2t4")
        if mspec.optimizer is not None:
            mspec.optimizer = OptimizerConfig(
                lr=1e-3, warmup_steps_proportion=0.0,
                lr_scheduler_type="constant")
    spec.tokenizer = IntegerTokenizer(vocab_size=1000)
    runner = InlineRunner(spec, device="cpu")
    assert "actor_gen" not in runner.host.replicas
    stats = runner.run()
    assert np.isfinite(stats["actor_train"]["actor_loss"])
    assert abs(stats["actor_train"]["importance_weight"] - 1.0) < 0.1
    eng = runner.host.models["actor"].engine
    assert eng.parallel.gen_tp_size == 4  # g4 reached the engine
    view = eng._decode_view
    assert view is not None and str(view.parallel) == "d2t4p1"
    assert view.pipeline_ctx is None
    assert eng.decode_view_param_bytes() == 0 and view.params is None
