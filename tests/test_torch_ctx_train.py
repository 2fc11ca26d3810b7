"""Training on context-parallel layouts in the port on the CPU: the
engine at ``c2``, ``c2t2`` and ``d2c2t2s`` against the JAX package's
``Engine`` at the same layout (the JAX package's own context-parallel
test config, ``tests/ops/test_ring_attention.py``) from the same numpy
weights: ``forward_logprobs``, then two train steps (loss, grad norm,
updated weights); c with p refused with the JAX package's message; the
``sft`` experiment at a c2 allocation against the JAX runner; a
reallocation round trip ``c2 -> d2t1 -> d1c2t2s``.

fp32 on both sides, inputs from a numpy seed. Tolerances: log-probs
1e-5 (values of order 4, sums in other orders: the JAX ring's blockwise
autodiff against the port's per-round schedule); loss 1e-6 and grad norm
1e-5 relative; weights 1e-5 absolute after two AdamW steps at lr 5e-3
(an update of ~5e-3 an element; where a moment is tiny AdamW amplifies
a gradient's last bits). The sft run: 1e-4 relative, as the sft
end-to-end test holds one-device runs. Reallocation: bit-equal.
"""

import jax
import numpy as np
import pytest
import torch

from realhf_tpu.api.config import ModelName
from realhf_tpu.engine.engine import Engine as JEngine
from realhf_tpu.engine.optim import OptimizerConfig as JOptimizer
from realhf_tpu.models import transformer as JT
from realhf_tpu.models.config import TransformerConfig as JConfig
from realhf_tpu.ops import functional as JF
from realhf_tpu.parallel.mesh import MeshContext
from realhf_tpu.parallel.mesh import make_mesh as jmake_mesh
from realhf_tpu.parallel.mesh import parse_parallelism as jparse
from realhf_tpu_torch.engine.engine import Engine
from realhf_tpu_torch.engine.optim import OptimizerConfig
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.ops import functional as F
from realhf_tpu_torch.parallel.mesh import parse_parallelism
from realhf_tpu_torch.parallel.realloc import reallocate

# the JAX package's context-parallel test config
CFG = dict(n_layers=2, n_kv_heads=2, n_q_heads=4, hidden_dim=32,
           intermediate_dim=64, vocab_size=64, apply_rotary=True,
           layer_norm_type="rms", mlp_type="llama", use_attention_bias=False,
           use_attn_proj_bias=False, use_mlp_bias=False,
           activation_function="silu", compute_dtype="float32")
OPT = dict(lr=5e-3, warmup_steps_proportion=0.0,
           lr_scheduler_type="constant")
LAYOUTS = ("c2", "c2t2", "d2c2t2s")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops over several members crawl beside the other xdist
    workers' threads: one intra-op thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray, JT.init_params(JConfig(**CFG),
                                                   jax.random.PRNGKey(0)))


def _batch():
    """Two streams of 32 tokens: records that cross the c2 shards (16
    tokens) and the c2t2s ones (8), and padding."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, size=(2, 32)).astype(np.int32)
    seg = np.ones_like(ids)
    seg[0, 11:27] = 2
    seg[0, 27:] = 0
    seg[1, 19:] = 3
    return ids, seg


def _jax_run(layout, weights, ids, seg):
    cfg = JConfig(**CFG)
    par = jparse(layout)
    mesh = jmake_mesh(par, devices=jax.devices("cpu")[:par.world_size])
    eng = JEngine(cfg, MeshContext(ModelName("m", 0), mesh, par),
                  jax.tree.map(np.copy, weights),
                  optimizer=JOptimizer(**OPT), total_train_steps=50)

    def loss_fn(p, mb):
        h, _ = JT.forward(cfg, p, mb["input_ids"], mb["seg_ids"],
                          attention_fn=eng.attention_fn)
        lp = JF.shifted_logprobs_from_hidden(cfg, p, h, mb["input_ids"],
                                             mb["seg_ids"])
        return -lp.mean(), {}

    lp = np.asarray(eng.forward_logprobs(ids, seg))
    steps = [eng.train_batch([dict(input_ids=ids, seg_ids=seg)], loss_fn,
                             loss_fn_key="cp") for _ in range(2)]
    return lp, steps, eng.params_numpy()


def _port_run(layout, weights, ids, seg):
    cfg = TransformerConfig(**CFG)
    par = parse_parallelism(layout)
    eng = Engine(cfg, weights, device="cpu", parallel=par,
                 devices=["cpu"] * par.world_size,
                 optimizer=OptimizerConfig(**OPT), total_train_steps=50)

    def loss_fn(p, mb):
        h, _ = T.forward(cfg, p, mb["input_ids"], mb["seg_ids"])
        lp = F.shifted_logprobs_from_hidden(cfg, p, h, mb["input_ids"],
                                            mb["seg_ids"])
        return -lp.mean(), {}

    lp = eng.forward_logprobs(ids, seg).numpy()
    steps = [eng.train_batch([dict(input_ids=ids, seg_ids=seg)], loss_fn)
             for _ in range(2)]
    return lp, steps, eng.params_numpy(), eng


@pytest.mark.parametrize("layout", LAYOUTS)
def test_train_steps_match_the_jax_engine(weights, layout):
    """The forward and two steps through the ring's backward (K2/K3
    rounds; their plain arithmetic here), at c2, c2t2 and d2c2t2s. The
    copies of each leaf (context members on several devices, data
    replicas) stay equal after the steps."""
    ids, seg = _batch()
    jlp, jsteps, jw = _jax_run(layout, weights, ids, seg)
    lp, steps, w, eng = _port_run(layout, weights, ids, seg)
    np.testing.assert_allclose(lp, jlp, rtol=1e-5, atol=1e-5)
    for got, want in zip(steps, jsteps):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-5)
    assert steps[1]["loss"] < steps[0]["loss"]
    for a, b in zip(jax.tree.leaves(w), jax.tree.leaves(jw)):
        np.testing.assert_allclose(a, b, atol=1e-5)
    from realhf_tpu_torch.engine.engine import _leaves
    t = eng.parallel.tensor_parallel_size
    for i in eng.units:  # member i holds model slice i % t
        for a, b in zip(_leaves(eng.params.trees[i]),
                        _leaves(eng.params.trees[i % t])):
            assert torch.equal(a, b)


def test_context_with_pipeline_raises_the_jax_message(weights):
    msg = ("pipeline parallelism cannot be combined with context "
           r"parallelism \(ring attention\) yet; use pp x tp x dp or "
           "cp x tp x dp.")
    for layout in ("c2p2", "d2c2p2"):
        par = parse_parallelism(layout)
        with pytest.raises(NotImplementedError, match=msg):
            Engine(TransformerConfig(**CFG), weights, device="cpu",
                   parallel=par, devices=["cpu"] * par.world_size)


def test_moe_router_losses_at_c2_raise():
    """A mixture-of-experts model trains at c2 (no longer refused): its
    router losses are formed from both context shards' sums, so a train
    step equals the d1t1 engine's (held against the JAX engine at c2 by
    ``test_torch_moe_parallel.py``)."""
    from realhf_tpu_torch.models.config import MoEConfig
    cfg = TransformerConfig(**dict(CFG, mlp_type="moe",
                                   moe=MoEConfig(num_experts=4, top_k=2,
                                                 z_loss_coeff=1e-3)))
    w = T.init_params(cfg, torch.Generator().manual_seed(0))
    engs = [Engine(cfg, w, device="cpu", parallel=parse_parallelism(lay),
                   devices=["cpu"] * n, optimizer=OptimizerConfig(**OPT),
                   total_train_steps=2)
            for lay, n in (("c2", 2), ("d1t1", 1))]
    ids, seg = _batch()

    def loss_fn(p, mb):
        _, _, aux = T.forward(cfg, p, mb["input_ids"], mb["seg_ids"],
                              return_aux=True)
        return sum(aux.values()), {k: v for k, v in aux.items()}

    got, want = (e.train_batch([dict(input_ids=ids, seg_ids=seg)], loss_fn)
                 for e in engs)
    assert set(got) >= {"moe_aux_loss", "moe_z_loss"}
    for k in ("loss", "grad_norm", "moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(engs[0].forward_logprobs(ids, seg).numpy(),
                               engs[1].forward_logprobs(ids, seg).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_reallocation_round_trip_through_context_layouts(weights):
    """c2 -> d2t1 -> d1c2t2s -> the canonical tree, bit-equal to the
    weights it started from; the c layouts' context copies share a tree
    per device."""
    cfg = TransformerConfig(**CFG)
    engines = []
    for layout in ("c2", "d2t1", "d1c2t2s"):
        par = parse_parallelism(layout)
        engines.append(Engine(cfg, None if engines else weights,
                              device="cpu", parallel=par,
                              devices=["cpu"] * par.world_size))
    for src, dst in zip(engines, engines[1:]):
        reallocate(cfg, src.params, dst)
    assert engines[0].units == [0] and engines[2].units == [0, 1]
    for a, b in zip(jax.tree.leaves(engines[2].params_numpy()),
                    jax.tree.leaves(weights)):
        np.testing.assert_array_equal(a, b)


def test_sft_experiment_at_c2_matches_jax(tmp_path, monkeypatch):
    """The ``sft`` experiment with its model at c2 (the ``*.parallel``
    override of both packages' CLI) against the JAX runner at one
    device: two steps of two microbatches."""
    from realhf_tpu.base.testing import IntegerTokenizer as JaxTokenizer
    from realhf_tpu.experiments.common import apply_overrides as jax_over
    from realhf_tpu.experiments.sft_exp import SFTConfig as JaxSFTConfig
    from realhf_tpu.system.inline import InlineRunner as JaxRunner
    from realhf_tpu_torch.base import constants
    from realhf_tpu_torch.base.testing import IntegerTokenizer
    from realhf_tpu_torch.experiments.common import apply_overrides
    from realhf_tpu_torch.experiments.sft_exp import SFTConfig
    from realhf_tpu_torch.system.inline import InlineRunner
    from test_torch_sft_e2e import _data, _spec
    monkeypatch.setattr(constants, "ROOT_DIR", str(tmp_path / "port_root"))
    path = str(tmp_path / "sft.jsonl")
    _data(path)
    jr = JaxRunner(_spec(JaxSFTConfig, jax_over,
                         JaxTokenizer(vocab_size=1000), path))

    def c2(cfg, overrides):
        return apply_overrides(cfg, dict(
            overrides, **{"model.parallel.context_parallel_size": "2"}))

    spec = _spec(SFTConfig, c2, IntegerTokenizer(vocab_size=1000), path)
    assert str(spec.models["default"].parallel) == "d1t1p1c2"
    runner = InlineRunner(spec, device="cpu")
    eng = runner.models["default"].engine
    assert eng.members == [torch.device("cpu")] * 2
    eng.set_params(jr.models["default"].engine.params_numpy())
    batches = list(jr.dataloader)
    want = [jr.run_step(b)["trainDefault"] for b in batches]
    got = [runner.run_step(b)["trainDefault"] for b in batches]
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm", "nll", "n_tokens"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)


def test_ppo_with_the_critic_trained_at_c2_matches_c1(tmp_path,
                                                      monkeypatch):
    """``critic.parallel.context_parallel_size=2`` with
    ``critic_inf_alloc=c2`` (the critic's own layout, so no replica):
    the critic's inference and its train MFC run at c2, and one greedy
    PPO step gives the c1 run's stats (1e-4 relative or 1e-6 absolute;
    a clip ratio within one token)."""
    from realhf_tpu_torch.base import constants
    from realhf_tpu_torch.base.testing import IntegerTokenizer
    from realhf_tpu_torch.experiments.common import apply_overrides
    from realhf_tpu_torch.experiments.ppo_exp import PPOConfig
    from realhf_tpu_torch.system.inline import InlineRunner
    from test_torch_ppo_e2e import _prompts, _spec
    monkeypatch.setattr(constants, "ROOT_DIR", str(tmp_path / "port_root"))
    path = str(tmp_path / "prompts.jsonl")
    _prompts(path)
    runs = {}
    for tag, extra in (("c1", {}), ("c2", {
            "critic.parallel.context_parallel_size": "2",
            "critic_inf_alloc": "c2"})):
        spec = _spec(PPOConfig, apply_overrides,
                     IntegerTokenizer(vocab_size=100), path,
                     benchmark_steps="1", **extra)
        runner = InlineRunner(spec, device="cpu")
        runner.run()
        runs[tag] = runner
    c2 = runs["c2"]
    assert c2.models["critic"].engine.members == [torch.device("cpu")] * 2
    assert "critic_inf" not in c2.replicas
    want = runs["c1"].step_stats
    assert len(c2.step_stats) == len(want) == 1
    for mfc in want[0]:
        n_tokens = want[0]["actor_train"]["n_tokens"]
        for k, v in want[0][mfc].items():
            atol = 1.0 / n_tokens if k.endswith("clip_ratio") else 1e-6
            np.testing.assert_allclose(c2.step_stats[0][mfc][k], v,
                                       rtol=1e-4, atol=atol,
                                       err_msg=f"{mfc} {k}")
