"""Context-parallel inference in the port on the CPU: the port's ``c4``
Engine over ``[cpu] * 4`` against the JAX package's ``c4`` Engine on the
virtual CPU mesh with its fused ring kernel engaged
(``REALHF_TPU_FUSED_RING=1``, Pallas interpret mode), and against the
port's own ``c1`` Engine; a stream length that is not a multiple of the
members; what still raises on a ``c4`` layout; the model host's and the
runner's wiring; and a tiny ``ppo`` run with ``ref`` and ``reward`` at
``c4`` whose stats equal the ``c1`` run's.

Tolerances: fp32 on both sides. Log-probs and values of order 1-5 from
two layers: 1e-4 absolute against JAX (its Pallas kernel sums in other
tiles, 2e-4 in the JAX package's own engine test), 1e-5 port against
port (the same arithmetic but the ring's order of sums). Against ``c1``
only tokens with seg != 0 count: the plain single-device path averages
a padding row over its masked keys where the ring writes 0, and those
rows feed no output. PPO stats: 1e-4 relative or 1e-6 absolute (the
same rollout; reference log-probs and rewards apart by ~1e-7); a clip
ratio, a share of tokens past a threshold, within one token.
"""

import jax
import numpy as np
import pytest

from realhf_tpu.api.config import ModelName
from realhf_tpu.engine.engine import Engine as JEngine
from realhf_tpu.models import transformer as JT
from realhf_tpu.models.config import TransformerConfig as JConfig
from realhf_tpu.parallel.mesh import MeshContext
from realhf_tpu.parallel.mesh import ParallelismConfig as JParallel
from realhf_tpu.parallel.mesh import default_devices, make_mesh
from realhf_tpu_torch.engine.engine import Engine
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.parallel.mesh import ParallelismConfig

TINY = dict(n_layers=2, n_kv_heads=2, n_q_heads=4, hidden_dim=32,
            intermediate_dim=64, vocab_size=128, apply_rotary=True,
            layer_norm_type="rms", mlp_type="llama",
            use_attention_bias=False, use_attn_proj_bias=False,
            use_mlp_bias=False, activation_function="silu",
            param_dtype="float32", compute_dtype="float32")
C4 = ParallelismConfig(context_parallel_size=4)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
PORT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _port_root(tmp_path, monkeypatch):
    """The port's runner saves its trained roles at the end of ``run``:
    under a fresh root per test."""
    from realhf_tpu_torch.base import constants
    monkeypatch.setattr(constants, "ROOT_DIR", str(tmp_path / "port_root"))


def _batch(l=64, seed=0):
    """Two streams: three documents in one, two and padding in the
    other, so documents straddle the members' shards."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 100, size=(2, l)).astype(np.int32)
    seg = np.zeros((2, l), np.int32)
    seg[0, :l // 3], seg[0, l // 3:l - 5], seg[0, l - 5:] = 1, 2, 3
    seg[1, :l // 2 + 3], seg[1, l // 2 + 3:l - 6] = 1, 2
    mask = rng.random((2, l, TINY["vocab_size"])) > 0.3
    return ids, seg, mask


@pytest.fixture(scope="module")
def engines():
    """The JAX c4 engine with the fused ring, and the port's c4 and c1
    engines on its weights, for a policy and a critic."""
    mp = pytest.MonkeyPatch()
    mp.setenv("REALHF_TPU_FUSED_RING", "1")
    out = {}
    try:
        par = JParallel(context_parallel_size=4)
        for critic in (False, True):
            jcfg = JConfig(**TINY, is_critic=critic)
            ctx = MeshContext(ModelName("t", 0),
                              make_mesh(par, devices=default_devices()[:4]),
                              par)
            jeng = JEngine(jcfg, ctx, JT.init_params(
                jcfg, jax.random.PRNGKey(3 + critic)))
            assert jeng.attention_fn_inference is not None  # fused ring on
            weights = jeng.params_numpy()
            cfg = TransformerConfig(**TINY, is_critic=critic)
            out[critic] = dict(
                jax=jeng,
                c4=Engine(cfg, weights, device="cpu", parallel=C4,
                          devices=["cpu"] * 4),
                c1=Engine(cfg, weights, device="cpu"))
    finally:
        mp.undo()
    return out


def test_forward_logprobs_matches_jax_c4_and_port_c1(engines):
    ids, seg, mask = _batch()
    e = engines[False]
    for lmask in (None, mask):
        got = e["c4"].forward_logprobs(ids, seg, logits_mask=lmask).numpy()
        want = np.asarray(e["jax"].forward_logprobs(ids, seg,
                                                    logits_mask=lmask))
        np.testing.assert_allclose(got, want, **JAX_TOL)
        c1 = e["c1"].forward_logprobs(ids, seg, logits_mask=lmask).numpy()
        np.testing.assert_allclose(got, c1, **PORT_TOL)
    hid = e["c4"].forward_hidden(ids, seg).numpy()
    hid1 = e["c1"].forward_hidden(ids, seg).numpy()
    np.testing.assert_allclose(hid[seg != 0], hid1[seg != 0], **PORT_TOL)


def test_forward_values_matches_jax_c4_and_port_c1(engines):
    ids, seg, _ = _batch(seed=1)
    e = engines[True]
    got = e["c4"].forward_values(ids, seg).numpy()
    np.testing.assert_allclose(
        got, np.asarray(e["jax"].forward_values(ids, seg)), **JAX_TOL)
    c1 = e["c1"].forward_values(ids, seg).numpy()
    np.testing.assert_allclose(got[seg != 0], c1[seg != 0], **PORT_TOL)


@pytest.mark.parametrize("l", [50, 37, 9])
def test_stream_length_not_a_multiple_of_the_members(engines, l):
    """L is padded to a multiple of 4 * 8 with seg 0 inside the engine
    and the outputs cut back to L."""
    ids, seg, mask = _batch(l=l, seed=2)
    for critic, call in ((False, "forward_logprobs"),
                         (True, "forward_values")):
        e = engines[critic]
        got = getattr(e["c4"], call)(ids, seg).numpy()
        want = getattr(e["c1"], call)(ids, seg).numpy()
        assert got.shape == (2, l)
        np.testing.assert_allclose(got[seg != 0], want[seg != 0],
                                   **PORT_TOL)
    got = engines[False]["c4"].forward_logprobs(ids, seg, logits_mask=mask)
    want = engines[False]["c1"].forward_logprobs(ids, seg, logits_mask=mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **PORT_TOL)


def test_members_that_share_a_device_share_its_weights(engines):
    eng = engines[False]["c4"]
    assert eng.members == [eng.device] * 4
    assert all(p is eng.params for p in eng._member_params)
    eng.offload()  # on the CPU only the flags move
    assert eng.offloaded
    eng.ensure_on_device()
    assert all(p is eng.params for p in eng._member_params)


def test_training_and_generation_on_c4_still_raise(engines):
    from realhf_tpu_torch.engine.optim import OptimizerConfig
    eng = engines[False]["c4"]
    with pytest.raises(NotImplementedError, match="queue 5"):
        eng.train_minibatches([], None)
    with pytest.raises(NotImplementedError, match="queue 5"):
        eng.train_batch([], None)
    with pytest.raises(NotImplementedError, match="decode view"):
        eng.generate(None, None, None, None, None, None, 0)
    with pytest.raises(NotImplementedError, match="queue 5"):
        Engine(eng.cfg, eng.params_numpy(), device="cpu", parallel=C4,
               devices=["cpu"] * 4, optimizer=OptimizerConfig())
    with pytest.raises(NotImplementedError, match="queue 5"):
        Engine(eng.cfg, eng.params_numpy(), device="cpu",
               parallel=ParallelismConfig(tensor_parallel_size=2),
               devices=["cpu"] * 2)


def test_model_host_builds_c4_for_inference_roles_only():
    from realhf_tpu_torch.api.experiment import ModelSpec
    from realhf_tpu_torch.engine.optim import OptimizerConfig
    from realhf_tpu_torch.system.model_host import build_model
    spec = ModelSpec(random_init_config=dict(TINY), parallel=C4, bf16=False)
    model = build_model("ref", spec, None, init_seed=1, device="cpu",
                        inference_only=True)
    assert model.engine.members == [model.engine.device] * 4
    one = build_model("ref", ModelSpec(random_init_config=dict(TINY),
                                       bf16=False), None, init_seed=1,
                      device="cpu")
    # the same seed draws the same weights on the first member's device
    for a, b in zip(model.engine.params_numpy()["blocks"]["attn"].values(),
                    one.engine.params_numpy()["blocks"]["attn"].values()):
        np.testing.assert_array_equal(a, b)
    explicit = build_model("ref", spec, None, init_seed=1, device="cpu",
                           devices=["cpu"] * 4, inference_only=True)
    assert len(explicit.engine.members) == 4
    with pytest.raises(NotImplementedError, match="queue 5"):
        build_model("actor", spec, None, init_seed=1, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 5"):
        build_model("actor", ModelSpec(
            random_init_config=dict(TINY), optimizer=OptimizerConfig(),
            parallel=ParallelismConfig(data_parallel_size=2)), None,
            init_seed=1, device="cpu", inference_only=True)


def test_ppo_with_ref_and_reward_at_c4_matches_c1(tmp_path):
    """Both packages' spelling of the layout
    (``ref.parallel.context_parallel_size=4``) reaches the role specs;
    two greedy PPO steps give the c1 run's stats."""
    from realhf_tpu_torch.base.testing import IntegerTokenizer
    from realhf_tpu_torch.experiments.common import apply_overrides
    from realhf_tpu_torch.experiments.ppo_exp import PPOConfig
    from realhf_tpu_torch.system.inline import InlineRunner
    from test_torch_ppo_e2e import _prompts, _spec
    path = str(tmp_path / "prompts.jsonl")
    _prompts(path)
    ctx = {"ref.parallel.context_parallel_size": "4",
           "rew.parallel.context_parallel_size": "4"}
    runs = {}
    for tag, extra in (("c1", {}), ("c4", ctx)):
        spec = _spec(PPOConfig, apply_overrides,
                     IntegerTokenizer(vocab_size=100), path, **extra)
        runner = InlineRunner(spec, device="cpu")
        runner.run()
        runs[tag] = runner
    c4 = runs["c4"]
    assert c4.spec.models["ref"].parallel == C4
    assert c4.spec.models["reward"].parallel == C4
    for role in ("ref", "reward"):
        assert len(c4.models[role].engine.members) == 4
    assert len(c4.step_stats) == len(runs["c1"].step_stats) == 2
    for got, want in zip(c4.step_stats, runs["c1"].step_stats):
        assert got.keys() == want.keys()
        for mfc in want:
            n_tokens = want["actor_train"]["n_tokens"]
            for k, v in want[mfc].items():
                # a clip ratio counts tokens past a threshold: one within
                # ~1e-7 of it may land on either side
                atol = 1.0 / n_tokens if k.endswith("clip_ratio") else 1e-6
                np.testing.assert_allclose(got[mfc][k], v, rtol=1e-4,
                                           atol=atol, err_msg=f"{mfc} {k}")
    batch, batch1 = c4.last_batch, runs["c1"].last_batch
    np.testing.assert_array_equal(batch.data["packed_input_ids"],
                                  batch1.data["packed_input_ids"])
    for key in ("packed_ref_logprobs", "rewards"):
        np.testing.assert_allclose(batch.data[key], batch1.data[key],
                                   rtol=1e-5, atol=1e-5)
