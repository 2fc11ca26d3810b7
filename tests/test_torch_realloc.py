"""Parameter reallocation in the port, and the per-MFC layouts it keeps
fresh, against the JAX package.

The cases of the JAX package's ``tests/parallel/test_param_realloc.py``
on the port's engines (members ``["cpu"] * n``, a prime vocabulary so
the padding differs per t): round trips over d/t layouts bit-equal,
inference consistent across layouts, training updates visible after a
reallocation, EMA merging against a plain fp32 lerp, the streamed
install, offload, the critic head. Then ``ReplicaManager`` and the
hooks, and the ``ppo`` experiment at the layout the card's ``par_ppo``
phase runs (actor d1t2, critic d2t1 with ZeRO-1, ``actor_gen_alloc=d2t1``,
``ref_inf_alloc=d1t2``) against the JAX runner at that layout for two
steps, as ``tests/system/test_quickstart.py`` runs JAX's, and ``grpo``
with ``actor_gen_alloc``.

Tolerances: moves are exact. Log-probs across layouts: 1e-5 absolute
(fp32, sums in different orders). EMA: 1e-6 absolute against numpy's
fp32 lerp. Experiments: ``assert_same_steps``'s (2e-5 on per-token
data, 1e-3 relative or 1e-5 absolute on stats).
"""

import jax
import numpy as np
import pytest
import torch

from realhf_tpu.experiments.grpo_exp import GRPOConfig as JGRPOConfig
from realhf_tpu.experiments.ppo_exp import PPOConfig as JPPOConfig
from realhf_tpu_torch.api.config import ModelName
from realhf_tpu_torch.api.dfg import OffloadHook, ParamReallocHook
from realhf_tpu_torch.api.experiment import MFCAllocation
from realhf_tpu_torch.engine.engine import Engine
from realhf_tpu_torch.engine.optim import OptimizerConfig
from realhf_tpu_torch.experiments.grpo_exp import GRPOConfig
from realhf_tpu_torch.experiments.ppo_exp import PPOConfig
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.ops import functional as F
from realhf_tpu_torch.parallel import param_stream
from realhf_tpu_torch.parallel.mesh import ParallelismConfig
from realhf_tpu_torch.parallel.realloc import (
    ReplicaManager,
    install_param_chunks,
    offload_to_host,
    reallocate,
)
from test_torch_rw_dpo import (
    _port_root,  # noqa: F401 - the fixture: a fresh save root per test
    assert_same_steps,
    experiment_runners,
    run_steps,
    write_prompts,
)

VOCAB = 107
TINY = dict(n_layers=2, n_kv_heads=4, n_q_heads=4, hidden_dim=32,
            intermediate_dim=64, vocab_size=VOCAB, apply_rotary=True,
            layer_norm_type="rms", mlp_type="llama",
            use_attention_bias=False, use_attn_proj_bias=False,
            use_mlp_bias=False, activation_function="silu",
            param_dtype="float32", compute_dtype="float32")
LAYOUTS = [(1, 1), (2, 1), (1, 2), (2, 2), (1, 4)]


def _engine(d, t, seed=0, is_critic=False, lr=None):
    cfg = TransformerConfig(**TINY, is_critic=is_critic)
    params = T.init_params(cfg, torch.Generator().manual_seed(seed))
    opt = None if lr is None else OptimizerConfig(
        lr=lr, warmup_steps_proportion=0.0, lr_scheduler_type="constant")
    return Engine(cfg, params, device="cpu",
                  parallel=ParallelismConfig(data_parallel_size=d,
                                             tensor_parallel_size=t),
                  devices=["cpu"] * (d * t), optimizer=opt,
                  total_train_steps=100)


def _equal(a, b):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("src", LAYOUTS)
@pytest.mark.parametrize("dst", LAYOUTS[1:4])
def test_roundtrip_equality(src, dst):
    e_src, e_dst = _engine(*src, seed=3), _engine(*dst, seed=7)
    before = e_src.params_numpy()
    secs = reallocate(e_src.cfg, e_src.params, e_dst)
    assert secs >= 0
    _equal(before, e_dst.params_numpy())
    reallocate(e_src.cfg, e_dst.params, e_src)
    _equal(before, e_src.params_numpy())


def test_inference_consistent_across_layouts():
    e1, e2 = _engine(2, 2, seed=1), _engine(1, 4, seed=2)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, VOCAB, size=(4, 16)).astype(np.int32)
    seg = np.ones_like(ids)
    lp1 = e1.forward_logprobs(ids, seg).numpy()
    reallocate(e1.cfg, e1.params, e2)
    np.testing.assert_allclose(e2.forward_logprobs(ids, seg).numpy(), lp1,
                               rtol=0, atol=1e-5)


def test_training_updates_propagate():
    train_e, gen_e = _engine(2, 2, seed=5, lr=1e-2), _engine(1, 4, seed=9)
    cfg = train_e.cfg
    rng = np.random.default_rng(1)
    ids = rng.integers(0, VOCAB, size=(2, 16)).astype(np.int32)
    seg = np.ones_like(ids)

    def loss_fn(p, mb):
        h, _ = T.forward(cfg, p, mb["input_ids"], mb["seg_ids"])
        lp = F.shifted_logprobs_from_hidden(cfg, p, h, mb["input_ids"],
                                            mb["seg_ids"])
        return -lp.mean(), {}

    reallocate(cfg, train_e.params, gen_e)
    before = gen_e.forward_logprobs(ids, seg).numpy()
    for _ in range(3):
        train_e.train_batch([dict(input_ids=ids, seg_ids=seg)], loss_fn)
    reallocate(cfg, train_e.params, gen_e)
    after = gen_e.forward_logprobs(ids, seg).numpy()
    assert np.abs(after - before).max() > 1e-3
    np.testing.assert_allclose(after, train_e.forward_logprobs(
        ids, seg).numpy(), rtol=0, atol=1e-5)


def test_ema_reallocation():
    src, dst = _engine(2, 2, seed=11), _engine(1, 2, seed=12)
    a, b = src.params_numpy(), dst.params_numpy()
    reallocate(src.cfg, src.params, dst, eta=0.3)
    for x, y, z in zip(jax.tree.leaves(a), jax.tree.leaves(b),
                       jax.tree.leaves(dst.params_numpy())):
        np.testing.assert_allclose(
            z, (np.float32(0.3) * x + np.float32(0.7) * y), rtol=0,
            atol=1e-6)


@pytest.mark.parametrize("dst", [(1, 1), (2, 2), (1, 4)])
def test_streamed_install_matches_reallocate(dst):
    src = _engine(1, 2, seed=14)
    flat = param_stream.flatten_params(src.params_numpy())
    chunks = param_stream.plan_chunks(flat, 4096)
    e = _engine(*dst, seed=15)
    secs, nbytes = install_param_chunks(
        src.cfg, e, len(chunks),
        lambda i: param_stream.chunk_payload(flat, chunks[i]))
    assert nbytes == param_stream.build_manifest(flat, chunks)["total_bytes"]
    _equal(src.params_numpy(), e.params_numpy())
    with pytest.raises(AssertionError, match="missed leaves"):
        install_param_chunks(src.cfg, e, 1, lambda i: param_stream
                             .chunk_payload(flat, chunks[0]))


def test_offload_roundtrip():
    e = _engine(2, 2, seed=13)
    before = e.params_numpy()
    host = offload_to_host(e.params)
    assert all(x.device.type == "cpu" for tr in host.trees
               for x in jax.tree.leaves(tr))
    other = _engine(1, 4, seed=1)
    other.set_params(host)
    _equal(before, other.params_numpy())
    one = _engine(1, 1, seed=2)
    e.set_params(offload_to_host(one.params))
    _equal(one.params_numpy(), e.params_numpy())


def test_critic_roundtrip():
    e1, e2 = _engine(2, 1, seed=20, is_critic=True), _engine(
        1, 2, seed=21, is_critic=True)
    before = e1.params_numpy()
    reallocate(e1.cfg, e1.params, e2)
    reallocate(e1.cfg, e2.params, e1)
    _equal(before, e1.params_numpy())


class _Model:
    def __init__(self, engine):
        self.engine, self.config = engine, engine.cfg

        class V:
            global_step = 0
        self.version = V()


def test_replica_manager_refreshes_on_a_new_version():
    mgr = ReplicaManager()
    primary, replica = _Model(_engine(2, 2, seed=1)), _Model(_engine(1, 2))
    mgr.ensure_fresh("actor", primary, replica)
    assert len(mgr.reshard_secs) == 1
    mgr.ensure_fresh("actor", primary, replica)  # same version: no move
    mgr.ensure_fresh("actor", primary, primary)
    assert len(mgr.reshard_secs) == 1
    primary.version.global_step = 1
    mgr.ensure_fresh("actor", primary, replica, eta=0.5)
    assert len(mgr.reshard_secs) == 2 and mgr.last_reshard_secs is not None
    _equal(primary.engine.params_numpy(), replica.engine.params_numpy())


def test_hooks_and_allocations():
    from realhf_tpu_torch.api.config import (
        ModelInterfaceAbstraction,
        ModelInterfaceType,
    )
    from realhf_tpu_torch.api.dfg import MFCDef
    node = MFCDef("ref_inf", 4, ModelInterfaceType.INFERENCE,
                  ModelInterfaceAbstraction("ref"), "ref")
    node.add_pre_hook(ParamReallocHook(source=ModelName("actor", 0),
                                       eta=0.1))
    node.add_post_hook(ParamReallocHook(target=ModelName("actor", 0)))
    node.add_post_hook(OffloadHook())
    assert len(node._pre_hooks) == 1 and len(node._post_hooks) == 2
    with pytest.raises(ValueError, match="post hook"):
        node.add_pre_hook(OffloadHook())
    with pytest.raises(NotImplementedError, match="item 5"):
        MFCAllocation(parallel=ParallelismConfig(), workers=[1])
    spec = PPOConfig(actor_gen_alloc="d2t1", ref_inf_alloc="t2").build()
    assert spec.alloc_of("actor_gen").parallel.data_parallel_size == 2
    assert spec.alloc_of("ref_inf").parallel.tensor_parallel_size == 2
    assert spec.alloc_of("critic_inf") is None
    # the heuristic keeps the manual fields (the quickstart adds its
    # plan after the build); the searched allocation is still owed
    spec = PPOConfig(allocation_mode="heuristic", ref_inf_alloc="t2").build()
    assert spec.alloc_of("ref_inf").parallel.tensor_parallel_size == 2
    with pytest.raises(NotImplementedError, match="item 7"):
        PPOConfig(allocation_mode="search").build()


PAR_PPO = {"actor.parallel.tensor_parallel_size": "2",
           "critic.parallel.data_parallel_size": "2",
           "actor_gen_alloc": "d2t1", "ref_inf_alloc": "d1t2"}


def test_ppo_with_per_mfc_layouts_matches_jax(tmp_path):
    path = str(tmp_path / "prompts.jsonl")
    write_prompts(path)
    overrides = {
        "dataset.path": path, "dataset.train_bs_n_seqs": "8",
        "dataset.max_seqlen": "16", "ppo.max_new_tokens": "6",
        "ppo.min_new_tokens": "2", "ppo.greedy": "true",
        "ppo.ppo_n_minibatches": "2", "actor_train_n_mbs": "2",
        "benchmark_steps": "2", **PAR_PPO}
    for role in ("actor", "critic"):
        overrides.update({f"{role}.optimizer.lr": "1e-3",
                          f"{role}.optimizer.lr_scheduler_type": "constant",
                          f"{role}.optimizer.warmup_steps_proportion": "0"})
    jr, runner = experiment_runners(JPPOConfig, PPOConfig, overrides,
                                    tiny=dict(TINY))
    assert set(runner.replicas) == set(jr.replicas) == {"actor_gen",
                                                        "ref_inf"}
    actor, critic = runner.models["actor"].engine, runner.models[
        "critic"].engine
    assert (actor.parallel.tensor_parallel_size,
            critic.parallel.data_parallel_size) == (2, 2)
    assert critic._zero1 is not None and actor.sharded
    got = run_steps(runner)
    assert_same_steps(got, run_steps(jr))
    # the gen replica held the trained actor at step 2: its importance
    # weights stay at 1 after a reallocation
    for _, stats in got:
        assert abs(stats["actor_train"]["importance_weight"] - 1) < 0.1
    # refreshed before step 1 (the set weights) and step 2 (trained)
    assert len(runner.replica_mgr.reshard_secs) == 3


def test_grpo_with_actor_gen_alloc_matches_jax(tmp_path):
    path = str(tmp_path / "prompts.jsonl")
    write_prompts(path)
    overrides = {
        "dataset.path": path, "dataset.train_bs_n_seqs": "4",
        "dataset.max_seqlen": "16", "grpo.group_size": "3",
        "grpo.greedy": "true", "grpo.max_new_tokens": "6",
        "grpo.min_new_tokens": "2", "grpo.ppo_n_minibatches": "2",
        "grpo.reward_output_scaling": "0", "grpo.kl_coef": "0.1",
        "benchmark_steps": "2", "actor_gen_alloc": "d1t2",
        "actor.optimizer.lr": "1e-2",
        "actor.optimizer.lr_scheduler_type": "constant",
        "actor.optimizer.warmup_steps_proportion": "0"}
    jr, runner = experiment_runners(JGRPOConfig, GRPOConfig, overrides,
                                    tiny=dict(TINY))
    assert set(runner.replicas) == {"actor_gen"}
    assert_same_steps(run_steps(runner), run_steps(jr))
    assert len(runner.replica_mgr.reshard_secs) == 2


@pytest.mark.parametrize("ref_layout,alloc", [
    ("d1t1", "d2t1"),
    # a one-tree replica of a d2t1 primary, and one of the role's own
    # layout placed with device_ids: each must hold weights of its own
    ("d2t1", "d1t1"),
    ("d1t1", "device_ids"),
])
def test_eta_pre_hook_merges_into_the_replica(tmp_path, ref_layout, alloc):
    """An EMA ``ParamReallocHook`` pre-hook on a replica's MFC: the
    replica receives 0.5 * primary + 0.5 * its own weights, and the
    primary keeps its own."""
    from realhf_tpu_torch.base.testing import IntegerTokenizer
    from realhf_tpu_torch.experiments.common import apply_overrides
    from realhf_tpu_torch.parallel.mesh import parse_parallelism
    from realhf_tpu_torch.system.inline import InlineRunner
    path = str(tmp_path / "prompts.jsonl")
    write_prompts(path)
    cfg = PPOConfig(experiment_name="eta", trial_name="t0")
    apply_overrides(cfg, {"dataset.path": path,
                          "dataset.train_bs_n_seqs": "4",
                          "ppo.max_new_tokens": "4",
                          "ppo.min_new_tokens": "2", "ppo.greedy": "true",
                          "ppo.ppo_n_minibatches": "1"})
    spec = cfg.build()
    for m in spec.models.values():
        m.random_init_config = dict(TINY)
        m.bf16 = False
    spec.models["ref"].parallel = parse_parallelism(ref_layout)
    spec.allocations["ref_inf"] = (
        MFCAllocation(ParallelismConfig(), device_ids=[0])
        if alloc == "device_ids" else parse_parallelism(alloc))
    spec.tokenizer = IntegerTokenizer(100)
    node = next(n for n in spec.mfcs if n.name == "ref_inf")
    node.add_pre_hook(ParamReallocHook(source=ModelName("ref", 0), eta=0.5))
    runner = InlineRunner(spec, device="cpu", devices=["cpu"] * 2)
    replica = runner.replicas["ref_inf"].engine
    mine = replica.params_numpy()
    src = _engine(1, 1, seed=30)
    other = src.params_numpy()
    primary = runner.models["ref"]
    # in place, so a replica sharing the primary's tensors would see it
    reallocate(primary.config, src.params, primary.engine)
    runner.run_step(next(iter(runner.dataloader)))
    for x, y in zip(jax.tree.leaves(other), jax.tree.leaves(
            primary.engine.params_numpy())):
        np.testing.assert_array_equal(x, y)
    for x, y, z in zip(jax.tree.leaves(other), jax.tree.leaves(mine),
                       jax.tree.leaves(replica.params_numpy())):
        np.testing.assert_allclose(z, np.float32(0.5) * x
                                   + np.float32(0.5) * y, rtol=0, atol=1e-6)


def test_device_ids_place_the_replica(tmp_path):
    """An ``MFCAllocation`` with ``device_ids`` indexes the runner's
    devices; a count that does not fit its layout raises."""
    from realhf_tpu_torch.base.testing import IntegerTokenizer
    from realhf_tpu_torch.parallel.mesh import parse_parallelism
    from realhf_tpu_torch.system.inline import InlineRunner
    path = str(tmp_path / "prompts.jsonl")
    write_prompts(path)

    def spec_with(alloc):
        cfg = PPOConfig(experiment_name="ids", trial_name="t0")
        cfg.dataset.path = path
        spec = cfg.build()
        for m in spec.models.values():
            m.random_init_config = dict(TINY)
            m.bf16 = False
        spec.tokenizer = IntegerTokenizer(100)
        spec.allocations["ref_inf"] = alloc
        return spec

    runner = InlineRunner(spec_with(MFCAllocation(
        parse_parallelism("d2t1"), device_ids=[1, 0])), device="cpu",
        devices=["cpu"] * 2)
    eng = runner.replicas["ref_inf"].engine
    assert eng.members == [torch.device("cpu")] * 2 and eng.sharded
    with pytest.raises(ValueError, match="device_ids"):
        InlineRunner(spec_with(MFCAllocation(
            parse_parallelism("d2t1"), device_ids=[0])), device="cpu")
    # the role's own layout is not a replica
    same = InlineRunner(spec_with(ParallelismConfig()), device="cpu")
    assert same.replicas == {}
