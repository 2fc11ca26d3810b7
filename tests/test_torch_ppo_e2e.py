"""The PPO slice end to end: the ``ppo`` experiment built by each
package's ``PPOConfig.build()`` and run by each package's
``InlineRunner`` for two steps on tiny random models (the JAX weights of
all four roles carried into the port), greedy decoding, two minibatches
of two microbatches per train MFC. Then the port alone: ``auto_offload``,
the quickstart on ``device=cpu``, and what still raises.

Tolerances: fp32 on the CPU on both sides. The rollouts must be the same
tokens (summation order differs far below the logit gaps that decide a
greedy token here); generation and reference log-probs, values and
rewards agree to 2e-5 absolute; every train stat to 1e-3 relative or
1e-5 absolute (step 2 runs on weights that four AdamW steps at lr 1e-3
have moved apart by up to ~1e-5 per element). Before the first update
the packed forward must reproduce the decode path's log-probs:
``abs(importance_weight - 1) < 0.1`` over a step's minibatches, and
below 1e-4 on the first, which runs before any update.
"""

import json

import numpy as np
import pytest

from realhf_tpu.base.testing import IntegerTokenizer as JaxTokenizer
from realhf_tpu.experiments.common import apply_overrides as jax_overrides
from realhf_tpu.experiments.ppo_exp import PPOConfig as JaxPPOConfig
from realhf_tpu.system.inline import InlineRunner as JaxRunner
from realhf_tpu_torch.base.testing import IntegerTokenizer
from realhf_tpu_torch.experiments.common import apply_overrides
from realhf_tpu_torch.experiments.ppo_exp import PPOConfig
from realhf_tpu_torch.system.inline import InlineRunner

TINY = dict(n_layers=2, n_kv_heads=2, n_q_heads=4, hidden_dim=32,
            intermediate_dim=64, vocab_size=110, apply_rotary=True,
            layer_norm_type="rms", mlp_type="llama",
            use_attention_bias=False, use_attn_proj_bias=False,
            use_mlp_bias=False, activation_function="silu")
ROLES = ("actor", "critic", "ref", "reward")
MFCS = ("actor_gen", "rew_inf", "ref_inf", "critic_inf", "actor_train",
        "critic_train")
OVERRIDES = {"dataset.train_bs_n_seqs": "8", "dataset.max_seqlen": "16",
             "ppo.max_new_tokens": "8", "ppo.min_new_tokens": "3",
             "ppo.greedy": "true", "ppo.ppo_n_minibatches": "2",
             "actor_train_n_mbs": "2", "critic_train_n_mbs": "2",
             "ref_inf_n_mbs": "2", "benchmark_steps": "2"}
for _role in ("actor", "critic"):
    OVERRIDES.update({f"{_role}.optimizer.lr": "1e-3",
                      f"{_role}.optimizer.lr_scheduler_type": "constant",
                      f"{_role}.optimizer.warmup_steps_proportion": "0"})


@pytest.fixture(autouse=True)
def _port_root(tmp_path, monkeypatch):
    """The port's runner saves its trained roles at the end of ``run``:
    under a fresh root per test."""
    from realhf_tpu_torch.base import constants
    monkeypatch.setattr(constants, "ROOT_DIR", str(tmp_path / "port_root"))


def _prompts(path, n=16):
    rng = np.random.default_rng(2)
    with open(path, "w") as f:
        for i in range(n):
            words = rng.integers(0, 50, size=int(rng.integers(2, 9)))
            f.write(json.dumps({"id": i, "prompt": " ".join(
                f"w{int(w)}" for w in words)}) + "\n")


def _spec(cfg_cls, overrides, tok, path, **extra):
    cfg = cfg_cls(experiment_name="ppo-e2e", trial_name="t0")
    overrides(cfg, dict(OVERRIDES, **{"dataset.path": path}, **extra))
    spec = cfg.build()
    for role in ROLES:
        spec.models[role].random_init_config = dict(TINY)
        spec.models[role].bf16 = False
    spec.tokenizer = tok
    return spec


def _port_runner(path, **extra):
    return InlineRunner(_spec(PPOConfig, apply_overrides,
                              IntegerTokenizer(vocab_size=100), path,
                              **extra), device="cpu")


def _record_minibatch_stats(engine):
    """Keep what every ``train_minibatches`` call of ``engine`` returns
    (one stats dict per minibatch; the interface reports their mean)."""
    seen = []
    orig = engine.train_minibatches

    def train_minibatches(*args, **kw):
        seen.append(orig(*args, **kw))
        return seen[-1]

    engine.train_minibatches = train_minibatches
    return seen


def _run_steps(runner, n=2):
    """``n`` steps of ``run_step``, each step's merged batch and stats
    (the JAX runner's ``run`` would also save a checkpoint)."""
    out = []
    for step, batch in enumerate(runner.dataloader):
        if step == n:
            break
        stats = runner.run_step(batch)
        out.append((batch, stats))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ppo") / "prompts.jsonl")
    _prompts(path)
    jr = JaxRunner(_spec(JaxPPOConfig, jax_overrides,
                         JaxTokenizer(vocab_size=100), path))
    runner = _port_runner(path)
    for role in ROLES:
        runner.models[role].engine.set_params(
            jr.models[role].engine.params_numpy())
    per_mb = _record_minibatch_stats(runner.models["actor"].engine)
    return path, jr, _run_steps(jr), runner, _run_steps(runner), per_mb


def test_ppo_experiment_matches_jax(runs):
    _, jr, want_steps, runner, got_steps, per_mb = runs
    assert [n.name for n in runner.dfg.nodes] == list(MFCS)
    assert len(got_steps) == len(want_steps) == 2
    for (got_b, got_s), (want_b, want_s) in zip(got_steps, want_steps):
        assert got_b.ids == want_b.ids and got_b.keys == want_b.keys
        assert {"packed_logits_mask", "packed_ref_logprobs", "rewards",
                "values"} <= got_b.keys
        for k in sorted(want_b.keys):
            assert got_b.seqlens[k] == want_b.seqlens[k], k
            got, want = got_b.data[k], want_b.data[k]
            assert got.dtype == want.dtype, k
            if got.dtype == np.float32:
                np.testing.assert_allclose(got, want, rtol=0, atol=2e-5,
                                           err_msg=k)
            else:  # tokens, masks: the same rollout
                np.testing.assert_array_equal(got, want, err_msg=k)
        assert set(got_s) == set(want_s) == {"actor_train", "critic_train"}
        for name in want_s:
            assert set(got_s[name]) == set(want_s[name])
            for k, w in want_s[name].items():
                np.testing.assert_allclose(got_s[name][k], w, rtol=1e-3,
                                           atol=1e-5, err_msg=f"{name}.{k}")
    # before the first update the packed forward reproduces the decode
    # path's log-probs
    step1 = got_steps[0][1]["actor_train"]
    assert abs(step1["importance_weight"] - 1) < 0.1
    assert step1["n_tokens"] > 0 and step1["early_stop_skipped"] == 0.0
    assert [len(step) for step in per_mb] == [2, 2]
    for role in ("actor", "critic"):
        assert runner.models[role].version.global_step == 2
        assert runner.models[role].engine.version == 4
        assert jr.models[role].engine.version == 4


def test_first_minibatch_of_a_fresh_run_has_ratio_one(runs):
    """Step 1's FIRST minibatch runs on the weights that generated: the
    ratio is 1 and the approximate KL 0 up to fp32 summation order
    (both read exactly so here; limit 1e-4). A shifted or wrongly masked
    log-prob would read far off."""
    path = runs[0]
    runner = _port_runner(path)
    per_mb = _record_minibatch_stats(runner.models["actor"].engine)
    batch = next(iter(runner.dataloader))
    runner.run_step(batch)
    first = per_mb[0][0]
    assert abs(first["importance_weight"] - 1) < 1e-4
    assert abs(first["ppo_approx_kl"]) < 1e-4
    # planted fault: the generation log-probs shifted by one token
    shifted = batch.data["packed_logprobs"].copy()
    shifted[1:] = shifted[:-1]
    batch.data["packed_logprobs"] = shifted
    fresh = _port_runner(path)
    per_mb = _record_minibatch_stats(fresh.models["actor"].engine)
    fresh.interfaces["actor_train"].train_step(
        fresh.models["actor"],
        batch.select(list(fresh.dfg.G.nodes["actor_train"].input_keys)),
        n_mbs=1)
    faulty = per_mb[0][0]
    assert abs(faulty["ppo_approx_kl"]) > 1e-2


def test_auto_offload_moves_ref_and_reward_between_steps(runs):
    path = runs[0]
    spec = _spec(PPOConfig, apply_overrides, IntegerTokenizer(vocab_size=100),
                 path)
    spec.auto_offload = True
    runner = InlineRunner(spec, device="cpu")
    hooked = {n.name for n in runner.dfg.nodes if n._post_hooks}
    assert hooked == {"rew_inf", "ref_inf"}
    assert not any(m.engine.offloaded for m in runner.models.values())
    ran, execute = [], runner.host.execute
    runner.host.execute = lambda name, inp: (ran.append(name),
                                             execute(name, inp))[1]
    got_steps = _run_steps(runner)
    assert runner.models["ref"].engine.offloaded
    assert runner.models["reward"].engine.offloaded
    assert not runner.models["actor"].engine.offloaded
    assert not runner.models["critic"].engine.offloaded
    # the same seed gives the same weights: offloading changes no number
    ref = _run_steps(_port_runner(path))
    for (_, got), (_, want) in zip(got_steps, ref):
        assert got == want
    assert ran == list(MFCS) * 2


def test_quickstart_cli_runs_ppo_on_cpu_and_raises_without_a_card(tmp_path):
    from realhf_tpu_torch.apps.quickstart import main
    path = str(tmp_path / "prompts.jsonl")
    _prompts(path)
    args = ["ppo"] + [f"{r}.random_init_size=tiny"
                      for r in ("actor", "critic", "ref", "rew")] + [
        f"dataset.path={path}", "dataset.train_bs_n_seqs=8",
        "dataset.max_seqlen=16", "ppo.max_new_tokens=8",
        "ppo.min_new_tokens=2", "ppo.ppo_n_minibatches=2",
        "benchmark_steps=2"]
    stats = main(args + ["device=cpu"])
    assert set(stats) == {"actor_train", "critic_train"}
    assert all(np.isfinite(v) for st in stats.values() for v in st.values())
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(args)
    # a per-MFC layout runs on a replica (the parallelism slice)
    alloc = main(args + ["device=cpu", "actor_gen_alloc=d2t1",
                         "trial_name=alloc"])
    assert set(alloc) == {"actor_train", "critic_train"}
    assert abs(alloc["actor_train"]["importance_weight"] - 1) < 0.1
    # the heuristic plans on the card count; a CPU run must name its
    # members (tests/test_torch_heuristic.py runs one)
    with pytest.raises(ValueError, match="n_devices"):
        main(args + ["device=cpu", "allocation_mode=heuristic"])
    # saving: the actor's HF checkpoint, the critic's with its value head,
    # each with its optimizer state
    import os

    from realhf_tpu_torch.base import constants
    main(args + ["device=cpu", "save_freq_steps=1", "trial_name=saved"])
    root = constants.run_save_path("exp", "saved")
    assert sorted(os.listdir(root)) == ["actor", "critic"]
    for role in ("actor", "critic"):
        assert {"config.json", "optimizer_state.npz"} <= set(
            os.listdir(os.path.join(root, role)))
    assert os.path.exists(os.path.join(root, "critic",
                                       "value_head.safetensors"))
    assert not os.path.exists(os.path.join(root, "actor",
                                           "value_head.safetensors"))
