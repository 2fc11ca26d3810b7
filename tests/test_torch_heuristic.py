"""The port's heuristic allocation (``experiments/heuristic.py``) against
the JAX package's on the same configs: ``choose_layout`` over a grid of
model sizes (the test size to a 70B-shaped model), device counts 1-16,
every interface type and explicit budgets; ``heuristic_allocations`` on
each package's PPO experiment; then a PPO run on the CPU planned by
``allocation_mode=heuristic n_devices=4`` that takes a step.

Plans are integers: they must be equal. The budget default is the
port's own (an H100's), so every comparison passes its budget.
"""

import dataclasses

import numpy as np
import pytest

from realhf_tpu.api.config import ModelInterfaceType as JType
from realhf_tpu.experiments import heuristic as jh
from realhf_tpu.experiments.ppo_exp import PPOConfig as JPPOConfig
from realhf_tpu.models.config import TransformerConfig as JConfig
from realhf_tpu_torch.api.config import ModelInterfaceType
from realhf_tpu_torch.experiments import heuristic as h
from realhf_tpu_torch.experiments.ppo_exp import PPOConfig
from realhf_tpu_torch.models.config import MODEL_SIZES, TransformerConfig
from realhf_tpu_torch.models.config import llama_config

SEVENTY_B = dict(n_layers=80, n_kv_heads=8, n_q_heads=64, hidden_dim=8192,
                 intermediate_dim=28672, vocab_size=32000)
SIZES = {**{k: MODEL_SIZES[k] for k in ("tiny", "1b", "7b")},
         "70b": SEVENTY_B}
BUDGETS = (2e9, 16e9, 48e9)
DEVICES = (1, 2, 3, 4, 8, 16)


def _layout(p):
    return (p.data_parallel_size, p.tensor_parallel_size,
            p.pipeline_parallel_size, p.sequence_parallel)


@pytest.mark.parametrize("size", list(SIZES))
def test_choose_layout_equals_jax_over_the_grid(size):
    kw = dict(llama_config("tiny"), **SIZES[size])
    cfg, jcfg = TransformerConfig(**kw), JConfig(**kw)
    assert cfg.n_params() == jcfg.n_params()
    for n in DEVICES:
        for budget in BUDGETS:
            for itype in ModelInterfaceType:
                trainable = itype == ModelInterfaceType.TRAIN_STEP
                for tokens in (None, 4096.0 * 256):
                    got = h.choose_layout(cfg, n, itype, trainable,
                                          int(budget), tokens)
                    want = jh.choose_layout(jcfg, n, JType(itype.value),
                                            trainable, int(budget), tokens)
                    assert _layout(got) == _layout(want), (
                        size, n, budget, itype, tokens)


def test_state_and_activation_bytes_equal_jax():
    for args in ((7e9, 2, 1, 4), (70e9, 8, 4, 2), (1e6, 1, 1, 1)):
        assert h.train_state_bytes_per_chip(*args) == \
            jh.train_state_bytes_per_chip(*args)
    for args in ((4096, 1e5, 2, None), (8192, 3e5, 4, 8)):
        assert h.pipeline_activation_bytes(*args) == \
            jh.pipeline_activation_bytes(*args)
    assert h.TP_CAP == jh.TP_CAP
    assert h.DEFAULT_HBM_BUDGET == int(80e9 * 0.6)


@pytest.mark.parametrize("size", ["tiny", "7b"])
def test_heuristic_allocations_equal_jax_on_ppo(size):
    """Each package's PPO experiment (its four roles and six MFCs) at
    one model size, planned for 1-16 devices at two budgets: the same
    primaries and the same overrides."""
    def built(cls):
        cfg = cls()
        cfg.dataset = dataclasses.replace(cfg.dataset, path="p.jsonl")
        spec = cfg.build()
        # the JAX experiments take sizes from a checkpoint's config.json;
        # both get the same random-init config
        for r, m in spec.models.items():
            spec.models[r] = dataclasses.replace(
                m, path=None, random_init_config=llama_config(size))
        return spec

    spec, jspec = built(PPOConfig), built(JPPOConfig)
    assert sorted(spec.models) == sorted(jspec.models)
    for n in DEVICES:
        for budget in (16e9, 48e9):
            got = h.heuristic_allocations(spec, n, int(budget))
            want = jh.heuristic_allocations(jspec, n, int(budget))
            for g, w in zip(got, want):
                assert {k: _layout(v) for k, v in g.items()} == \
                    {k: _layout(v) for k, v in w.items()}, (n, budget)


def test_ppo_on_cpu_planned_by_the_heuristic_takes_a_step(tmp_path,
                                                          monkeypatch):
    """Tiny roles on four CPU members: every MFC plans to d4 (the state
    fits one device), the roles build there, and one PPO step runs."""
    from realhf_tpu_torch.apps.quickstart import main
    from test_torch_ppo_e2e import _prompts
    monkeypatch.setenv("REALHF_TPU_ROOT", str(tmp_path))
    path = str(tmp_path / "prompts.jsonl")
    _prompts(path)
    seen = {}
    apply = h.apply_heuristic_allocations

    def recording(spec, n, *a):
        out = apply(spec, n, *a)
        seen.update(n=n, layouts={r: _layout(m.parallel)
                                  for r, m in out.models.items()},
                    overrides=dict(out.allocations))
        return out

    monkeypatch.setattr(h, "apply_heuristic_allocations", recording)
    stats = main(["ppo"] + [f"{r}.random_init_size=tiny" for r in
                            ("actor", "critic", "ref", "rew")] + [
        f"dataset.path={path}", "dataset.train_bs_n_seqs=8",
        "dataset.max_seqlen=16", "ppo.max_new_tokens=8",
        "ppo.min_new_tokens=2", "ppo.ppo_n_minibatches=2",
        "benchmark_steps=1", "device=cpu", "allocation_mode=heuristic",
        "n_devices=4"])
    assert seen["n"] == 4 and not seen["overrides"]
    assert set(seen["layouts"].values()) == {(4, 1, 1, False)}
    assert set(stats) == {"actor_train", "critic_train"}
    assert all(np.isfinite(v) for st in stats.values() for v in st.values())
