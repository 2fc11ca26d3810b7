"""Reward modelling and DPO: the port against the JAX package.

The ``rw_pair`` dataset (the same tokens and the same pairs drawn from
the same seed), ``DPOInterface`` inference and train step on one
``SequenceSample``, and the ``rw`` and ``dpo`` experiments built by each
package's config and run by each package's ``InlineRunner`` for two
steps on tiny fp32 models (the JAX weights carried into the port). Then
the quickstart of every experiment of this slice on ``device=cpu``.

The experiment helpers here (``experiment_runners``, ``run_steps``,
``assert_same_steps``) serve the GRPO, profile and agentic files too.

Tolerances: fp32 on the CPU on both sides, sums in different orders.
Per-token data (log-probs, rewards, values) and per-sequence log-prob
sums: 2e-5 absolute. Stats: 1e-3 relative or 1e-5 absolute. Params
after two AdamW steps at lr 1e-2: 1e-4 absolute (see
``test_torch_ppo.py``).
"""

import json
import math

import jax
import numpy as np
import pytest

import realhf_tpu.datasets  # noqa: F401 - register the JAX datasets
from realhf_tpu.api import data as jdata_api
from realhf_tpu.api.config import DatasetAbstraction as JDataset
from realhf_tpu.api.data import SequenceSample as JSample
from realhf_tpu.base.testing import IntegerTokenizer as JaxTokenizer
from realhf_tpu.experiments.common import apply_overrides as jax_overrides
from realhf_tpu.experiments.dpo_exp import DPOConfig as JDPOConfig
from realhf_tpu.experiments.rw_exp import RWConfig as JRWConfig
from realhf_tpu.interfaces.dpo import DPOInterface as JDPO
from realhf_tpu.system.inline import InlineRunner as JaxRunner
import realhf_tpu_torch.datasets  # noqa: F401 - register the port's
from realhf_tpu_torch.api import data as data_api
from realhf_tpu_torch.api.config import DatasetAbstraction
from realhf_tpu_torch.api.data import SequenceSample
from realhf_tpu_torch.base.testing import IntegerTokenizer
from realhf_tpu_torch.experiments.common import apply_overrides
from realhf_tpu_torch.experiments.dpo_exp import DPOConfig
from realhf_tpu_torch.experiments.rw_exp import RWConfig
from realhf_tpu_torch.interfaces.dpo import DPOInterface
from realhf_tpu_torch.system.inline import InlineRunner
from test_torch_ppo import VOCAB, _pair

TINY = dict(n_layers=2, n_kv_heads=2, n_q_heads=4, hidden_dim=32,
            intermediate_dim=64, vocab_size=110, apply_rotary=True,
            layer_norm_type="rms", mlp_type="llama",
            use_attention_bias=False, use_attn_proj_bias=False,
            use_mlp_bias=False, activation_function="silu")
DATA_ATOL = 2e-5
STAT_RTOL, STAT_ATOL = 1e-3, 1e-5


# ----------------------------------------------------------------------
# shared experiment helpers
# ----------------------------------------------------------------------
@pytest.fixture(autouse=True)
def _port_root(tmp_path, monkeypatch):
    """The port's runner saves its trained roles at the end of ``run``:
    under a fresh root per test."""
    from realhf_tpu_torch.base import constants
    monkeypatch.setattr(constants, "ROOT_DIR", str(tmp_path / "port_root"))


def _words(rng, lo=2, hi=9):
    return " ".join(f"w{int(w)}" for w in
                    rng.integers(0, 50, size=int(rng.integers(lo, hi))))


def write_prompts(path, n=16, seed=2):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({"id": i, "prompt": _words(rng)}) + "\n")


def write_pairs(path, n=16, seed=3):
    """Paired answers, 1-3 pairs a prompt (each answer starts with a
    space: the integer tokenizer splits on whitespace)."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            k = int(rng.integers(1, 4))
            f.write(json.dumps(dict(
                id=i, prompt=_words(rng),
                pos_answers=[" " + _words(rng) for _ in range(k)],
                neg_answers=[" " + _words(rng) for _ in range(k)])) + "\n")


def experiment_runners(jax_cls, port_cls, overrides, tiny=TINY,
                       tok_vocab=100, setup=None):
    """The same experiment built by each package's config class and
    given to each package's ``InlineRunner`` (the port's on the CPU),
    fp32, with the JAX weights of every role carried into the port.
    ``tiny`` replaces every role's ``random_init_config`` (None keeps
    the config's own); ``setup(spec)`` edits both specs alike."""
    def spec(cls, apply, tok):
        cfg = cls(experiment_name="e2e", trial_name="t0")
        apply(cfg, dict(overrides))
        built = cfg.build()
        for m in built.models.values():
            if tiny is not None:
                m.random_init_config = dict(tiny)
            m.bf16 = False
        built.tokenizer = tok
        if setup is not None:
            setup(built)
        return built

    jr = JaxRunner(spec(jax_cls, jax_overrides, JaxTokenizer(tok_vocab)))
    runner = InlineRunner(spec(port_cls, apply_overrides,
                               IntegerTokenizer(tok_vocab)), device="cpu")
    assert set(runner.models) == set(jr.models)
    for role in runner.models:
        runner.models[role].engine.set_params(
            jr.models[role].engine.params_numpy())
    return jr, runner


def run_steps(runner, n=2):
    """``n`` steps of ``run_step``: each step's merged batch and stats
    (the JAX runner's ``run`` would also save a checkpoint)."""
    out = []
    for step, batch in enumerate(runner.dataloader):
        if step == n:
            break
        out.append((batch, runner.run_step(batch)))
    return out


def assert_same_steps(got_steps, want_steps, n=2):
    """Batches (ids, keys, nesting, data: floats to ``DATA_ATOL``, the
    rest exact) and every MFC's stats, step by step."""
    assert len(got_steps) == len(want_steps) == n
    for (got_b, got_s), (want_b, want_s) in zip(got_steps, want_steps):
        assert got_b.ids == want_b.ids and got_b.keys == want_b.keys
        for k in sorted(want_b.keys):
            assert got_b.seqlens[k] == want_b.seqlens[k], k
            got, want = got_b.data[k], want_b.data[k]
            assert got.dtype == want.dtype, k
            if got.dtype == np.float32:
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=DATA_ATOL, err_msg=k)
            else:
                np.testing.assert_array_equal(got, want, err_msg=k)
        assert set(got_s) == set(want_s) and got_s
        for name in want_s:
            assert set(got_s[name]) == set(want_s[name]), name
            for k, w in want_s[name].items():
                np.testing.assert_allclose(
                    got_s[name][k], w, rtol=STAT_RTOL, atol=STAT_ATOL,
                    err_msg=f"{name}.{k}")


def assert_same_versions(jr, runner):
    for role in runner.models:
        got, want = runner.models[role], jr.models[role]
        assert got.version.global_step == want.version.global_step, role
        assert got.engine.version == want.engine.version, role


# ----------------------------------------------------------------------
# rw_pair
# ----------------------------------------------------------------------
def test_rw_pair_dataset_matches_jax(tmp_path):
    path = str(tmp_path / "pairs.jsonl")
    write_pairs(path)
    args = dict(max_length=12, max_pairs_per_prompt=2, dataset_path=path)
    want = jdata_api.make_dataset(JDataset("rw_pair", args), 7, 0, 1,
                                  JaxTokenizer(100))
    got = data_api.make_dataset(DatasetAbstraction("rw_pair", args), 7, 0, 1,
                                IntegerTokenizer(100))
    assert len(got) == len(want) == 16
    # two passes: the pairs are drawn afresh from the same stream
    for idx in list(range(16)) * 2:
        g, w = got[idx], want[idx]
        assert g.ids == w.ids and g.keys == w.keys
        assert g.seqlens == w.seqlens
        for k in w.keys:
            np.testing.assert_array_equal(g.data[k], w.data[k], err_msg=k)
    # a record with unpaired answers is refused
    with open(path, "a") as f:
        f.write(json.dumps(dict(id=99, prompt="a", pos_answers=[" b"],
                                neg_answers=[" c", " d"])) + "\n")
    with pytest.raises(RuntimeError, match="paired"):
        data_api.make_dataset(DatasetAbstraction("rw_pair", args), 7, 0, 1,
                              IntegerTokenizer(100))


# ----------------------------------------------------------------------
# DPOInterface
# ----------------------------------------------------------------------
def _pairs_sample(seed, nested=((5, 7), (4, 6, 9, 3), (8, 8), (6, 5))):
    """Elements of interleaved (pos, neg) sequences, a prompt length per
    element, and a ``seqlogp`` per sequence."""
    rng = np.random.default_rng(seed)
    nested = [list(x) for x in nested]
    n = sum(sum(x) for x in nested)
    kw = dict(keys=["packed_input_ids", "prompt_lens"],
              trailing_shapes=dict(packed_input_ids=(), prompt_lens=()),
              dtypes=dict(packed_input_ids=np.int32, prompt_lens=np.int32),
              ids=list(range(len(nested))),
              seqlens=dict(packed_input_ids=nested,
                           prompt_lens=[[1]] * len(nested)),
              data=dict(packed_input_ids=rng.integers(
                  2, VOCAB, size=n).astype(np.int32),
                  prompt_lens=np.asarray([2, 3, 1, 4], np.int32)))
    return kw


@pytest.fixture(scope="module")
def dpo_ref():
    return _pair("ref", False, 4, train=False)


def test_dpo_inference_matches_jax(dpo_ref):
    jmodel, model = dpo_ref
    kw = _pairs_sample(0)
    want = JDPO().inference(jmodel, JSample(**kw))
    got = DPOInterface().inference(model, SequenceSample(**kw))
    assert got.keys == want.keys == {"seqlogp"}
    assert got.seqlens == want.seqlens == dict(
        seqlogp=[[1, 1], [1, 1, 1, 1], [1, 1], [1, 1]])
    np.testing.assert_allclose(got.data["seqlogp"], want.data["seqlogp"],
                               rtol=0, atol=DATA_ATOL)
    # a sum over the answer tokens only (log-probs ~ -ln 64 each): 0
    # for the sequence of 3 tokens under a prompt of 3
    has_answer = np.asarray([5, 7, 4, 6, 9, 3, 8, 8, 6, 5]) > np.repeat(
        [2, 3, 1, 4], [2, 4, 2, 2])
    assert (got.data["seqlogp"][has_answer] < -1).all()
    assert (got.data["seqlogp"][~has_answer] == 0).all()


@pytest.mark.parametrize("n_mbs", [1, 2])
def test_dpo_train_step_matches_jax(n_mbs):
    jmodel, model = _pair("actor", False, 5, train=True)
    kw = _pairs_sample(1)
    rng = np.random.default_rng(2)
    ref = (-rng.random(10) * 20).astype(np.float32)
    kw["keys"].append("seqlogp")
    kw["trailing_shapes"]["seqlogp"] = ()
    kw["dtypes"]["seqlogp"] = np.float32
    kw["seqlens"]["seqlogp"] = [[1] * len(x)
                                for x in kw["seqlens"]["packed_input_ids"]]
    kw["data"]["seqlogp"] = ref
    want = JDPO(beta=0.3).train_step(jmodel, JSample(**kw), n_mbs=n_mbs)
    got = DPOInterface(beta=0.3).train_step(model, SequenceSample(**kw),
                                            n_mbs=n_mbs)
    assert set(got) == set(want) == {"loss", "pos_score", "neg_score", "kl",
                                     "grad_norm"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=STAT_RTOL,
                                   atol=STAT_ATOL, err_msg=k)
    assert model.version.global_step == jmodel.version.global_step == 1
    want_p = jax.tree_util.tree_leaves_with_path(jmodel.engine.params_numpy())
    got_p = dict(jax.tree_util.tree_leaves_with_path(
        model.engine.params_numpy()))
    for path, a in want_p:
        np.testing.assert_allclose(got_p[path], a, rtol=0, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


def test_dpo_first_step_against_itself_is_log2():
    """The policy as its own reference: every log-ratio is 0, so the
    loss is ln 2 and the scores and KL 0 (to fp32 summation order);
    with the reference's pos and neg sums swapped it is not."""
    _, model = _pair("actor", False, 6, train=True)
    itf = DPOInterface(beta=0.5)
    kw = _pairs_sample(3)
    inp = SequenceSample(**kw)
    inp.update_(itf.inference(model, inp))
    stats = itf.train_step(model, inp)
    assert abs(stats["loss"] - math.log(2)) < 1e-6
    for k in ("kl", "pos_score", "neg_score"):
        assert abs(stats[k]) < 1e-5, k
    _, model = _pair("actor", False, 6, train=True)
    swapped = inp.data["seqlogp"].reshape(-1, 2)[:, ::-1].reshape(-1)
    inp.data["seqlogp"] = np.ascontiguousarray(swapped)
    stats = itf.train_step(model, inp)
    assert abs(stats["loss"] - math.log(2)) > 1e-2


# ----------------------------------------------------------------------
# the rw and dpo experiments
# ----------------------------------------------------------------------
PAIR_OVERRIDES = {"dataset.train_bs_n_seqs": "4", "dataset.max_seqlen": "12",
                  "benchmark_steps": "2", "n_mbs": "2"}


def _train_overrides(roles):
    out = {}
    for role in roles:
        out.update({f"{role}.optimizer.lr": "1e-2",
                    f"{role}.optimizer.lr_scheduler_type": "constant",
                    f"{role}.optimizer.warmup_steps_proportion": "0"})
    return out


def test_rw_experiment_matches_jax(tmp_path):
    path = str(tmp_path / "pairs.jsonl")
    write_pairs(path)
    jr, runner = experiment_runners(
        JRWConfig, RWConfig, dict(PAIR_OVERRIDES, **_train_overrides(
            ["model"]), **{"dataset.path": path}))
    assert [n.name for n in runner.dfg.nodes] == ["trainDefault"]
    assert runner.models["default"].config.is_critic
    got = run_steps(runner)
    assert_same_steps(got, run_steps(jr))
    assert_same_versions(jr, runner)
    st = got[1][1]["trainDefault"]
    assert set(st) == {"loss", "acc", "pos_score", "neg_score", "grad_norm"}
    assert runner.models["default"].engine.version == 2


def test_dpo_experiment_matches_jax(tmp_path):
    path = str(tmp_path / "pairs.jsonl")
    write_pairs(path)
    jr, runner = experiment_runners(
        JDPOConfig, DPOConfig, dict(PAIR_OVERRIDES, **_train_overrides(
            ["actor"]), **{"dataset.path": path, "beta": "0.2"}))
    assert [n.name for n in runner.dfg.nodes] == ["ref_inf", "actor_train"]
    got = run_steps(runner)
    assert_same_steps(got, run_steps(jr))
    assert_same_versions(jr, runner)
    batch, stats = got[0]
    assert batch.seqlens["seqlogp"] == [[1] * len(x) for x in
                                        batch.seqlens["packed_input_ids"]]
    assert set(stats["actor_train"]) == {"loss", "pos_score", "neg_score",
                                         "kl", "grad_norm"}


# ----------------------------------------------------------------------
# the quickstart of every experiment of this slice
# ----------------------------------------------------------------------
def _quickstart_args(name, tmp_path):
    prompts, pairs = str(tmp_path / "p.jsonl"), str(tmp_path / "rw.jsonl")
    write_prompts(prompts)
    write_pairs(pairs)
    return {
        "rw": ["model.random_init_size=tiny", f"dataset.path={pairs}",
               "dataset.train_bs_n_seqs=8"],
        "dpo": [f"{r}.random_init_size=tiny" for r in ("actor", "ref")] + [
            f"dataset.path={pairs}", "dataset.train_bs_n_seqs=8"],
        "grpo": [f"{r}.random_init_size=tiny" for r in
                 ("actor", "ref", "rew")] + [
            f"dataset.path={prompts}", "dataset.train_bs_n_seqs=4",
            "grpo.max_new_tokens=6", "grpo.ppo_n_minibatches=2"],
        "profile": ["n_prompts=8", "dataset.train_bs_n_seqs=8",
                    "ppo.max_new_tokens=6", "ppo.min_new_tokens=2",
                    "ppo.ppo_n_minibatches=2"],
        "agentic": [f"{r}.random_init_size=tiny" for r in
                    ("actor", "critic", "ref")] + [
            "agentic.env=tool_game", "agentic.dataset_type=tool_game",
            "agentic.n_prompts=8", "agentic.max_turns=2",
            "dataset.train_bs_n_seqs=8", "ppo.max_new_tokens=3",
            "ppo.min_new_tokens=2", "ppo.top_p=1", "ppo.top_k=0",
            "ppo.ppo_n_minibatches=2"],
    }[name] + ["benchmark_steps=2"]


TRAIN_MFCS = dict(rw={"trainDefault"}, dpo={"actor_train"},
                  grpo={"actor_train"},
                  profile={"actor_train", "critic_train"},
                  agentic={"actor_train", "critic_train"})


@pytest.mark.parametrize("name", sorted(TRAIN_MFCS))
def test_quickstart_runs_on_cpu_and_raises_without_a_card(name, tmp_path):
    import torch

    from realhf_tpu_torch.apps.quickstart import main
    args = [name] + _quickstart_args(name, tmp_path)
    stats = main(args + ["device=cpu"])
    assert set(stats) == TRAIN_MFCS[name]
    assert all(np.isfinite(v) for st in stats.values() for v in st.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(args)
