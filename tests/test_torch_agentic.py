"""The agentic subsystem: the port against the JAX package.

The envs step for step (``CheckerEnv`` copy and add, ``ToolGameEnv``),
``EpisodeRunner`` on a scripted local backend (concurrency, per-turn
weight versions, env errors, the turn and length caps, rejected results
resubmitted, ``stop``) with its counters, ``episodes_to_sample`` on the
episodes it finishes, the ``checker_task`` and ``tool_game`` datasets
(synthetic and JSONL), ``AgenticActorInterface.generate`` on a tiny
fp32 model with greedy decoding, and the ``agentic`` experiment built
by each package's config and run by each package's ``InlineRunner`` for
two greedy steps on the multi-turn tool game with turn-level credit.

Everything but the model is host numpy and deterministic, so envs,
episodes, datasets and packed samples must agree exactly; model outputs
and stats to the tolerances of ``test_torch_rw_dpo.py``.
"""

import json

import numpy as np
import pytest

import realhf_tpu.agentic  # noqa: F401 - register the JAX envs
import realhf_tpu.datasets  # noqa: F401 - register the JAX datasets
from realhf_tpu.agentic import env as jenv
from realhf_tpu.agentic.episode import EpisodeRunner as JRunner
from realhf_tpu.agentic.interface import AgenticActorInterface as JAgentic
from realhf_tpu.agentic.local import GenResult as JGen
from realhf_tpu.agentic.local import LocalRolloutBackend as JBackend
from realhf_tpu.agentic.trajectory import episodes_to_sample as jto_sample
from realhf_tpu.api import data as jdata_api
from realhf_tpu.api.config import DatasetAbstraction as JDataset
from realhf_tpu.api.data import SequenceSample as JSample
from realhf_tpu.experiments.agentic_exp import AgenticPPOConfig as JConfig
from realhf_tpu.obs import metrics as jmetrics
from realhf_tpu.serving.server import RolloutResult as JResult
import realhf_tpu_torch.datasets  # noqa: F401 - register the port's
from realhf_tpu_torch.agentic import env
from realhf_tpu_torch.agentic.episode import EpisodeRunner
from realhf_tpu_torch.agentic.interface import AgenticActorInterface
from realhf_tpu_torch.agentic.local import GenResult, LocalRolloutBackend
from realhf_tpu_torch.agentic.trajectory import (
    episodes_to_sample,
    turn_segments,
)
from realhf_tpu_torch.api import data as data_api
from realhf_tpu_torch.api.config import DatasetAbstraction
from realhf_tpu_torch.api.data import SequenceSample
from realhf_tpu_torch.experiments.agentic_exp import AgenticPPOConfig
from realhf_tpu_torch.obs import metrics
from realhf_tpu_torch.serving import protocol
from realhf_tpu_torch.serving.server import RolloutResult
from test_torch_ppo import VOCAB, _assert_same_sample, _pair
from test_torch_rw_dpo import (
    TINY,
    assert_same_steps,
    assert_same_versions,
    experiment_runners,
    run_steps,
)

# the two packages side by side: (make_env, EpisodeRunner, backend,
# GenResult, RolloutResult, episodes_to_sample, metrics)
PORT = (env.make_env, EpisodeRunner, LocalRolloutBackend, GenResult,
        RolloutResult, episodes_to_sample, metrics)
JAX = (jenv.make_env, JRunner, JBackend, JGen, JResult, jto_sample,
       jmetrics)


@pytest.fixture(autouse=True)
def _port_root(tmp_path, monkeypatch):
    """The port's runner saves its trained roles at the end of ``run``:
    under a fresh root per test."""
    from realhf_tpu_torch.base import constants
    monkeypatch.setattr(constants, "ROOT_DIR", str(tmp_path / "port_root"))


def _assert_same_step(got, want):
    np.testing.assert_array_equal(got.observation, want.observation)
    assert got.observation.dtype == want.observation.dtype
    assert (got.reward, got.done, got.info) == (want.reward, want.done,
                                                want.info)


@pytest.mark.parametrize("name,kw", [
    ("checker_task", dict(task="copy")),
    ("checker_task", dict(task="add", partial_credit=0.3)),
    ("tool_game", dict(n_turns=3)),
    ("tool_game", dict(n_turns=1, partial_credit=0.8)),
])
def test_envs_match_jax_step_for_step(name, kw):
    rng = np.random.default_rng(0)
    for trial in range(6):
        prompt = rng.integers(4, 97, size=int(rng.integers(1, 6)))
        got = env.make_env(name, prompt=prompt, seed=trial, **kw)
        want = jenv.make_env(name, prompt=prompt, seed=trial, **kw)
        np.testing.assert_array_equal(got.reset(), want.reset())
        if name == "tool_game":
            assert got.targets == want.targets
        for _ in range(kw.get("n_turns", 1)):
            # well-formed, malformed, out-of-range and exact actions
            action = rng.integers(0, 100, size=int(rng.integers(0, 3)))
            if rng.random() < 0.3 and name == "tool_game":
                action = np.array([env.CALL_TOKEN, want.targets[want._k]])
            _assert_same_step(got.step(action), want.step(action))
        with pytest.raises(RuntimeError, match="already finished"):
            got.step(np.array([2, 5]))
    assert set(env.ALL_ENV_CLASSES) == {"checker_task", "tool_game"}
    with pytest.raises(ValueError, match="Unknown env"):
        env.make_env("nope", prompt=[5])
    with pytest.raises(ValueError, match="already registered"):
        env.register_env("tool_game", env.ToolGameEnv)


class _BrokenEnv:
    """An env whose second step raises (an executor error)."""

    def __init__(self, prompt, seed=0, **kw):
        self.prompt, self.k = np.asarray(prompt, np.int32), 0

    def reset(self):
        return self.prompt

    def step(self, action):
        self.k += 1
        if self.k == 2:
            raise RuntimeError("tool crashed")
        return env.EnvStep(np.array([3, 9], np.int32), 0.5, False)


def _policy(pkg):
    """A scripted tool-game policy: the right call most turns, a
    malformed or wrong one some turns, logprobs from the context."""
    gen_result = pkg[3]

    def policy(prompts):
        out = []
        for p in prompts:
            h = int(p.sum())
            if h % 5 == 0:
                toks = [7]                        # malformed
            elif h % 7 == 0:
                toks = [env.CALL_TOKEN, p[-1] + 1, 1]   # off by one, EOS
            else:
                toks = [env.CALL_TOKEN, p[-1]]
            out.append(gen_result(
                tokens=np.asarray(toks, np.int32),
                logprobs=-np.arange(1, len(toks) + 1, dtype=np.float32)
                / (h % 11 + 1), no_eos=h % 3 == 0))
        return out
    return policy


class _Rejecting:
    """A backend wrapper that answers the first ``n`` submissions of
    each context with REJECTED (backpressure) before passing it
    through (a resubmission takes a new request id)."""

    def __init__(self, backend, result_cls, n):
        self.backend, self.result_cls, self.n = backend, result_cls, n
        self.ctx_of, self.tries = {}, {}

    def __getattr__(self, name):
        return getattr(self.backend, name)

    def submit(self, prompt, **kw):
        rid = self.backend.submit(prompt, **kw)
        self.ctx_of[rid] = np.asarray(prompt).tobytes()
        return rid

    def poll_results(self, timeout=0.0):
        out = []
        for res in self.backend.poll_results(timeout):
            ctx = self.ctx_of.pop(res.rid)
            k = self.tries[ctx] = self.tries.get(ctx, 0) + 1
            out.append(res if k > self.n else self.result_cls(
                rid=res.rid, status="rejected", data={}))
        return out


RUNNER_CASES = dict(
    concurrent=dict(n_turns=3, runner=dict(max_concurrent=3, max_turns=4)),
    max_turns=dict(n_turns=5, runner=dict(max_concurrent=8, max_turns=2)),
    drop_on_max_turns=dict(n_turns=5, runner=dict(
        max_concurrent=8, max_turns=2, drop_on_max_turns=True)),
    length=dict(n_turns=5, runner=dict(max_concurrent=4, max_turns=8,
                                       max_seq_len=11)),
    env_error=dict(n_turns=3, broken=(2, 5), runner=dict(max_concurrent=4)),
    rejected=dict(n_turns=2, reject=1, runner=dict(max_concurrent=4)),
    retries_exhausted=dict(n_turns=2, reject=5, runner=dict(
        max_concurrent=4, max_retries=2)),
)


def _run_episodes(pkg, case):
    make, runner_cls, backend_cls, _, result_cls, to_sample, mets = pkg
    mets.reset_default()
    versions = iter(range(1000))
    backend = backend_cls(_policy(pkg), version_fn=lambda: next(versions))
    if case.get("reject"):
        backend = _Rejecting(backend, result_cls, case["reject"])

    def episodes():
        for i in range(7):
            prompt = np.array([5 + i, 6 + 2 * i, 7], np.int32)
            if i in case.get("broken", ()):
                yield f"e{i}", _BrokenEnv(prompt)
            else:
                yield f"e{i}", make("tool_game", prompt=prompt, seed=i,
                                    vocab_size=97, n_turns=case["n_turns"])

    runner = runner_cls(backend, episodes(), **case["runner"])
    done = runner.run_all()
    reg = mets.default_registry()
    counted = {status: reg.counter("agentic_episodes_total").value(
        status=status) for status in ("done", "max_turns", "length")}
    counted["turns"] = reg.counter("agentic_turns_total").value()
    return runner, done, counted


@pytest.mark.parametrize("case", sorted(RUNNER_CASES))
def test_episode_runner_matches_jax(case):
    kw = RUNNER_CASES[case]
    got_runner, got, got_counts = _run_episodes(PORT, kw)
    want_runner, want, want_counts = _run_episodes(JAX, kw)
    assert [e.sid for e in got] == [e.sid for e in want]
    for g, w in zip(got, want):
        assert (g.status, g.n_turns, g.total_reward) == (
            w.status, w.n_turns, w.total_reward)
        for gt, wt in zip(g.turns, w.turns):
            for f in ("obs", "action", "logprobs"):
                np.testing.assert_array_equal(getattr(gt, f),
                                              getattr(wt, f), err_msg=f)
            assert (gt.reward, gt.weight_version, gt.no_eos) == (
                wt.reward, wt.weight_version, wt.no_eos)
    timing = ("env_step_secs", "env_step_overlap_secs")
    assert ({k: v for k, v in got_runner.stats().items() if k not in timing}
            == {k: v for k, v in want_runner.stats().items()
                if k not in timing})
    assert got_runner.dropped == want_runner.dropped
    assert got_counts == want_counts
    assert got_counts["turns"] == got_runner.turns_done
    if got:
        ids = sorted(e.sid for e in got)[::-1]
        g = episodes_to_sample(got, trainer_version=9, ids=ids)
        w = jto_sample(want, trainer_version=9, ids=ids)
        _assert_same_sample(g, w)
        assert g.metadata == w.metadata
        assert turn_segments(g, 0) == list(w.metadata["turn_spans"][0])
    if case == "env_error":
        assert [d[1] for d in got_runner.dropped] == ["env_error"] * 2
    if case == "rejected":
        assert got_runner.resubmits > 0 and not got_runner.dropped
    if case in ("concurrent", "max_turns", "length"):
        assert got_counts[case if case != "concurrent" else "done"] == 7
    if case == "concurrent":
        assert len({t.weight_version for e in got for t in e.turns}) > 1


def test_stop_abandons_in_flight_requests():
    metrics.reset_default()
    backend = LocalRolloutBackend(_policy(PORT))
    runner = EpisodeRunner(backend, (
        (i, env.make_env("tool_game", prompt=[5, i + 4], n_turns=3))
        for i in range(5)), max_concurrent=3)
    assert runner.pump() == 3 and runner.inflight == 3
    assert runner.stop() == 3
    assert runner.inflight == runner.live == 0 and runner.abandoned == 3
    assert backend.poll_results() == []
    assert [d[1] for d in runner.dropped] == ["stopped"] * 3
    assert metrics.default_registry().counter(
        "agentic_abandoned_total").value(reason="stopped") == 3


def test_rollout_result_and_protocol():
    assert RolloutResult("a", protocol.DONE, dict(tokens=[1])).ok
    assert not RolloutResult("b", protocol.EXPIRED, dict(tokens=[1])).ok
    assert set(protocol.TERMINAL_KINDS) == {
        "done", "rejected", "stale", "expired", "cancelled", "draining"}


@pytest.mark.parametrize("name,args", [
    ("checker_task", dict(n_prompts=24, prompt_len_min=3, prompt_len_max=9,
                          vocab_size=50)),
    ("tool_game", dict(n_prompts=24, prompt_len=5, vocab_size=50)),
    ("checker_task", "jsonl"),
    ("tool_game", "jsonl"),
])
@pytest.mark.parametrize("rank", [0, 1])
def test_agentic_datasets_match_jax(name, args, rank, tmp_path):
    if args == "jsonl":
        path = tmp_path / "tasks.jsonl"
        rng = np.random.default_rng(1)
        path.write_text("".join(json.dumps(dict(
            id=i, prompt_tokens=[int(x) for x in rng.integers(
                4, 90, size=int(rng.integers(1, 7)))])) + "\n"
            for i in range(20)))
        args = dict(dataset_path=str(path))
    got = data_api.make_dataset(DatasetAbstraction(name, args), 5, rank, 2,
                                None)
    want = jdata_api.make_dataset(JDataset(name, args), 5, rank, 2, None)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert g.ids == w.ids and g.seqlens == w.seqlens
        np.testing.assert_array_equal(g.data["packed_prompts"],
                                      w.data["packed_prompts"])
        assert g.data["packed_prompts"].dtype == np.int32


def test_agentic_dataset_names_a_malformed_record(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text(json.dumps(dict(id="x", prompt_tokens=[4, -1])) + "\n")
    with pytest.raises(ValueError, match="'x'"):
        data_api.make_dataset(DatasetAbstraction(
            "tool_game", dict(dataset_path=str(path))), 1, 0, 1, None)


@pytest.mark.parametrize("env_name,turns", [("tool_game", 3),
                                            ("checker_task", 1)])
def test_agentic_generate_greedy_matches_jax(env_name, turns):
    jmodel, model = _pair("actor", False, 7, train=False)
    rng = np.random.default_rng(3)
    plens = [int(x) for x in rng.integers(2, 7, size=5)]
    prompts = rng.integers(4, VOCAB, size=sum(plens)).astype(np.int32)
    args = (plens, [f"q{i}" for i in range(5)],
            dict(packed_prompts=prompts))
    kw = dict(env=env_name, max_turns=turns, turn_level_credit=True,
              gconfig=dict(max_new_tokens=3, min_new_tokens=2, greedy=True,
                           force_no_logits_mask=True))
    want = JAgentic(**kw).generate(jmodel, JSample.from_default(*args))
    got = AgenticActorInterface(**kw).generate(
        model, SequenceSample.from_default(*args))
    _assert_same_sample(got, want, atol=2e-5)
    assert got.metadata == want.metadata
    assert got.metadata["n_turns"] == [turns] * 5
    # each sequence's turn rewards sum to its episode's total
    off = 0
    for i, lens in enumerate(got.seqlens["dense_rewards"]):
        dense = got.data["dense_rewards"][off:off + lens[0]]
        assert dense.sum() == pytest.approx(got.data["rewards"][i])
        off += lens[0]


def test_agentic_experiment_matches_jax():
    overrides = {
        "dataset.train_bs_n_seqs": "8", "agentic.n_prompts": "16",
        "agentic.env": "tool_game", "agentic.dataset_type": "tool_game",
        "agentic.max_turns": "3", "ppo.greedy": "true",
        "ppo.max_new_tokens": "3", "ppo.min_new_tokens": "2",
        "ppo.ppo_n_minibatches": "2", "actor_train_n_mbs": "2",
        "benchmark_steps": "2"}
    for role in ("actor", "critic"):
        overrides.update({f"{role}.optimizer.lr": "1e-3",
                          f"{role}.optimizer.lr_scheduler_type": "constant",
                          f"{role}.optimizer.warmup_steps_proportion": "0"})

    def setup(spec):
        spec.dataset.args["vocab_size"] = TINY["vocab_size"]

    jr, runner = experiment_runners(JConfig, AgenticPPOConfig, overrides,
                                    setup=setup)
    assert [n.name for n in runner.dfg.nodes] == [
        "actor_gen", "ref_inf", "critic_inf", "actor_train", "critic_train"]
    assert set(runner.models) == {"actor", "critic", "ref"}
    got = run_steps(runner)
    assert_same_steps(got, run_steps(jr))
    assert_same_versions(jr, runner)
    for batch, stats in got:
        st = stats["actor_train"]
        assert st["avg_turns"] == 3.0 and "dense_reward_sum" in st
        assert batch.metadata["n_turns"] == [3] * 8
