"""GRPO, REINFORCE (ReMax) and the profile experiment: the port against
the JAX package.

``GRPOInterface`` and ``ReinforceInterface`` train steps on the same
seeded ``SequenceSample`` (groups of four with varying rewards, a
discount, advantage normalization, turn-level credit over
``dense_rewards``, the k3 KL on and off), their ``generate`` (greedy:
sampled rollouts cannot match across the two packages' generators, so
the sampled half of REINFORCE is held by structure), what their
constructors refuse, and the ``grpo`` and ``profile`` experiments built
by each package's config and run by each package's ``InlineRunner`` for
two greedy steps on tiny fp32 models.

Under greedy decoding the responses of one GRPO group are identical, so
their rewards differ only by summation order, and the group
normalization (a division by std + 1e-5) would magnify that noise: the
``grpo`` experiment runs with the reward scaled to 0 (every advantage
exactly 0, the KL term alone moving the policy); the interface tests
hold the advantages on varied group rewards.

Tolerances as ``test_torch_rw_dpo.py``: data 2e-5 absolute, stats 1e-3
relative or 1e-5 absolute, params 1e-4 absolute. The profile experiment
trains at lr 1e-3, as ``test_torch_ppo_e2e.py`` does: its clip ratios
count tokens, and at lr 1e-2 the second minibatch moves a value to
within fp32 noise of the clip edge.
"""

import jax
import numpy as np
import pytest

from realhf_tpu.api.data import SequenceSample as JSample
from realhf_tpu.experiments.grpo_exp import GRPOConfig as JGRPOConfig
from realhf_tpu.experiments.profile_exp import ProfileConfig as JProfile
from realhf_tpu.interfaces.grpo import GRPOInterface as JGRPO
from realhf_tpu.interfaces.ppo import PPOActorInterface as JActor
from realhf_tpu.interfaces.reinforce import ReinforceInterface as JReinforce
from realhf_tpu_torch.api.data import SequenceSample
from realhf_tpu_torch.experiments.grpo_exp import GRPOConfig
from realhf_tpu_torch.experiments.profile_exp import ProfileConfig
from realhf_tpu_torch.interfaces.grpo import GRPOInterface
from realhf_tpu_torch.interfaces.ppo import PPOActorInterface
from realhf_tpu_torch.interfaces.reinforce import ReinforceInterface
from test_torch_ppo import VOCAB, _assert_same_sample, _pair
from test_torch_rw_dpo import (
    STAT_ATOL,
    STAT_RTOL,
    assert_same_steps,
    assert_same_versions,
    experiment_runners,
    run_steps,
    write_prompts,
)

SAMPLED = dict(max_new_tokens=6, min_new_tokens=2, greedy=False,
               top_p=1.0, top_k=0, temperature=0.9, force_no_logits_mask=True)
GREEDY = dict(max_new_tokens=6, min_new_tokens=2, greedy=True)


@pytest.fixture(autouse=True)
def _port_root(tmp_path, monkeypatch):
    """The port's runner saves its trained roles at the end of ``run``:
    under a fresh root per test."""
    from realhf_tpu_torch.base import constants
    monkeypatch.setattr(constants, "ROOT_DIR", str(tmp_path / "port_root"))


def _grouped_rollout(seed, n_elems=3, per_elem=4, dense=False):
    """A rollout batch as the GRPO (or REINFORCE) graph leaves it:
    ``per_elem`` sequences nested in each element, behaviour and
    reference log-probs, one reward per sequence."""
    rng = np.random.default_rng(seed)
    plens = rng.integers(2, 6, size=n_elems * per_elem)
    lens = plens + rng.integers(2, 9, size=len(plens))
    n, n_seqs = int(lens.sum()), len(lens)
    nested = [[int(x) for x in lens[i * per_elem:(i + 1) * per_elem]]
              for i in range(n_elems)]
    data = dict(
        packed_input_ids=rng.integers(2, VOCAB, size=n).astype(np.int32),
        prompt_mask=np.concatenate([np.arange(l) < p
                                    for l, p in zip(lens, plens)]),
        packed_logprobs=(-rng.random(n - n_seqs) * 4).astype(np.float32),
        packed_ref_logprobs=(-rng.random(n - n_seqs) * 4)
        .astype(np.float32),
        rewards=rng.standard_normal(n_seqs).astype(np.float32))
    short = [[l - 1 for l in x] for x in nested]
    seqlens = dict(packed_input_ids=nested, prompt_mask=nested,
                   packed_logprobs=short, packed_ref_logprobs=short,
                   rewards=[[1] * per_elem] * n_elems)
    if dense:
        data["dense_rewards"] = np.where(
            rng.random(n - n_seqs) > 0.7,
            rng.standard_normal(n - n_seqs), 0).astype(np.float32)
        seqlens["dense_rewards"] = short
    kw = dict(keys=list(data), trailing_shapes={k: () for k in data},
              dtypes={k: v.dtype for k, v in data.items()},
              ids=list(range(n_elems)), seqlens=seqlens)
    return (JSample(**kw, data=dict(data)),
            SequenceSample(**kw, data=dict(data)))


def _assert_train_step(jitf, itf, jmodel, model, jin, pin):
    want = jitf.train_step(jmodel, jin, n_mbs=2)
    got = itf.train_step(model, pin, n_mbs=2)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=STAT_RTOL,
                                   atol=STAT_ATOL, err_msg=k)
    assert model.version.global_step == jmodel.version.global_step == 1
    assert model.engine.version == jmodel.engine.version
    want_p = jax.tree_util.tree_leaves_with_path(jmodel.engine.params_numpy())
    got_p = dict(jax.tree_util.tree_leaves_with_path(
        model.engine.params_numpy()))
    for path, a in want_p:
        np.testing.assert_allclose(got_p[path], a, rtol=0, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    return got


GRPO_CASES = dict(
    plain={},
    discount=dict(discount=0.9, max_reward_clip=0.8),
    adv_norm=dict(adv_norm=True),
    dense_rewards=dict(turn_level_credit=True, discount=0.95),
    kl_off=dict(kl_coef=0.0),
)


@pytest.mark.parametrize("case", sorted(GRPO_CASES))
def test_grpo_train_step_matches_jax(case):
    jmodel, model = _pair("actor", False, 0, train=True)
    jin, pin = _grouped_rollout(1, dense=case == "dense_rewards")
    kw = dict(dict(n_minibatches=2, gconfig=dict(SAMPLED), group_size=4,
                   kl_coef=0.1), **GRPO_CASES[case])
    got = _assert_train_step(JGRPO(**kw), GRPOInterface(**kw), jmodel, model,
                             jin, pin)
    assert model.engine.version == 2
    assert 0.05 < abs(got["importance_weight"] - 1)  # a real ratio
    assert got["grpo_kl"] > 0 and got["n_seqs"] == 12


@pytest.mark.parametrize("kl_coef", [0.0, 0.2])
def test_reinforce_train_step_matches_jax(kl_coef):
    jmodel, model = _pair("actor", False, 0, train=True)
    jin, pin = _grouped_rollout(2, n_elems=5, per_elem=2)
    kw = dict(n_minibatches=2, gconfig=dict(SAMPLED), kl_coef=kl_coef)
    got = _assert_train_step(JReinforce(**kw), ReinforceInterface(**kw),
                             jmodel, model, jin, pin)
    assert ("ref_kl" in got) == (kl_coef > 0)
    r = pin.data["rewards"].reshape(-1, 2)
    assert got["greedy_reward"] == pytest.approx(float(r[:, 1].mean()))


@pytest.fixture(scope="module")
def actor_pair():
    return _pair("actor", False, 3, train=False)


def _prompts(seed, n=4):
    rng = np.random.default_rng(seed)
    plens = [int(x) for x in rng.integers(2, 9, size=n)]
    prompts = rng.integers(2, VOCAB, size=sum(plens)).astype(np.int32)
    args = (plens, [f"p{i}" for i in range(n)],
            dict(packed_prompts=prompts))
    return JSample.from_default(*args), SequenceSample.from_default(*args)


def test_grpo_generate_greedy_matches_jax(actor_pair):
    jmodel, model = actor_pair
    jin, pin = _prompts(4)
    kw = dict(gconfig=dict(GREEDY), group_size=3)
    want = JGRPO(**kw).generate(jmodel, jin)
    got = GRPOInterface(**kw).generate(model, pin)
    _assert_same_sample(got, want, atol=2e-5)
    assert got.ids == pin.ids
    assert all(len(x) == 3 for x in got.seqlens["packed_input_ids"])


def test_reinforce_generate_pairs_sampled_with_greedy(actor_pair):
    """Element i nests [sampled_i, greedy_i]. The greedy halves are the
    tokens of a greedy ``PPOActorInterface.generate`` of the same
    prompts (in the port and in the JAX package); the sampled halves
    continue their own prompt."""
    jmodel, model = actor_pair
    jin, pin = _prompts(5)
    out = ReinforceInterface(gconfig=dict(SAMPLED)).generate(model, pin)
    greedy_cfg = dict(SAMPLED, greedy=True)
    want = PPOActorInterface(gconfig=dict(greedy_cfg)).generate(model, pin)
    jwant = JActor(gconfig=dict(greedy_cfg)).generate(jmodel, jin)
    _assert_same_sample(want, jwant, atol=2e-5)
    assert out.ids == pin.ids
    assert out.keys == want.keys
    nested = out.seqlens["packed_input_ids"]
    assert [x[1] for x in nested] == [x[0] for x in
                                     want.seqlens["packed_input_ids"]]
    parts = out.unpack()
    greedy = want.unpack()
    plens = [x[0] for x in pin.seqlens["packed_prompts"]]
    off = 0
    for part, g, pl in zip(parts, greedy, plens):
        ls, lg = part.seqlens["packed_input_ids"][0]
        ids = part.data["packed_input_ids"]
        np.testing.assert_array_equal(ids[ls:], g.data["packed_input_ids"])
        np.testing.assert_array_equal(part.data["prompt_mask"][ls:],
                                      g.data["prompt_mask"])
        prompt = pin.data["packed_prompts"][off:off + pl]
        np.testing.assert_array_equal(ids[:pl], prompt)
        assert 2 <= ls - pl <= 6
        assert part.data["prompt_mask"][:ls].sum() == pl
        lp = part.data["packed_logprobs"][:ls - 1]
        assert (lp[pl - 1:] < 0).all() and (lp[:pl - 1] == 0).all()
        off += pl


BAD_ARGS = dict(
    grpo_adaptive_kl=(JGRPO, GRPOInterface,
                      dict(use_adaptive_kl_ctl=True)),
    grpo_early_stop=(JGRPO, GRPOInterface, dict(early_stop_kl=0.1)),
    grpo_warped_with_mask=(JGRPO, GRPOInterface, dict(
        gconfig=dict(SAMPLED, top_k=5, force_no_logits_mask=False))),
    reinforce_greedy=(JReinforce, ReinforceInterface, dict(
        gconfig=dict(GREEDY, force_no_logits_mask=True))),
    reinforce_mask=(JReinforce, ReinforceInterface, dict(
        gconfig=dict(SAMPLED, force_no_logits_mask=False))),
)


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_post_init_raises_where_jax_raises(case):
    jcls, cls, kw = BAD_ARGS[case]
    with pytest.raises(ValueError):
        jcls(**kw)
    with pytest.raises(ValueError):
        cls(**kw)


# ----------------------------------------------------------------------
# the grpo and profile experiments
# ----------------------------------------------------------------------
def test_grpo_experiment_matches_jax(tmp_path):
    path = str(tmp_path / "prompts.jsonl")
    write_prompts(path)
    overrides = {
        "dataset.path": path, "dataset.train_bs_n_seqs": "4",
        "dataset.max_seqlen": "16", "grpo.group_size": "3",
        "grpo.greedy": "true", "grpo.max_new_tokens": "6",
        "grpo.min_new_tokens": "2", "grpo.ppo_n_minibatches": "2",
        "grpo.reward_output_scaling": "0", "grpo.kl_coef": "0.1",
        "actor_train_n_mbs": "2", "benchmark_steps": "2",
        "actor.optimizer.lr": "1e-2",
        "actor.optimizer.lr_scheduler_type": "constant",
        "actor.optimizer.warmup_steps_proportion": "0"}
    jr, runner = experiment_runners(JGRPOConfig, GRPOConfig, overrides)
    assert [n.name for n in runner.dfg.nodes] == [
        "actor_gen", "rew_inf", "ref_inf", "actor_train"]
    assert set(runner.models) == {"actor", "ref", "reward"}
    got = run_steps(runner)
    assert_same_steps(got, run_steps(jr))
    assert_same_versions(jr, runner)
    batch, stats = got[1]
    assert all(len(x) == 3 for x in batch.seqlens["packed_input_ids"])
    assert stats["actor_train"]["grpo_kl"] > 0
    # a per-MFC layout parses into the spec (the parallelism slice;
    # tests/test_torch_realloc.py runs it)
    spec = GRPOConfig(actor_gen_alloc="d2t1").build()
    assert spec.alloc_of("actor_gen").parallel.data_parallel_size == 2


def test_profile_experiment_matches_jax():
    overrides = {"n_prompts": "16", "dataset.train_bs_n_seqs": "8",
                 "prompt_len_min": "4", "prompt_len_max": "12",
                 "ppo.greedy": "true", "ppo.max_new_tokens": "6",
                 "ppo.min_new_tokens": "2", "ppo.ppo_n_minibatches": "2",
                 "lr": "1e-3", "bf16": "false", "benchmark_steps": "2"}
    jr, runner = experiment_runners(JProfile, ProfileConfig, overrides,
                                    tiny=None, tok_vocab=998)
    assert [n.name for n in runner.dfg.nodes] == [
        "actor_gen", "rew_inf", "ref_inf", "critic_inf", "actor_train",
        "critic_train"]
    assert runner.spec.ctl.benchmark_steps == 2
    assert runner.models["actor"].config.vocab_size == 1000
    got = run_steps(runner)
    assert_same_steps(got, run_steps(jr))
    assert_same_versions(jr, runner)
    # a profile run with no step count takes three
    assert ProfileConfig().build().ctl.benchmark_steps == 3
