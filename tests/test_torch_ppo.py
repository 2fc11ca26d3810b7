"""Each of the six PPO MFCs of the port against the JAX package's
interface on the same ``SequenceSample``: ``actor_gen`` (greedy),
``rew_inf``, ``ref_inf``, ``critic_inf``, ``actor_train`` and
``critic_train``, on tiny fp32 models whose JAX weights are carried into
the port with ``params_from_numpy``. The train steps run 2 minibatches
of 2 microbatches, with a logits mask, with ``weight_version`` metadata,
with ``dense_rewards``, and with an early stop that skips every update.
Interface state (KL coefficient, running mean/std) starts equal on both
sides: the same constructor arguments and the same warm-up update.

Tolerances: fp32 on the CPU on both sides, sums in different orders.
Log-probs, values and rewards of order 1-5: 2e-5 absolute. Train stats:
2e-4 relative or 2e-6 absolute (the actor's loss is a mean of
normalized advantages that cancels to ~1e-3). Params after two AdamW
steps at lr 1e-2, whose per-element step is ~lr whatever the gradient's
size: a relative gradient difference of ~1e-4 on a near-cancelling
gradient moves a param by ~1e-6: 1e-4 absolute.
"""

import jax
import numpy as np
import pytest

from realhf_tpu.api import model as jmodel_api
from realhf_tpu.api.config import ModelName
from realhf_tpu.api.data import SequenceSample as JSample
from realhf_tpu.engine.engine import Engine as JEngine
from realhf_tpu.engine.optim import OptimizerConfig as JOpt
from realhf_tpu.interfaces.ppo import PPOActorInterface as JActor
from realhf_tpu.interfaces.ppo import PPOCriticInterface as JCritic
from realhf_tpu.interfaces.rw import PairedRewardInterface as JReward
from realhf_tpu.models import transformer as JT
from realhf_tpu.models.config import TransformerConfig as JConfig
from realhf_tpu.parallel.mesh import (
    MeshContext,
    ParallelismConfig,
    default_devices,
    make_mesh,
)
from realhf_tpu_torch.api import model as model_api
from realhf_tpu_torch.api.data import SequenceSample
from realhf_tpu_torch.engine.engine import Engine
from realhf_tpu_torch.engine.optim import OptimizerConfig
from realhf_tpu_torch.interfaces.ppo import (
    PPOActorInterface,
    PPOCriticInterface,
)
from realhf_tpu_torch.interfaces.rw import PairedRewardInterface
from realhf_tpu_torch.models.config import TransformerConfig

VOCAB = 64
TINY = dict(n_layers=2, n_kv_heads=2, n_q_heads=4, hidden_dim=32,
            intermediate_dim=64, vocab_size=VOCAB, apply_rotary=True,
            layer_norm_type="rms", mlp_type="llama",
            use_attention_bias=False, use_attn_proj_bias=False,
            use_mlp_bias=False, activation_function="silu",
            param_dtype="float32", compute_dtype="float32",
            gradient_checkpointing=True)
OPT = dict(lr=1e-2, lr_scheduler_type="constant", warmup_steps_proportion=0.0)
GCONFIG = dict(max_new_tokens=8, min_new_tokens=3, greedy=True)
N_SEQS = 6


class Tokenizer:
    pad_token_id = 0
    eos_token_id = 1


def _pair(role, is_critic, seed, train):
    """The same model as a JAX ``Model`` and a port ``Model``."""
    jcfg = JConfig(**TINY, is_critic=is_critic)
    parallel = ParallelismConfig()
    mesh = make_mesh(parallel, devices=default_devices()[:1])
    ctx = MeshContext(ModelName(role, 0), mesh, parallel)
    jeng = JEngine(jcfg, ctx, JT.init_params(jcfg, jax.random.PRNGKey(seed)),
                   optimizer=JOpt(**OPT) if train else None,
                   total_train_steps=100)
    eng = Engine(TransformerConfig(**TINY, is_critic=is_critic),
                 jeng.params_numpy(), device="cpu",
                 optimizer=OptimizerConfig(**OPT) if train else None,
                 total_train_steps=100)
    return (jmodel_api.Model(ModelName(role, 0), jeng, Tokenizer()),
            model_api.Model(ModelName(role, 0), eng, Tokenizer()))


def _assert_same_sample(got: SequenceSample, want: JSample, atol=0.0):
    assert got.keys == want.keys and got.ids == want.ids
    assert got.seqlens == want.seqlens
    for k in want.keys:
        assert got.data[k].dtype == want.data[k].dtype, k
        if atol and got.data[k].dtype == np.float32:
            np.testing.assert_allclose(got.data[k], want.data[k], rtol=0,
                                       atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(got.data[k], want.data[k],
                                          err_msg=k)


def _rollout(seed=0, with_mask=True):
    """A synthetic rollout batch as ``actor_gen`` and the three inference
    MFCs would leave it: random tokens, behaviour and reference
    log-probs, scores, values, a mix of finished and truncated
    sequences, and a logits mask (stored True = masked out) that never
    masks a token that was taken."""
    rng = np.random.default_rng(seed)
    plens = rng.integers(2, 7, size=N_SEQS)
    lens = plens + rng.integers(3, 12, size=N_SEQS)
    n = int(lens.sum())
    ids = rng.integers(2, VOCAB, size=n).astype(np.int32)
    data = dict(
        packed_input_ids=ids,
        prompt_mask=np.concatenate([np.arange(l) < p
                                    for l, p in zip(lens, plens)]),
        packed_logprobs=(-rng.random(n - N_SEQS) * 4).astype(np.float32),
        packed_ref_logprobs=(-rng.random(n - N_SEQS) * 4).astype(np.float32),
        rewards=rng.standard_normal(N_SEQS).astype(np.float32),
        values=rng.standard_normal(n).astype(np.float32),
        seq_no_eos_mask=np.arange(N_SEQS) % 3 == 0)
    if with_mask:
        mask = rng.random((n, VOCAB)) > 0.8
        off = 0
        for l in lens:  # row t masks the logits that predict token t + 1
            mask[np.arange(off, off + l - 1), ids[off + 1:off + l]] = False
            off += l
        data["packed_logits_mask"] = mask
    return [int(l) for l in lens], data


def _samples(lens, data, metadata=None):
    ids = list(range(len(lens)))
    return (JSample.from_default(lens, ids, dict(data), metadata),
            SequenceSample.from_default(lens, ids, dict(data), metadata))


@pytest.fixture(scope="module")
def inference_models():
    return dict(actor=_pair("actor", False, 0, train=False),
                critic=_pair("critic", True, 1, train=False),
                reward=_pair("reward", True, 2, train=False))


def test_actor_gen_greedy_matches_jax(inference_models):
    jmodel, model = inference_models["actor"]
    rng = np.random.default_rng(5)
    plens = [int(x) for x in rng.integers(2, 9, size=5)]
    prompts = rng.integers(2, VOCAB, size=sum(plens)).astype(np.int32)
    args = (plens, list(range(5)), dict(packed_prompts=prompts))
    want = JActor(gconfig=dict(GCONFIG)).generate(
        jmodel, JSample.from_default(*args))
    got = PPOActorInterface(gconfig=dict(GCONFIG)).generate(
        model, SequenceSample.from_default(*args))
    assert want.keys == {"seq_no_eos_mask", "packed_input_ids",
                         "packed_logprobs", "prompt_mask",
                         "packed_logits_mask"}
    _assert_same_sample(got, want, atol=2e-5)
    # greedy: the mask drops only the EOS suppressed below min_new_tokens
    mask = got.data["packed_logits_mask"]
    assert mask.shape == (sum(sum(l) for l in
                              got.seqlens["packed_input_ids"]), VOCAB)
    assert mask.any() and not mask[:, 2:].any()
    no_mask = PPOActorInterface(gconfig=dict(
        GCONFIG, force_no_logits_mask=True)).generate(
            model, SequenceSample.from_default(*args))
    assert "packed_logits_mask" not in no_mask.keys


def test_ref_inf_matches_jax_with_and_without_logits_mask(inference_models):
    jmodel, model = inference_models["actor"]
    for with_mask in (True, False):
        lens, data = _rollout(with_mask=with_mask)
        keys = ["packed_input_ids"] + (["packed_logits_mask"]
                                      if with_mask else [])
        jin, pin = _samples(lens, {k: data[k] for k in keys})
        gc = dict(GCONFIG, temperature=0.7)
        want = JActor(gconfig=dict(gc)).inference(jmodel, jin, n_mbs=2)
        got = PPOActorInterface(gconfig=dict(gc)).inference(model, pin,
                                                            n_mbs=2)
        _assert_same_sample(got, want, atol=2e-5)
        assert got.data["packed_ref_logprobs"].shape == (sum(lens) - N_SEQS,)
    # masking other tokens out can only raise a taken token's log-prob,
    # and does raise some: a flipped polarity (the taken token masked
    # out, at -1e30) would show
    lens, data = _rollout()
    itf = PPOActorInterface(gconfig=dict(GCONFIG))
    _, masked = _samples(lens, dict(
        packed_input_ids=data["packed_input_ids"],
        packed_logits_mask=data["packed_logits_mask"]))
    _, plain = _samples(lens, dict(packed_input_ids=data["packed_input_ids"]))
    with_mask = itf.inference(model, masked).data["packed_ref_logprobs"]
    without = itf.inference(model, plain).data["packed_ref_logprobs"]
    assert (with_mask > without - 1e-6).all()
    assert (with_mask > without + 1e-3).any() and with_mask.min() > -20


def test_critic_inf_and_rew_inf_match_jax(inference_models):
    lens, data = _rollout()
    jin, pin = _samples(lens, dict(packed_input_ids=data["packed_input_ids"]))
    jmodel, model = inference_models["critic"]
    want = JCritic().inference(jmodel, jin, n_mbs=2)
    got = PPOCriticInterface().inference(model, pin, n_mbs=2)
    _assert_same_sample(got, want, atol=2e-5)
    assert got.data["values"].shape == (sum(lens),)

    jmodel, model = inference_models["reward"]
    kw = dict(output_scaling=2.0, output_bias=0.25)
    want = JReward(**kw).inference(jmodel, jin)
    got = PairedRewardInterface(**kw).inference(model, pin)
    _assert_same_sample(got, want, atol=2e-5)
    assert got.data["rewards"].shape == (N_SEQS,)


def _warm(itf, seed=9):
    """Give the running mean/std a state that is not the identity."""
    rng = np.random.default_rng(seed)
    itf.rms.update(rng.standard_normal(40) * 2 + 0.5)
    return itf


def _assert_train_step(jitf, itf, jmodel, model, jin, pin, n_mbs=2):
    want = jitf.train_step(jmodel, jin, n_mbs=n_mbs)
    got = itf.train_step(model, pin, n_mbs=n_mbs)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-6,
                                   err_msg=k)
    assert model.version.global_step == jmodel.version.global_step
    assert model.engine.version == jmodel.engine.version
    np.testing.assert_allclose(itf.kl_adapter.value, jitf.kl_adapter.value,
                               rtol=1e-9)
    np.testing.assert_allclose(itf.rms.mean_std(), jitf.rms.mean_std(),
                               rtol=1e-6)
    want_p = jax.tree_util.tree_leaves_with_path(jmodel.engine.params_numpy())
    got_p = dict(jax.tree_util.tree_leaves_with_path(
        model.engine.params_numpy()))
    for path, a in want_p:
        np.testing.assert_allclose(got_p[path], a, rtol=0, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    return got


ACTOR = dict(n_minibatches=2, gconfig=dict(GCONFIG, temperature=0.9),
             kl_ctl=0.1, gae_lambda=0.95, discount=0.99, value_norm=True,
             value_norm_beta=0.9, use_adaptive_kl_ctl=True,
             adaptive_kl_horizon=100.0, early_stop_imp_ratio=50.0)
CRITIC = dict(n_minibatches=2, kl_ctl=0.1, gae_lambda=0.95, discount=0.99,
              value_norm=True, value_norm_beta=0.9, use_adaptive_kl_ctl=True,
              adaptive_kl_horizon=100.0)


@pytest.mark.parametrize("case", ["logits_mask", "weight_version",
                                  "dense_rewards"])
def test_actor_train_matches_jax(case):
    jmodel, model = _pair("actor", False, 0, train=True)
    lens, data = _rollout(seed=1, with_mask=case == "logits_mask")
    kw, metadata = dict(ACTOR), None
    if case == "weight_version":
        # trainer at version 3: staleness 0, 1, 2, 3, 0, 1; the one at 3
        # is dropped, the others but the fresh take the clipped-IS weight
        for m in (jmodel, model):
            m.version.global_step = 3
        metadata = dict(weight_version=[3, 2, 1, 0, 3, 2])
        kw.update(max_staleness=2, staleness_is_clip=1.5)
    if case == "dense_rewards":
        rng = np.random.default_rng(8)
        data["dense_rewards"] = np.where(
            rng.random(sum(lens) - N_SEQS) > 0.7,
            rng.standard_normal(sum(lens) - N_SEQS), 0).astype(np.float32)
        kw.update(turn_level_credit=True)
    jin, pin = _samples(lens, data, metadata)
    jitf, itf = _warm(JActor(**kw)), _warm(PPOActorInterface(**kw))
    got = _assert_train_step(jitf, itf, jmodel, model, jin, pin)
    assert model.engine.version == 2 and got["early_stop_skipped"] == 0.0
    assert 0.05 < abs(got["importance_weight"] - 1)  # a real ratio
    if case == "weight_version":
        assert got["n_dropped_stale"] == 1 and got["staleness_max"] == 3
        assert got["stale_is_weight"] != 1.0
    if case == "dense_rewards":
        assert got["dense_reward_sum"] == float(data["dense_rewards"].sum())


def test_actor_train_early_stop_skips_every_update():
    jmodel, model = _pair("actor", False, 0, train=True)
    lens, data = _rollout(seed=1)
    jin, pin = _samples(lens, data)
    kw = dict(ACTOR, early_stop_imp_ratio=1e-3)
    before = model.engine.params_numpy()
    got = _assert_train_step(_warm(JActor(**kw)),
                             _warm(PPOActorInterface(**kw)),
                             jmodel, model, jin, pin)
    assert got["early_stop_skipped"] == 1.0
    jax.tree.map(np.testing.assert_array_equal, model.engine.params_numpy(),
                 before)
    # the versions advance all the same; moments and step count do not
    assert model.engine.version == 2 and model.version.global_step == 1
    assert model.engine.optimizer.count == 0


@pytest.mark.parametrize("case", ["plain", "dense_rewards"])
def test_critic_train_matches_jax(case):
    jmodel, model = _pair("critic", True, 1, train=True)
    lens, data = _rollout(seed=2, with_mask=False)
    kw = dict(CRITIC)
    if case == "dense_rewards":
        rng = np.random.default_rng(8)
        data["dense_rewards"] = np.where(
            rng.random(sum(lens) - N_SEQS) > 0.7,
            rng.standard_normal(sum(lens) - N_SEQS), 0).astype(np.float32)
        kw.update(turn_level_credit=True)
    jin, pin = _samples(lens, data)
    got = _assert_train_step(_warm(JCritic(**kw)),
                             _warm(PPOCriticInterface(**kw)),
                             jmodel, model, jin, pin)
    assert model.engine.version == 2 and got["value_loss"] > 0


def test_reward_train_step_matches_jax(tmp_path):
    """Paired reward modeling on interleaved (pos, neg) sequences, two
    microbatches of unequal pair counts."""
    jmodel, model = _pair("reward", True, 2, train=True)
    rng = np.random.default_rng(3)
    nested = [[5, 7], [4, 6, 9, 3], [8, 8]]
    n = sum(sum(x) for x in nested)
    ids = rng.integers(2, VOCAB, size=n).astype(np.int32)
    kw = dict(keys=["packed_input_ids"],
              trailing_shapes=dict(packed_input_ids=()),
              dtypes=dict(packed_input_ids=np.int32), ids=[0, 1, 2],
              seqlens=dict(packed_input_ids=nested),
              data=dict(packed_input_ids=ids))
    want = JReward().train_step(jmodel, JSample(**kw), n_mbs=2)
    got = PairedRewardInterface().train_step(model, SequenceSample(**kw),
                                             n_mbs=2)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-6,
                                   err_msg=k)
    assert model.version.global_step == 1
    # the trained reward model saves as a critic: HF layout + value head
    PairedRewardInterface(enable_save=False).save(model, str(tmp_path / "no"))
    assert not (tmp_path / "no").exists()
    PairedRewardInterface().save(model, str(tmp_path / "rw"))
    assert (tmp_path / "rw" / "value_head.safetensors").exists()
