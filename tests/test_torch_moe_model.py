"""A tiny Mixtral (MoE, top-2 of 4 experts) and a tiny Mistral (window 8
over 32-token streams) in the port against the JAX package on the same
weights (carried with ``params_from_numpy``) and the same numpy inputs:
the forward with its aux losses (and the same gradients under gradient
checkpointing, whose recompute routes as the first pass did), greedy
``generate``, the inflight generator (dense and paged KV), the
context-parallel forward at c4 against c1, a checkpoint written by the
JAX package built into a port model (and the port's save read back by
the JAX package), and one SFT step's loss, aux losses and gradients.

Tolerances: fp32 on the CPU on both sides, sums in different orders, as
``test_torch_transformer.py`` (1e-4 on values of order 1), greedy
tokens equal; gradients 1e-4 of each leaf's largest element. The
weights get a N(0, 0.05) offset, so router logits spread (std ~0.3) and
no token's experts tie.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realhf_tpu.engine import generation as jgen
from realhf_tpu.engine import packing as jpacking
from realhf_tpu.engine.inflight import InflightBatchingGenerator as JInflight
from realhf_tpu.engine import kv_pool as jkvp
from realhf_tpu.interfaces import sft as jsft
from realhf_tpu.models import hf as jhf
from realhf_tpu.models import transformer as JT
from realhf_tpu.models.config import MoEConfig as JMoE
from realhf_tpu.models.config import TransformerConfig as JConfig
from realhf_tpu.ops.sampling import GenerationHyperparameters as JHyper
from realhf_tpu_torch.api.experiment import ModelSpec
from realhf_tpu_torch.base import seeding
from realhf_tpu_torch.engine import generation as gen
from realhf_tpu_torch.engine import kv_pool as tkvp
from realhf_tpu_torch.engine import packing
from realhf_tpu_torch.engine.engine import Engine
from realhf_tpu_torch.engine.inflight import InflightBatchingGenerator
from realhf_tpu_torch.interfaces import sft
from realhf_tpu_torch.models import hf
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import MoEConfig, TransformerConfig
from realhf_tpu_torch.models.convert import params_from_numpy, params_numpy
from realhf_tpu_torch.ops.sampling import GenerationHyperparameters
from realhf_tpu_torch.parallel.mesh import ParallelismConfig
from realhf_tpu_torch.system.model_host import build_model
from test_torch_inflight import assert_same
from test_torch_sft import _microbatches

TOL = dict(rtol=1e-4, atol=1e-4)
BASE = dict(n_layers=2, n_kv_heads=2, n_q_heads=4, hidden_dim=32,
            intermediate_dim=48, vocab_size=97, apply_rotary=True,
            layer_norm_type="rms", use_attention_bias=False,
            use_attn_proj_bias=False, use_mlp_bias=False,
            activation_function="silu", param_dtype="float32",
            compute_dtype="float32", n_positions=128)
MOE = dict(num_experts=4, top_k=2, aux_loss_coeff=0.02, z_loss_coeff=1e-3)
MODELS = {
    "mixtral": dict(BASE, mlp_type="moe", rotary_base=1e6),
    "mistral": dict(BASE, mlp_type="llama", sliding_window=8),
}


def _configs(name, **kw):
    d = dict(MODELS[name], **kw)
    if name == "mixtral":
        return (JConfig(**d, moe=JMoE(**MOE)),
                TransformerConfig(**d, moe=MoEConfig(**MOE)))
    return JConfig(**d), TransformerConfig(**d)


_WEIGHTS = {}


def _models(name, **kw):
    """(JAX config, JAX params, port config, port params)."""
    if name not in _WEIGHTS:
        jcfg, _ = _configs(name)
        host = jax.device_get(jax.jit(lambda k: JT.init_params(jcfg, k))(
            jax.random.PRNGKey(0)))
        rng = np.random.default_rng(1)
        _WEIGHTS[name] = jax.tree.map(
            lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
            .astype(np.float32), host)
    jcfg, tcfg = _configs(name, **kw)
    host = _WEIGHTS[name]
    return (jcfg, jax.tree.map(jnp.asarray, host), tcfg,
            params_from_numpy(host))


def _packed_batch(rng, l=32):
    """Two streams of 32 tokens: two sequences and padding, and a
    leading pad then one sequence (each longer than the window of 8)."""
    ids = rng.integers(2, 97, size=(2, l)).astype(np.int32)
    seg = np.zeros((2, l), np.int32)
    seg[0, :13], seg[0, 13:29] = 1, 2
    seg[1, 3:] = 1
    return ids, seg


def _prompts(seed, lens=(11, 17, 6, 14)):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 97, size=n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_with_aux_matches_jax(name):
    jcfg, jp, tcfg, tp = _models(name)
    ids, seg = _packed_batch(np.random.default_rng(0))
    jh, _, jaux = jax.jit(lambda p, i, s: JT.forward(
        jcfg, p, i, s, return_aux=True))(jp, jnp.asarray(ids),
                                         jnp.asarray(seg))
    th, _, taux = T.forward(tcfg, tp, torch.from_numpy(ids),
                            torch.from_numpy(seg), return_aux=True)
    valid = seg != 0
    np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid],
                               **TOL)
    assert set(taux) == set(jaux) == (
        {"moe_aux_loss", "moe_z_loss"} if name == "mixtral" else set())
    for k in jaux:
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]),
                                   rtol=1e-5)
    # gradient checkpointing recomputes each block in the backward; the
    # recompute routes as the first pass did, so the gradients are equal
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, gradient_checkpointing=remat)
        p = {k: v for k, v in params_from_numpy(_WEIGHTS[name]).items()}
        leaves = [p["blocks"]["attn"]["wq"], p["blocks"]["mlp"]["wd"]] + (
            [p["blocks"]["mlp"]["router"]] if name == "mixtral" else [])
        for x in leaves:
            x.requires_grad_(True)
        h, _, aux = T.forward(cfg, p, torch.from_numpy(ids),
                              torch.from_numpy(seg), return_aux=True)
        ((h ** 2).sum() + sum(aux.values())).backward()
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(MODELS))
def test_greedy_generate_matches_jax(name):
    jcfg, jp, tcfg, tp = _models(name)
    prompts = _prompts(1)
    g = dict(max_new_tokens=9, greedy=True)
    ids, seg, pos = jpacking.left_padded_prompts(prompts, pad_id=0)
    ref = jax.device_get(jgen.build_generate_fn(jcfg, JHyper(**g), None, 0)(
        jp, ids, seg, pos, jax.random.PRNGKey(3)))
    ids, seg, pos = packing.left_padded_prompts(prompts, pad_id=0)
    t = torch.from_numpy
    got = gen.generate(tcfg, tp, t(ids), t(seg), t(pos), seeding.generator(3),
                       GenerationHyperparameters(**g), eos_token_id=None,
                       pad_token_id=0).to_host()
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_allclose(got.logprobs, ref.logprobs, atol=1e-4)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_inflight_generator_matches_jax(paged):
    """6 prompts through 3 slots (refills), chunk 4, through the MoE
    decode step (x [B, H] routed with no mask) and, paged, the gathered
    window."""
    jcfg, jp, tcfg, tp = _models("mixtral")
    prompts = _prompts(2, (9, 21, 5, 16, 12, 7))
    kw = dict(n_slots=3, max_prompt_len=40, pad_token_id=0, chunk_size=4,
              eos_token_id=None)
    g = dict(max_new_tokens=8, greedy=True, force_no_logits_mask=True)
    jkw, tkw = dict(kw), dict(kw)
    if paged:
        jkw["kv_pool"] = jkvp.KVPool(jcfg, 48, 8, dtype="fp32")
        tkw["kv_pool"] = tkvp.KVPool(tcfg, 48, 8, dtype="fp32",
                                     device="cpu")
    ref = JInflight(jcfg, jp, JHyper(**g), **jkw).generate_all(
        prompts, jax.random.PRNGKey(0))
    got = InflightBatchingGenerator(
        tcfg, tp, GenerationHyperparameters(**g), device="cpu",
        **tkw).generate_all(prompts)
    assert_same(ref, got, atol=1e-4)


def test_forward_ctx_c4_equals_c1():
    """Routing is per token, so the context-parallel forward (each
    member routes its own shard) gives the single-device result."""
    _, _, tcfg, tp = _models("mixtral")
    ids, seg = _packed_batch(np.random.default_rng(4), l=40)
    weights = params_numpy(tp)
    c4 = Engine(tcfg, weights, device="cpu",
                parallel=ParallelismConfig(context_parallel_size=4),
                devices=["cpu"] * 4)
    c1 = Engine(tcfg, weights, device="cpu")
    got = c4.forward_logprobs(ids, seg).numpy()
    want = c1.forward_logprobs(ids, seg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_jax_checkpoint_builds_in_port_and_back(tmp_path):
    """A Mixtral checkpoint the JAX package wrote loads into the port's
    model host (the streamed load) with every leaf bit-equal, builds a
    model whose greedy tokens equal the JAX model's, and the port's save
    of it reads back in the JAX package bit for bit."""
    jcfg, jp, _, _ = _models("mixtral")
    jhf.save_hf_checkpoint(str(tmp_path / "jax"), "mixtral", jcfg, jp)
    model = build_model("actor", ModelSpec(path=str(tmp_path / "jax"),
                                           hf_family="mixtral", bf16=False),
                        None, init_seed=1, device="cpu")
    eng = model.engine
    assert eng.cfg.mlp_type == "moe" and eng.cfg.moe.num_experts == 4
    got_tree = eng.params_numpy()
    for path, a in jax.tree_util.tree_leaves_with_path(_WEIGHTS["mixtral"]):
        b = dict(jax.tree_util.tree_leaves_with_path(got_tree))[path]
        np.testing.assert_array_equal(b, a, err_msg=str(path))
    prompts = _prompts(3)
    g = dict(max_new_tokens=8, greedy=True)
    ids, seg, pos = jpacking.left_padded_prompts(prompts, pad_id=0)
    lcfg, lparams = jhf.load_hf_checkpoint(str(tmp_path / "jax"))
    lcfg.compute_dtype = "float32"
    ref = jax.device_get(jgen.build_generate_fn(lcfg, JHyper(**g), None, 0)(
        lparams, ids, seg, pos, jax.random.PRNGKey(0)))
    ids, seg, pos = packing.left_padded_prompts(prompts, pad_id=0)
    out = eng.generate(ids, seg, pos, seeding.generator(0),
                       GenerationHyperparameters(**g), eos_token_id=None,
                       pad_token_id=0).to_host()
    np.testing.assert_array_equal(out.tokens, ref.tokens)
    hf.save_hf_checkpoint(str(tmp_path / "port"), "mixtral", eng.cfg,
                          eng.params)
    _, back = jhf.load_hf_checkpoint(str(tmp_path / "port"))
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(_WEIGHTS["mixtral"]),
            jax.tree_util.tree_leaves_with_path(jax.device_get(back))):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=str(path))


@pytest.mark.parametrize("name", list(MODELS))
def test_sft_step_matches_jax(name):
    """One SFT loss over two microbatches: the loss, nll and each MoE aux
    loss, and the gradient of every leaf (``jax.grad`` against
    autograd)."""
    jcfg, jp, tcfg, tp = _models(name)
    mbs, _ = _microbatches()
    jgrad = jax.jit(jax.value_and_grad(jsft._make_loss_fn(jcfg),
                                       has_aux=True))
    tloss = sft._make_loss_fn(tcfg)
    for mb in mbs:
        (jl, jst), jg = jgrad(jp, {k: jnp.asarray(v) for k, v in mb.items()})
        p = params_from_numpy(_WEIGHTS[name])
        leaves = jax.tree.leaves(p)
        for x in leaves:
            x.requires_grad_(True)
        tl, tst = tloss(p, {k: torch.from_numpy(v) for k, v in mb.items()})
        tl.backward()
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
        want_keys = {"nll", "n_tokens"} | (
            {"moe_aux_loss", "moe_z_loss"} if name == "mixtral" else set())
        assert set(tst) == set(jst) == want_keys
        for k in jst:
            np.testing.assert_allclose(tst[k].item(), float(jst[k]),
                                       rtol=1e-5, err_msg=k)
        if name == "mixtral":
            np.testing.assert_allclose(
                tl.item(), (tst["nll"] + tst["moe_aux_loss"]
                            + tst["moe_z_loss"]).item(), rtol=1e-6)
        for (path, want), got in zip(
                jax.tree_util.tree_leaves_with_path(jg), leaves):
            want = np.asarray(want)
            np.testing.assert_allclose(
                got.grad.numpy(), want, rtol=0,
                atol=1e-4 * np.abs(want).max(),
                err_msg=jax.tree_util.keystr(path))


def test_check_supported_raises_only_what_is_not_wired():
    _, tcfg = _configs("mixtral")
    T.check_supported(tcfg)
    cfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, input_jitter_eps=0.01))
    with pytest.raises(NotImplementedError, match="queue 1, item 3"):
        T.check_supported(cfg)
    with pytest.raises(NotImplementedError, match="queue 1, item 3"):
        Engine(cfg, params_numpy(_models("mixtral")[3]), device="cpu")
    # expert parallelism is supported; with ragged dispatch the engine
    # refuses it with the JAX engine's message, at any layout
    cfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, expert_parallel=True))
    T.check_supported(cfg)
    assert cfg.moe.capacity_factor is None and cfg.moe.use_grouped_gemm
    with pytest.raises(ValueError, match="requires the capacity or "
                       "dense dispatch mode"):
        Engine(cfg, params_numpy(_models("mixtral")[3]), device="cpu")
