"""The port's transformer against the JAX package's on the same weights
(carried with ``params_from_numpy``) and the same numpy inputs: forward
hidden states, LM logits, prefill KV caches and decode steps, on a tiny
llama-style config (GQA, rotary with linear or dynamic scaling) and a
gpt2-style one (LayerNorm, biases, absolute positions, gelu).

Tolerances: fp32 on both sides; the JAX side runs XLA einsums and the
port torch matmuls, whose sums differ in order. 1e-4 on values of
order 1 is a few hundred ulps after two layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realhf_tpu.models import transformer as JT
from realhf_tpu.models.config import TransformerConfig as JConfig
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.models.convert import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
BASE = dict(n_layers=2, hidden_dim=32, intermediate_dim=64, vocab_size=97,
            param_dtype="float32", compute_dtype="float32")
CONFIGS = {
    "llama_gqa_linear": dict(
        n_kv_heads=2, n_q_heads=4, apply_rotary=True, layer_norm_type="rms",
        mlp_type="llama", use_attention_bias=False,
        use_attn_proj_bias=False, use_mlp_bias=False,
        activation_function="silu", rotary_scaling=2.0,
        rotary_scaling_type="linear"),
    "llama_dynamic_ntk": dict(
        n_kv_heads=1, n_q_heads=4, apply_rotary=True, layer_norm_type="rms",
        mlp_type="llama", use_attention_bias=False,
        use_attn_proj_bias=False, use_mlp_bias=False,
        activation_function="silu", rotary_scaling=2.0,
        rotary_scaling_type="dynamic", n_positions=16),
    "gpt2": dict(
        n_kv_heads=4, n_q_heads=4, n_positions=64,
        activation_function="gelu_new", scale_attn_by_inverse_layer_idx=True),
}


def _models(name):
    kw = dict(BASE, **CONFIGS[name])
    jcfg, tcfg = JConfig(**kw), TransformerConfig(**kw)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    # non-trivial biases / norm scales so every parameter matters
    rng = np.random.default_rng(9)
    host = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
        .astype(np.float32), jax.device_get(jparams))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, host), params_from_numpy(host)


def _packed_batch(rng, b=2, l=24, vocab=97):
    ids = rng.integers(0, vocab, size=(b, l)).astype(np.int32)
    seg = np.zeros((b, l), np.int32)
    seg[0, :10], seg[0, 10:20] = 1, 2          # two packed sequences + pad
    seg[1, 3:] = 1                             # leading pad
    return ids, seg


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_hidden_and_logits(name):
    jcfg, tcfg, jp, tp = _models(name)
    ids, seg = _packed_batch(np.random.default_rng(0))
    jh, _ = JT.forward(jcfg, jp, jnp.asarray(ids), jnp.asarray(seg))
    th, _ = T.forward(tcfg, tp, torch.from_numpy(ids), torch.from_numpy(seg))
    valid = seg != 0
    np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid],
                               **TOL)
    jl = JT.lm_logits(jcfg, jp, jh)
    tl = T.lm_logits(tcfg, tp, th)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                               **TOL)


@pytest.mark.parametrize("critic", [False, True],
                         ids=["lm_logits", "critic_values"])
def test_head_in_bf16_sums_and_returns_fp32(critic):
    """bf16 hidden states and head: both sides sum the (exact) bf16
    products in fp32 and return fp32, so they agree to fp32 summation
    order, 1e-5 of the outputs' scale. A result rounded to bf16 before
    widening would be off by up to 2**-9 of it."""
    h, vocab = 256, 97
    kw = dict(BASE, n_kv_heads=2, n_q_heads=4, hidden_dim=h,
              vocab_size=vocab, is_critic=critic, param_dtype="bfloat16",
              compute_dtype="bfloat16")
    jcfg, tcfg = JConfig(**kw), TransformerConfig(**kw)
    rng = np.random.default_rng(5)
    w = rng.standard_normal((h, 1 if critic else vocab)).astype(np.float32)
    x = rng.standard_normal((3, 4, h)).astype(np.float32)
    jfn, tfn = ((JT.critic_values, T.critic_values) if critic
                else (JT.lm_logits, T.lm_logits))
    want = np.asarray(jfn(jcfg, {"head": {"w": jnp.asarray(w, jnp.bfloat16)}},
                          jnp.asarray(x, jnp.bfloat16)))
    got = tfn(tcfg, {"head": {"w": torch.from_numpy(w).bfloat16()}},
              torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_positions_from_segments():
    seg = np.asarray([[1, 1, 2, 2, 2, 0, 0], [0, 0, 1, 1, 1, 1, 3]],
                     np.int32)
    ref = np.asarray(JT.positions_from_segments(jnp.asarray(seg)))
    got = T.positions_from_segments(torch.from_numpy(seg)).numpy()
    np.testing.assert_array_equal(got, ref)


def _prompts(rng, lens, lp, vocab=97):
    ids = np.zeros((len(lens), lp), np.int32)
    seg = np.zeros_like(ids)
    pos = np.zeros_like(ids)
    for i, n in enumerate(lens):  # left padded, as generation builds them
        ids[i, lp - n:] = rng.integers(2, vocab, size=n)
        seg[i, lp - n:] = 1
        pos[i, lp - n:] = np.arange(n)
    return ids, seg, pos


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("uniform_slot", [True, False])
@pytest.mark.parametrize("stacked", [False, True],
                         ids=["per_layer_views", "stacked_cache"])
def test_prefill_and_decode_steps(name, uniform_slot, stacked, monkeypatch):
    if stacked:  # take the >48-layer path of the port at 2 layers
        monkeypatch.setattr(T, "_DECODE_UNROLL_MAX_LAYERS", 1)
    jcfg, tcfg, jp, tp = _models(name)
    rng = np.random.default_rng(1)
    ids, seg, pos = _prompts(rng, [5, 9, 2], lp=9)
    jh, jc = JT.prefill(jcfg, jp, *map(jnp.asarray, (ids, seg, pos)),
                        total_len=12)
    th, tc = T.prefill(tcfg, tp, *map(torch.from_numpy, (ids, seg, pos)),
                       total_len=12)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL, err_msg=key)
    for key in ("valid", "length"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))
    np.testing.assert_allclose(th.numpy()[:, -1], np.asarray(jh)[:, -1],
                               **TOL)
    lens = seg.sum(-1).astype(np.int32)
    for step in range(3):
        tok = rng.integers(2, 97, size=3).astype(np.int32)
        p = lens + step
        jh, jc = JT.decode_step(jcfg, jp, jc, jnp.asarray(tok),
                                jnp.asarray(p), uniform_slot=uniform_slot)
        th, tc = T.decode_step(tcfg, tp, tc, torch.from_numpy(tok),
                               torch.from_numpy(p),
                               uniform_slot=uniform_slot)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL,
                                   err_msg=f"decode step {step}")
        np.testing.assert_array_equal(tc["valid"].numpy(),
                                      np.asarray(jc["valid"]))
        np.testing.assert_array_equal(tc["length"].numpy(),
                                      np.asarray(jc["length"]))
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)


def test_moe_and_pipeline_are_deferred():
    kw = dict(BASE, **CONFIGS["llama_gqa_linear"])
    cfg = TransformerConfig(**dict(kw, mlp_type="moe"),
                            moe=__import__("realhf_tpu_torch.models.config",
                                           fromlist=["MoEConfig"]).MoEConfig())
    with pytest.raises(NotImplementedError):
        T.init_params(cfg, torch.Generator().manual_seed(0))
    tcfg = TransformerConfig(**kw)
    tp = T.init_params(tcfg, torch.Generator().manual_seed(0))
    ids = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        T.forward(tcfg, tp, ids, ids + 1, pipeline=object())


def test_init_params_matches_jax_tree_and_scales():
    for name in CONFIGS:
        kw = dict(BASE, **CONFIGS[name])
        jparams = jax.device_get(JT.init_params(JConfig(**kw),
                                                jax.random.PRNGKey(0)))
        tparams = T.init_params(TransformerConfig(**kw),
                                torch.Generator().manual_seed(0))
        jl = jax.tree_util.tree_leaves_with_path(jparams)
        flat = {jax.tree_util.keystr(p): a for p, a in jl}
        tl = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda t: t.numpy(), tparams))
        tflat = {jax.tree_util.keystr(p): a for p, a in tl}
        assert flat.keys() == tflat.keys(), name
        for path, a in flat.items():
            b = tflat[path]
            assert a.shape == b.shape, path
            if a.std() > 0:  # same distribution: std within 20%
                assert abs(b.std() / a.std() - 1) < 0.2, path
            else:
                np.testing.assert_array_equal(a, b)
