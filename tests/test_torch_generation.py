"""Batch generation in the port against the JAX package on the same
weights and prompts: greedy tokens equal, logprobs close; EOS handling,
min-new-tokens suppression and early exit; the logits mask; and the
top-k / top-p warper on the same logits.

Tolerances: fp32 on both sides. Logprobs of the same greedy trajectory
differ only by summation order (1e-4). Sampling is compared by its
invariants, not draw by draw: torch and JAX random streams differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realhf_tpu.engine import generation as jgen
from realhf_tpu.engine import packing as jpacking
from realhf_tpu.models import transformer as JT
from realhf_tpu.models.config import TransformerConfig as JConfig
from realhf_tpu.ops.sampling import (
    GenerationHyperparameters as JGen,
    top_k_top_p_logits as jax_top_k_top_p,
)
from realhf_tpu_torch.base import seeding
from realhf_tpu_torch.engine import generation as gen
from realhf_tpu_torch.engine import packing
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.models.convert import params_from_numpy
from realhf_tpu_torch.ops.sampling import (
    NEG_INF,
    GenerationHyperparameters,
    sample_from_logits,
    top_k_top_p_logits,
)

CFG = dict(n_layers=2, n_kv_heads=2, n_q_heads=4, hidden_dim=32,
           intermediate_dim=64, vocab_size=64, apply_rotary=True,
           layer_norm_type="rms", mlp_type="llama", use_attention_bias=False,
           use_attn_proj_bias=False, use_mlp_bias=False,
           activation_function="silu", param_dtype="float32",
           compute_dtype="float32")


@pytest.fixture(scope="module")
def models():
    jcfg = JConfig(**CFG)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.device_get(jparams))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, 60, size=int(n)).astype(np.int32)
               for n in (3, 7, 5, 8)]
    return jcfg, jparams, TransformerConfig(**CFG), tparams, prompts


def _run_jax(jcfg, jparams, prompts, gc, eos):
    ids, seg, pos = jpacking.left_padded_prompts(prompts, pad_id=0)
    fn = jgen.build_generate_fn(jcfg, JGen(**gc), eos, 0)
    return jax.device_get(fn(jparams, ids, seg, pos, jax.random.PRNGKey(3)))


def _run_port(tcfg, tparams, prompts, gc, eos):
    ids, seg, pos = packing.left_padded_prompts(prompts, pad_id=0)
    t = torch.from_numpy
    return gen.generate(tcfg, tparams, t(ids), t(seg), t(pos),
                        seeding.generator(3), GenerationHyperparameters(**gc),
                        eos_token_id=eos, pad_token_id=0).to_host()


def test_greedy_tokens_and_logprobs_match_jax(models):
    jcfg, jparams, tcfg, tparams, prompts = models
    gc = dict(max_new_tokens=10, greedy=True)
    ref = _run_jax(jcfg, jparams, prompts, gc, None)
    got = _run_port(tcfg, tparams, prompts, gc, None)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_array_equal(got.lengths, ref.lengths)
    np.testing.assert_allclose(got.logprobs, ref.logprobs, atol=1e-4)
    assert got.logits_mask.all() and ref.logits_mask.all()
    assert got.stats["decode_steps"] == 10


@pytest.mark.parametrize("min_new", [0, 3])
def test_eos_min_new_tokens_and_early_exit_match_jax(models, min_new):
    jcfg, jparams, tcfg, tparams, prompts = models
    probe = _run_port(tcfg, tparams, prompts,
                      dict(max_new_tokens=8, greedy=True), None)
    eos = int(probe.tokens[0, 1])  # a token the model really emits
    gc = dict(max_new_tokens=8, min_new_tokens=min_new, greedy=True)
    ref = _run_jax(jcfg, jparams, prompts, gc, eos)
    got = _run_port(tcfg, tparams, prompts, gc, eos)
    for name in ("tokens", "lengths", "no_eos_mask"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(ref, name), err_msg=name)
    for i, n in enumerate(ref.lengths):
        np.testing.assert_allclose(got.logprobs[i, :n], ref.logprobs[i, :n],
                                   atol=1e-4)
        assert (got.tokens[i, n:] == 0).all()  # pad after EOS
        if min_new:
            assert eos not in got.tokens[i, :min(min_new, n)]
    # the loop stops once every stream has emitted EOS
    want_steps = 8 if ref.no_eos_mask.any() else int(ref.lengths.max())
    assert got.stats["decode_steps"] == want_steps


def test_sampled_logits_mask(models):
    jcfg, jparams, tcfg, tparams, prompts = models
    gc = dict(max_new_tokens=6, greedy=False, top_k=5, temperature=0.7)
    out = _run_port(tcfg, tparams, prompts, gc, None)
    assert out.logits_mask.shape == (4, 6, 64)
    assert (out.logits_mask.sum(-1) <= 5).all()
    assert (out.logits_mask.sum(-1) >= 1).all()
    for i in range(4):
        for s in range(6):
            assert out.logits_mask[i, s, out.tokens[i, s]]
    assert np.isfinite(out.logprobs).all() and (out.logprobs <= 0).all()
    again = _run_port(tcfg, tparams, prompts, gc, None)
    np.testing.assert_array_equal(again.tokens, out.tokens)  # seeded


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.8),
                                         (7, 0.6), (63, 0.95)])
def test_top_k_top_p_matches_jax(top_k, top_p):
    logits = np.random.default_rng(5).standard_normal((3, 64)).astype(
        np.float32) * 3
    ref = np.asarray(jax_top_k_top_p(jnp.asarray(logits), top_k, top_p))
    got = top_k_top_p_logits(torch.from_numpy(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(got > NEG_INF / 2, ref > -1e30 / 2)
    keep = ref > -1e30 / 2
    np.testing.assert_array_equal(got[keep], ref[keep])


def test_sample_from_logits_respects_mask():
    logits = torch.randn((4, 32), generator=torch.Generator().manual_seed(0))
    g = seeding.generator(1)
    tokens, mask = sample_from_logits(
        logits, g, GenerationHyperparameters(top_k=3))
    assert (mask.sum(-1) == 3).all()
    assert mask[torch.arange(4), tokens.long()].all()
    tokens, mask = sample_from_logits(
        logits, g, GenerationHyperparameters(greedy=True))
    assert torch.equal(tokens.long(), logits.argmax(-1)) and mask.all()
