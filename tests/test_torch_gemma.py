"""A tiny Gemma (2 layers, 4 q / 1 kv heads of 256: (1 + w) RMSNorm,
embeddings times sqrt(hidden), tied head, gelu tanh, a head dim four
times hidden / nq) in the port against the JAX package on the same
weights and inputs: the ``gen`` and ``sft`` experiments through each
package's ``InlineRunner`` (greedy tokens equal; each step's loss and
grad norm), one SFT loss's gradients leaf by leaf, and a Gemma
checkpoint the JAX package wrote built into a port model with equal
greedy tokens, and the inflight generator (dense and paged KV) against
the JAX package's. Then the head-dim checks of the CUDA wrappers on tensors
that say they are on the card: K1-K4 take hd 256 and refuse 96 and 512,
and the ring (K6) takes 256 and refuses 96.

Tolerances: fp32 on the CPU on both sides, sums in different orders;
the experiment helpers' (``test_torch_rw_dpo.py``), gradients 1e-4 of
each leaf's largest element, greedy tokens equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from realhf_tpu.engine import generation as jgen
from realhf_tpu.engine import kv_pool as jkvp
from realhf_tpu.engine.inflight import InflightBatchingGenerator as JInflight
from realhf_tpu.engine import packing as jpacking
from realhf_tpu.experiments.gen_exp import GenerationConfig as JGenConfig
from realhf_tpu.experiments.sft_exp import SFTConfig as JSFTConfig
from realhf_tpu.interfaces import sft as jsft
from realhf_tpu.models import hf as jhf
from realhf_tpu.models import transformer as JT
from realhf_tpu.models.config import TransformerConfig as JConfig
from realhf_tpu.ops.sampling import GenerationHyperparameters as JHyper
from realhf_tpu_torch.api.experiment import ModelSpec
from realhf_tpu_torch.base import seeding
from realhf_tpu_torch.engine import kv_pool as tkvp
from realhf_tpu_torch.engine import packing
from realhf_tpu_torch.engine.inflight import InflightBatchingGenerator
from realhf_tpu_torch.experiments.gen_exp import GenerationConfig
from realhf_tpu_torch.experiments.sft_exp import SFTConfig
from realhf_tpu_torch.interfaces import sft
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.models.convert import params_from_numpy
from realhf_tpu_torch.ops import decode_attention as da
from realhf_tpu_torch.ops import flash_attention as fa
from realhf_tpu_torch.ops import ring_attention_fused as rf
from realhf_tpu_torch.ops.sampling import GenerationHyperparameters
from realhf_tpu_torch.system.model_host import build_model
from test_torch_gen_e2e import _generated
from test_torch_inflight import assert_same
from test_torch_rw_dpo import (
    _port_root,  # noqa: F401 - the runners save under a fresh root
    assert_same_steps,
    experiment_runners,
    run_steps,
    write_prompts,
)

GEMMA = dict(n_layers=2, n_kv_heads=1, n_q_heads=4, head_dim=256,
             hidden_dim=64, intermediate_dim=96, vocab_size=110,
             n_positions=256, layer_norm_epsilon=1e-6, apply_rotary=True,
             layer_norm_type="gemma", mlp_type="llama",
             use_attention_bias=False, use_attn_proj_bias=False,
             use_mlp_bias=False, activation_function="gelu_new",
             normalize_embed=True, tied_embedding=True)


def _configs():
    """The tiny Gemma's config in fp32: (JAX package's, port's)."""
    kw = dict(GEMMA, param_dtype="float32", compute_dtype="float32")
    return JConfig(**kw), TransformerConfig(**kw)


def _words_file(path, n=8, seed=4):
    """Prompt-answer records (each answer starts with a space: the
    integer tokenizer splits on whitespace)."""
    rng = np.random.default_rng(seed)

    def words():
        return " ".join(f"w{int(w)}" for w in
                        rng.integers(0, 50, size=int(rng.integers(3, 12))))

    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps(dict(id=i, prompt=words(),
                                    answer=" " + words())) + "\n")


def test_gen_experiment_matches_jax(tmp_path):
    path = str(tmp_path / "prompts.jsonl")
    write_prompts(path, n=8)
    jr, runner = experiment_runners(
        JGenConfig, GenerationConfig,
        {"dataset.path": path, "dataset.train_bs_n_seqs": "4",
         "dataset.max_seqlen": "16", "max_new_tokens": "7",
         "greedy": "true"}, tiny=GEMMA)
    want, got = _generated(jr), _generated(runner)
    assert sorted(got) == sorted(want) == list(range(8))
    for i in want:
        assert got[i] == want[i], (i, got[i], want[i])


def test_sft_experiment_matches_jax(tmp_path):
    path = str(tmp_path / "sft.jsonl")
    _words_file(path)
    jr, runner = experiment_runners(
        JSFTConfig, SFTConfig,
        {"dataset.path": path, "dataset.train_bs_n_seqs": "4",
         "dataset.max_seqlen": "32", "n_mbs": "2",
         "model.optimizer.lr": "1e-3"}, tiny=GEMMA)
    assert_same_steps(run_steps(runner), run_steps(jr))


def test_sft_loss_gradients_match_jax():
    """One SFT loss over each of two microbatches: the loss and the
    gradient of every leaf (``jax.grad`` against autograd), the tied
    embedding's taking both the lookup's and the head's share."""
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(8)
    host = jax.device_get(JT.init_params(jcfg, jax.random.PRNGKey(2)))
    host = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape).astype(np.float32), host)
    mbs, _ = chip_smoke.sft_microbatches(np.random.default_rng(9),
                                         GEMMA["vocab_size"])
    jgrad = jax.jit(jax.value_and_grad(jsft._make_loss_fn(jcfg),
                                       has_aux=True))
    tloss = sft._make_loss_fn(tcfg)
    for mb in mbs:
        (jl, _), jg = jgrad(jax.tree.map(jnp.asarray, host),
                            {k: jnp.asarray(v) for k, v in mb.items()})
        p = params_from_numpy(host)
        leaves = jax.tree.leaves(p)
        for x in leaves:
            x.requires_grad_(True)
        tl, _ = tloss(p, {k: torch.from_numpy(v) for k, v in mb.items()})
        tl.backward()
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
        for (path, w), x in zip(jax.tree_util.tree_leaves_with_path(jg),
                                leaves):
            w = np.asarray(w)
            np.testing.assert_allclose(x.grad.numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=str(path))


def test_jax_checkpoint_builds_in_port(tmp_path):
    """A Gemma checkpoint the JAX package wrote (HF layout, head_dim 256
    written out) builds a port model of the same config whose greedy
    tokens equal the JAX model's."""
    jcfg, _ = _configs()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(5))
    jhf.save_hf_checkpoint(str(tmp_path / "jax"), "gemma", jcfg, jp)
    model = build_model("actor", ModelSpec(path=str(tmp_path / "jax"),
                                           hf_family="gemma", bf16=False),
                        None, init_seed=1, device="cpu")
    eng = model.engine
    assert (eng.cfg.head_dim, eng.cfg.layer_norm_type, eng.cfg.tied_embedding,
            eng.cfg.normalize_embed) == (256, "gemma", True, True)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(2, 110, size=n).astype(np.int32)
               for n in (9, 4, 13)]
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


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_inflight_generator_matches_jax(paged):
    """5 prompts through 2 slots (refills), chunk 4: the serving engine's
    decode step and, paged, the KV pool's pages sized by head_dim (256,
    not hidden / nq)."""
    jcfg, tcfg = _configs()
    host = jax.device_get(JT.init_params(jcfg, jax.random.PRNGKey(7)))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, 110, size=n).astype(np.int32)
               for n in (9, 21, 5, 16, 12)]
    kw = dict(n_slots=2, max_prompt_len=32, pad_token_id=0, chunk_size=4,
              eos_token_id=None)
    g = dict(max_new_tokens=6, greedy=True, force_no_logits_mask=True)
    jkw, tkw = dict(kw), dict(kw)
    if paged:
        jkw["kv_pool"] = jkvp.KVPool(jcfg, 48, 8, dtype="fp32")
        tkw["kv_pool"] = tkvp.KVPool(tcfg, 48, 8, dtype="fp32",
                                     device="cpu")
    ref = JInflight(jcfg, jax.tree.map(jnp.asarray, host), JHyper(**g),
                    **jkw).generate_all(prompts, jax.random.PRNGKey(0))
    got = InflightBatchingGenerator(
        tcfg, params_from_numpy(host), GenerationHyperparameters(**g),
        device="cpu", **tkw).generate_all(prompts)
    assert_same(ref, got, atol=1e-4)


# ----------------------------------------------------------------------
# the wrappers' head-dim checks on tensors that say they are on the card
# ----------------------------------------------------------------------
class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: drives the CUDA
    wrappers' checks without a device."""

    @property
    def is_cuda(self):
        return True


def _card(*arrs, dtype=torch.bfloat16):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
            .as_subclass(_OnCard) for a in arrs]


@pytest.mark.parametrize("hd", [96, 256, 512])
def test_flash_wrappers_take_hd_256_only_beside_64_and_128(hd, monkeypatch):
    launched = []
    monkeypatch.setattr(fa, "_launch", lambda name, ptrs, q, *a: launched
                        .append((name, q.shape[-1])))
    rng = np.random.default_rng(hd)
    q, do = (rng.standard_normal((1, 64, 4, hd)) for _ in range(2))
    k, v = (rng.standard_normal((1, 64, 1, hd)) for _ in range(2))
    q, k, v, do = _card(q, k, v, do)
    seg = _card(np.ones((1, 64)), dtype=torch.int32)[0]
    lse, delta = _card(np.zeros((1, 4, 64)), np.zeros((1, 4, 64)),
                       dtype=torch.float32)
    calls = (lambda: fa.flash_attention(q, k, v, seg),
             lambda: fa.flash_bwd_dq(q, k, v, seg, do, lse, delta),
             lambda: fa.flash_bwd_dkv(q, k, v, seg, do, lse, delta))
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    if hd != 256:
        for call in calls:
            with pytest.raises(ValueError, match="hd 64, 128 or 256"):
                call()
        assert not launched
        assert (fa.launches, fa.dq_launches, fa.dkv_launches) == before
        return
    for call in calls:
        call()
    assert launched == [("flash_fwd_bf16", 256), ("flash_bwd_dq_bf16", 256),
                        ("flash_bwd_dkv_bf16", 256)]
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == tuple(
        n + 1 for n in before)


@pytest.mark.parametrize("hd", [96, 256, 512])
def test_decode_wrapper_takes_hd_256_only_beside_64_and_128(hd, monkeypatch):
    calls = []

    def kernel(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(da, "_kernel", lambda: kernel)
    monkeypatch.setattr(da, "_stream", lambda dev: 0)
    rng = np.random.default_rng(hd)
    q = rng.standard_normal((2, 8, hd))
    k, v = (rng.standard_normal((2, 1, 64, hd)) for _ in range(2))
    q, k, v = _card(q, k, v)
    valid = _card(np.ones((2, 64)), dtype=torch.bool)[0]
    before = da.launches
    if hd != 256:
        with pytest.raises(ValueError, match="hd 64, 128 or 256"):
            da.flash_decode_attention(q, k, v, valid)
        assert not calls and da.launches == before
        return
    da.flash_decode_attention(q, k, v, valid)
    assert da.launches == before + 1 and len(calls) == 1
    b, nq, nkv, s, got_hd = calls[0][9:14]
    assert (b, nq, nkv, s, got_hd) == (2, 8, 1, 64, 256)


def test_ring_refuses_hd_256_naming_its_roadmap_item(monkeypatch):
    """K6 and the ring's K2/K3 rounds take hd 256 now (the ROADMAP item
    that owed it is done): an hd 256 ring reaches the CUDA schedule, and
    a head dim no kernel is built for (96) is still refused."""
    launched = []
    monkeypatch.setattr(rf, "_run_ring", lambda *a, **kw: launched.append(a)
                        or [a[0][0]] * len(a[0]))

    def members(hd):
        rng = np.random.default_rng(3)
        out = []
        for _ in range(2):
            q = rng.standard_normal((1, 64, 4, hd))
            k, v = (rng.standard_normal((1, 64, 1, hd)) for _ in range(2))
            out.append((*_card(q, k, v),
                        _card(np.ones((1, 64)), dtype=torch.int32)[0]))
        return (list(t) for t in zip(*out))

    with torch.no_grad():
        rf.ring_attention_fused(*members(256))
    assert len(launched) == 1
    with torch.no_grad(), pytest.raises(ValueError, match="64, 128 or 256"):
        rf.ring_attention_fused(*members(96))
    assert len(launched) == 1
