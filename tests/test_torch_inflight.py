"""The port's continuous-batching generator against the JAX package's on
the same weights and prompts (a tiny fp32 model on the CPU): greedy
tokens equal and log-probs within 1e-5 (fp32 on both sides; the same
trajectory differs only by summation order), with EOS, min_new_tokens
and more prompts than slots; dense, paged fp32 and paged int8 KV; the
step-level slot API; the state of an idle slot that steps past the
cache; sampling; and the ``gen`` experiment with inflight batching
through both packages' ``InlineRunner``.

The helpers here (``models``, ``jax_gen``, ``port_gen``, ``assert_same``)
are shared by the other ``test_torch_*`` serving tests.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from realhf_tpu.engine import kv_pool as jkvp
from realhf_tpu.engine.inflight import InflightBatchingGenerator as JGen
from realhf_tpu.models import transformer as JT
from realhf_tpu.models.config import TransformerConfig as JConfig
from realhf_tpu.ops.sampling import GenerationHyperparameters as JHyper
from realhf_tpu_torch.engine import kv_pool as tkvp
from realhf_tpu_torch.engine.inflight import InflightBatchingGenerator as TGen
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.models.convert import params_from_numpy
from realhf_tpu_torch.ops.sampling import GenerationHyperparameters

CFG = dict(n_layers=2, n_kv_heads=2, n_q_heads=4, hidden_dim=64,
           intermediate_dim=128, vocab_size=128, apply_rotary=True,
           layer_norm_type="rms", mlp_type="llama", use_attention_bias=False,
           use_attn_proj_bias=False, use_mlp_bias=False,
           activation_function="silu", param_dtype="float32",
           compute_dtype="float32")
#: log-probs of the same greedy trajectory, port vs JAX (fp32)
LOGP_ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def models(seed: int = 0):
    """(JAX config, JAX params, port config, port params) of one seed."""
    jcfg = JConfig(**CFG)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return (jcfg, jparams, TransformerConfig(**CFG),
            params_from_numpy(jax.device_get(jparams)))


def prompts_of(seed: int, n: int, lo: int = 4, hi: int = 30):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, CFG["vocab_size"], size=int(k)).astype(np.int32)
            for k in rng.integers(lo, hi, size=n)]


def hyper(**kw):
    g = dict(max_new_tokens=10, min_new_tokens=0, greedy=True,
             force_no_logits_mask=True)
    g.update(kw)
    return JHyper(**g), GenerationHyperparameters(**g)


def jax_gen(g, *, pool=None, **kw):
    """A JAX generator; ``pool`` = (n_blocks, block_len, dtype)."""
    jcfg, jparams, _, _ = models()
    if pool is not None:
        kw["kv_pool"] = jkvp.KVPool(jcfg, pool[0], pool[1], dtype=pool[2])
    return JGen(jcfg, jparams, g, **kw)


def port_gen(g, *, pool=None, **kw):
    _, _, tcfg, tparams = models()
    if pool is not None:
        kw["kv_pool"] = tkvp.KVPool(tcfg, pool[0], pool[1], dtype=pool[2],
                                    device="cpu")
    return TGen(tcfg, tparams, g, device="cpu", **kw)


def probe_eos(prompts, slots=3):
    """The token the model emits most often after its third token (so
    EOS ends sequences, also under min_new_tokens 3)."""
    jg, tg = hyper(max_new_tokens=10)
    out = port_gen(tg, n_slots=slots, max_prompt_len=40, eos_token_id=None,
                   pad_token_id=0, chunk_size=4).generate_all(prompts)
    late = np.concatenate([f.tokens[3:] for f in out])
    return int(np.bincount(late).argmax())


def assert_same(ref, got, atol=LOGP_ATOL):
    """Finished sequences equal: ids, tokens, no_eos, spec counts;
    log-probs within ``atol``."""
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        assert a.request_id == b.request_id
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_allclose(b.logprobs, a.logprobs, rtol=0,
                                   atol=atol)
        assert (a.no_eos, a.spec_proposed, a.spec_accepted) == (
            b.no_eos, b.spec_proposed, b.spec_accepted)


GEN_KW = dict(n_slots=3, max_prompt_len=40, pad_token_id=0, chunk_size=4)


@pytest.mark.parametrize("eos_mode,min_new", [("none", 0), ("probe", 0),
                                              ("probe", 3)])
def test_greedy_matches_jax(eos_mode, min_new):
    """7 prompts through 3 slots (refills), tokens equal to JAX's."""
    prompts = prompts_of(1, 7)
    eos = probe_eos(prompts) if eos_mode == "probe" else None
    jg, tg = hyper(min_new_tokens=min_new)
    ref = jax_gen(jg, eos_token_id=eos, **GEN_KW).generate_all(
        prompts, jax.random.PRNGKey(0))
    got = port_gen(tg, eos_token_id=eos, **GEN_KW).generate_all(prompts)
    assert_same(ref, got)
    if eos is not None:
        assert any(not f.no_eos for f in got)  # EOS really ended some
        assert all(eos not in f.tokens[:min_new] for f in got)


@pytest.mark.parametrize("pool", [(24, 8, "fp32"), (24, 8, "int8"),
                                  (12, 16, "bf16")])
def test_paged_matches_jax(pool):
    """Paged pools (fp32, int8, bf16 storage) against JAX's on the same
    traffic; int8 and bf16 round their rows the same way in both."""
    prompts = prompts_of(2, 6)
    eos = probe_eos(prompts)
    jg, tg = hyper(min_new_tokens=1)
    j = jax_gen(jg, pool=pool, eos_token_id=eos, **GEN_KW)
    t = port_gen(tg, pool=pool, eos_token_id=eos, **GEN_KW)
    ref = j.generate_all(prompts, jax.random.PRNGKey(0))
    got = t.generate_all(prompts)
    assert_same(ref, got, atol=LOGP_ATOL if pool[2] == "fp32" else 1e-4)
    assert t.kv_pool.n_free == t.kv_pool.n_blocks
    assert t.kv_pool.stats() == j.kv_pool.stats()


def test_paged_equals_dense():
    """Paged fp32 decodes what the dense path decodes (the JAX package's
    own tolerance: tokens equal, log-probs within 1e-6), including a
    prompt of exactly one bucket and odd lengths."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, 128, size=n).astype(np.int32)
               for n in (24, 10, 17)]
    _, tg = hyper(max_new_tokens=8, min_new_tokens=1)
    kw = dict(n_slots=2, max_prompt_len=24, eos_token_id=1,
              pad_token_id=0, chunk_size=4)
    dense = port_gen(tg, **kw).generate_all(prompts)
    for dt in ("fp32", None):
        got = port_gen(tg, pool=(16, 8, "fp32"), **kw).generate_all(prompts) \
            if dt else port_gen(tg, kv_cache_dtype="fp32", **kw
                                ).generate_all(prompts)
        assert_same(dense, got, atol=1e-6)


def _state_np(state):
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update({f"cache.{a}": np.asarray(b) for a, b in v.items()})
        else:
            out[k] = np.asarray(v)
    return out


def test_idle_slot_steps_past_the_cache():
    """Slot 0 stays idle while slot 1 serves two requests of 100 tokens
    (chunks of 64): every step advances the idle slot's write index too,
    to 200, past cache_len (128), and JAX drops the writes out of range.
    The port drops them as well: the finished sequences and both whole
    states agree (ints and bools exactly, floats within 1e-4)."""
    jg, tg = hyper(max_new_tokens=100)
    kw = dict(n_slots=2, max_prompt_len=28, eos_token_id=None,
              pad_token_id=0, chunk_size=64)
    j, t = jax_gen(jg, **kw), port_gen(tg, **kw)
    assert j.cache_len == t.cache_len == 128
    for rid, p in enumerate(prompts_of(3, 2, 10, 20)):
        j.fill_slot(1, rid, p)
        t.fill_slot(1, rid, p)
        for _ in range(2):
            j.decode_chunk(jax.random.PRNGKey(0))
            t.decode_chunk()
        assert_same(j.harvest(), t.harvest())
    js, ts = _state_np(jax.device_get(j.state)), _state_np(t.state)
    assert int(js["cache.length"][0]) == 200 > j.cache_len
    assert sorted(ts) == sorted(js)
    for k in ts:
        if js[k].dtype.kind in "bi":
            np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
        else:
            np.testing.assert_allclose(ts[k], js[k], rtol=0, atol=1e-4,
                                       err_msg=k)


def test_step_level_slot_api_matches_jax():
    """fill / decode_chunk / snapshot / harvest / release, step by
    step, with the same observable results as JAX's."""
    jg, tg = hyper(max_new_tokens=12)
    kw = dict(n_slots=2, max_prompt_len=40, eos_token_id=None,
              pad_token_id=0, chunk_size=5)
    j, t = jax_gen(jg, **kw), port_gen(tg, **kw)
    p0, p1, p2 = prompts_of(4, 3)
    for g in (j, t):
        assert g.free_slots() == [0, 1] and g.n_live == 0
        g.fill_slot(0, 10, p0)
        g.fill_slot(1, 11, p1)
        assert g.free_slots() == [] and g.n_live == 2
        assert g.max_prompt_len == g.cache_len - 12
    j.decode_chunk(jax.random.PRNGKey(0))
    t.decode_chunk()
    js, ts = j.snapshot_slots([0, 1]), t.snapshot_slots([0, 1])
    for s in (0, 1):
        np.testing.assert_array_equal(ts[s][0], js[s][0])
        np.testing.assert_allclose(ts[s][1], js[s][1], atol=LOGP_ATOL)
        assert len(ts[s][0]) == 5
    assert t.harvest() == [] and j.harvest() == []
    for g in (j, t):
        g.release_slot(1)  # cancel: slot free at once
        assert g.free_slots() == [1]
        g.fill_slot(1, 12, p2)
    for _ in range(3):
        j.decode_chunk(jax.random.PRNGKey(0))
        t.decode_chunk()
    assert_same(j.harvest(), t.harvest())
    assert t.n_live == 0 and t.harvest() == []


def test_sampled_mode_runs_and_is_seeded():
    _, tg = hyper(max_new_tokens=6, min_new_tokens=1, greedy=False,
                  top_k=20, temperature=1.0)
    prompts = prompts_of(5, 5)

    def run():
        gen = torch.Generator().manual_seed(3)
        return port_gen(tg, n_slots=2, max_prompt_len=40, eos_token_id=1,
                        pad_token_id=0, chunk_size=3
                        ).generate_all(prompts, gen)

    a, b = run(), run()
    assert len(a) == 5
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.tokens, y.tokens)
        assert 1 <= len(x.tokens) <= 6
        assert np.isfinite(x.logprobs).all() and (x.logprobs <= 0).all()


def test_refusals():
    _, tg = hyper()
    g = GenerationHyperparameters(max_new_tokens=4)  # logits mask on
    with pytest.raises(ValueError, match="logits"):
        port_gen(g, **GEN_KW, eos_token_id=None)
    with pytest.raises(ValueError, match="int8"):
        port_gen(tg, **GEN_KW, eos_token_id=None, kv_cache_dtype="int8")
    t = port_gen(tg, **GEN_KW, eos_token_id=None)
    with pytest.raises(ValueError, match="max_prompt_len"):
        t.fill_slot(0, 0, np.arange(2, 2 + t.max_prompt_len + 1))
    with pytest.raises(ValueError, match="prefix_kv"):
        t.fill_slot(0, 0, np.arange(2, 12), cached_len=4)
    _, _, tcfg, tparams = models()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TGen(tcfg, tparams, tg, **GEN_KW, eos_token_id=None)


# ----------------------------------------------------------------------
# the gen experiment with inflight batching, both packages end to end
# ----------------------------------------------------------------------
def test_gen_experiment_inflight_matches_jax(tmp_path):
    """``gen`` with use_inflight_batching and 2 slots through each
    package's ``GenerationConfig.build()`` + ``InlineRunner`` (the tiny
    model and prompts of ``test_torch_gen_e2e``; 4 prompts a batch, two
    batches): the port, from JAX's weights, generates what JAX does,
    and drops its reference to the weights after each call."""
    from test_torch_gen_e2e import (
        GenerationConfig,
        IntegerTokenizer,
        InlineRunner,
        JaxGenConfig,
        JaxRunner,
        JaxTokenizer,
        _generated,
        _prompts,
        _spec,
        apply_overrides,
        jax_overrides,
    )
    path = str(tmp_path / "prompts.jsonl")
    _prompts(path)
    jspec = _spec(JaxGenConfig, jax_overrides, JaxTokenizer(vocab_size=1000),
                  path)
    tspec = _spec(GenerationConfig, apply_overrides,
                  IntegerTokenizer(vocab_size=1000), path)
    for spec in (jspec, tspec):
        spec.mfcs[0].interface_impl.args.update(use_inflight_batching=True,
                                               inflight_slots=2)
    jax_runner = JaxRunner(jspec)
    runner = InlineRunner(tspec, device="cpu")
    weights = jax_runner.models["default"].engine.params_numpy()
    runner.models["default"].engine.set_params(params_from_numpy(weights))
    want = _generated(jax_runner)
    got = _generated(runner)
    assert sorted(got) == sorted(want) == list(range(8))
    for i in want:
        assert got[i] == want[i], (i, got[i], want[i])
    itf = runner.interfaces["gen"]
    assert itf._inflight is not None and itf._inflight.n_slots == 2
    assert itf._inflight.params is None


def test_inflight_decode_goes_through_decode_step(monkeypatch):
    """Every decode step of a chunk is one ``transformer.decode_step``
    call over all slots with per-slot write indices (the K4 path on the
    card), and every fill one ``transformer.prefill`` (K1)."""
    calls = dict(decode=0, prefill=0)
    real_decode, real_prefill = T.decode_step, T.prefill

    def decode(*a, **kw):
        assert not kw.get("uniform_slot", False)
        calls["decode"] += 1
        return real_decode(*a, **kw)

    def prefill(*a, **kw):
        calls["prefill"] += 1
        return real_prefill(*a, **kw)

    monkeypatch.setattr(T, "decode_step", decode)
    monkeypatch.setattr(T, "prefill", prefill)
    _, tg = hyper(max_new_tokens=7)
    t = port_gen(tg, n_slots=2, max_prompt_len=40, eos_token_id=None,
                 pad_token_id=0, chunk_size=4)
    t.generate_all(prompts_of(6, 3))
    # slots 0/1 take 7 steps (chunks of 4 + 3), slot 0 refills, 7 more
    assert calls == dict(decode=14, prefill=3)
    assert t.counts == dict(decode_steps=14, full_prefills=3,
                            suffix_prefills=0)
