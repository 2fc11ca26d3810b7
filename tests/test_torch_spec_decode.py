"""Prompt-lookup speculative decoding in the port against the JAX
package: the n-gram drafter proposes what JAX's proposes on random and
looping histories; greedy speculative decoding emits what plain greedy
decoding emits (tokens equal, log-probs within the JAX package's own
rtol 1e-5 / atol 1e-6), dense and paged; and the verify rounds' draft
accounting (``spec_proposed`` / ``spec_accepted``) equals JAX's.
"""

import jax
import numpy as np
import pytest

from realhf_tpu.engine.drafter import NGramDrafter as JDrafter
from realhf_tpu_torch.engine.drafter import NGramDrafter

from test_torch_inflight import (
    assert_same,
    hyper,
    jax_gen,
    port_gen,
    probe_eos,
    prompts_of,
)


@pytest.mark.parametrize("k,max_ng,min_ng,fb", [(3, 3, 1, None),
                                                (4, 2, 2, 7), (1, 4, 1, 0)])
def test_drafter_matches_jax(k, max_ng, min_ng, fb):
    rng = np.random.default_rng(k)
    d = NGramDrafter(k, max_ngram=max_ng, min_ngram=min_ng,
                     fallback_token=fb)
    jd = JDrafter(k, max_ngram=max_ng, min_ngram=min_ng, fallback_token=fb)
    hists = [np.zeros(0, np.int64), np.array([5]), np.tile([3, 4, 5], 4),
             np.array([9, 1, 2, 9, 1])]
    hists += [rng.integers(0, 6, size=int(n)) for n in rng.integers(1, 40, 30)]
    for h in hists:
        got, want = d.propose(h), jd.propose(h)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    for bad in (dict(k=0), dict(k=2, min_ngram=3, max_ngram=2)):
        with pytest.raises(ValueError):
            NGramDrafter(**bad)


def _spec_kw(eos, n_slots=2, max_prompt_len=64, chunk=4):
    return dict(n_slots=n_slots, max_prompt_len=max_prompt_len,
                eos_token_id=eos, pad_token_id=0, chunk_size=chunk)


@pytest.mark.parametrize("spec_k,eos_mode,pool", [
    (1, "none", None), (3, "probe", None),
    (3, "none", (24, 8, "fp32")), (1, "probe", (24, 8, "fp32"))])
def test_spec_equals_plain_greedy_and_jax(spec_k, eos_mode, pool):
    prompts = prompts_of(7, 5, 5, 14)
    eos = probe_eos(prompts) if eos_mode == "probe" else None
    jg, tg = hyper(max_new_tokens=8, min_new_tokens=1)
    plain = port_gen(tg, **_spec_kw(eos)).generate_all(prompts)
    t = port_gen(tg, pool=pool, spec_decode_k=spec_k, **_spec_kw(eos))
    spec = t.generate_all(prompts)
    assert t.spec_stats["rounds"] > 0
    for a, b in zip(plain, spec):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_allclose(b.logprobs, a.logprobs, rtol=1e-5,
                                   atol=1e-6)
        assert a.no_eos == b.no_eos
        assert b.spec_proposed > 0
        assert 0 <= b.spec_accepted <= b.spec_proposed
    j = jax_gen(jg, pool=pool, spec_decode_k=spec_k, **_spec_kw(eos))
    ref = j.generate_all(prompts, jax.random.PRNGKey(0))
    assert_same(ref, spec)  # spec_proposed / spec_accepted included
    assert t.spec_stats == j.spec_stats
    if pool is not None:
        assert t.kv_pool.n_free == t.kv_pool.n_blocks


def test_spec_accepts_on_repetitive_prompt():
    """A looping prompt is the drafter's best case: drafts are accepted,
    as many as JAX accepts, and the stream equals plain greedy."""
    p = np.tile(np.array([11, 12, 13], np.int32), 6)
    jg, tg = hyper(max_new_tokens=12, min_new_tokens=1)
    kw = _spec_kw(None, n_slots=1)
    got = port_gen(tg, spec_decode_k=3, **kw).generate_all([p])[0]
    ref = port_gen(tg, **kw).generate_all([p])[0]
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    want = jax_gen(jg, spec_decode_k=3, **kw).generate_all(
        [p], jax.random.PRNGKey(0))[0]
    assert (got.spec_proposed, got.spec_accepted) == (
        want.spec_proposed, want.spec_accepted)
    assert got.spec_accepted > 0


def test_spec_disabled_for_sampling():
    _, tg = hyper(max_new_tokens=8, min_new_tokens=1, greedy=False,
                  top_k=20, temperature=1.0)
    g = port_gen(tg, spec_decode_k=3, **_spec_kw(1))
    assert g._spec_k == 0  # greedy-exact only: sampling falls back
    out = g.generate_all(prompts_of(1, 3, 5, 14))
    assert all(len(fs.tokens) > 0 for fs in out)
