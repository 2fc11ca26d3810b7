"""The radix prefix caches and the prefix fill in the port against the
JAX package: host-KV and pooled caches driven by the same random op
scripts (match / insert / release / evict / clear) give the same
matches, stats, byte accounting and pool refcounts; a prefix-cache fill
(dense: donor KV copied in; paged: donor blocks aliased) decodes what
JAX's does, with the same ``last_fill`` and ``fill_stats`` (the suffix
bucket, the donor trimmed to fit the cache), and what a full prefill of
the same prompt decodes (the JAX package's own tolerances: tokens equal,
log-probs within 1e-4 / 1e-5 or 1e-6). JAX caps its (donor, suffix)
bucket pairs, one compiled program each; the port compiles nothing and
reuses every donor, so ``fill_stats`` are compared where JAX's cap is
not reached and over the port's keys.
"""

import jax
import numpy as np
import pytest

from realhf_tpu.engine import kv_pool as jkvp
from realhf_tpu.serving import prefix_cache as J
from realhf_tpu_torch.engine import kv_pool as tkvp
from realhf_tpu_torch.obs import flight
from realhf_tpu_torch.serving import prefix_cache as P

from test_torch_inflight import assert_same, hyper, jax_gen, port_gen


def _kv(rng, n):
    k = rng.normal(size=(2, 1, n, 3)).astype(np.float32)
    return k, k + 1.0


def _script(seed, n_ops=120):
    """Random cache ops over a small alphabet (so prefixes recur)."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        toks = rng.integers(0, 3, size=int(rng.integers(1, 12)))
        if r < 0.45:
            ops.append(("insert", toks))
        elif r < 0.9:
            ops.append(("match", toks, int(rng.integers(1, 14))))
        elif r < 0.95:
            ops.append(("release_all",))
        else:
            ops.append(("clear",))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_radix_cache_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    jc, tc = J.RadixPrefixCache(400), P.RadixPrefixCache(400)
    handles = []
    for op in _script(seed):
        if op[0] == "insert":
            k, v = _kv(rng, len(op[1]))
            assert tc.insert(op[1], k, v) == jc.insert(op[1], k, v)
        elif op[0] == "match":
            a = jc.match(op[1], max_len=op[2])
            b = tc.match(op[1], max_len=op[2])
            assert a.cached_len == b.cached_len
            if a.cached_len:
                np.testing.assert_array_equal(b.k, a.k)
                np.testing.assert_array_equal(b.v, a.v)
            handles.append((a.handle, b.handle))
        elif op[0] == "release_all":
            for a, b in handles:
                jc.release(a)
                tc.release(b)
            handles = []
        else:
            assert tc.clear() == jc.clear()
        assert tc.snapshot() == jc.snapshot()
        assert tc.bytes_used == jc.bytes_used


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pooled_radix_cache_matches_jax(seed):
    jp, tp = jkvp.KVPool.host_only(40, 4, 8), tkvp.KVPool.host_only(40, 4, 8)
    jc = J.PooledPrefixCache(jp, 16 * jp.block_bytes)
    tc = P.PooledPrefixCache(tp, 16 * tp.block_bytes)
    handles = []
    for op in _script(seed):
        if op[0] == "insert":
            n = tp.blocks_for_rows(len(op[1]))
            if n > jp.n_free:
                freed = (jc.evict_blocks(n - jp.n_free),
                         tc.evict_blocks(n - tp.n_free))
                assert freed[0] == freed[1]
                if n > jp.n_free:
                    continue
            jb, tb = jp.alloc(n), tp.alloc(n)
            assert jb == tb
            assert tc.insert(op[1], blocks=tb) == jc.insert(op[1], blocks=jb)
            jp.free(jb)
            tp.free(tb)
        elif op[0] == "match":
            a = jc.match(op[1], max_len=op[2])
            b = tc.match(op[1], max_len=op[2])
            assert (a.cached_len, a.blocks) == (b.cached_len, b.blocks)
            handles.append((a.handle, b.handle))
        elif op[0] == "release_all":
            for a, b in handles:
                jc.release(a)
                tc.release(b)
            handles = []
        else:
            assert tc.clear() == jc.clear()
        assert tc.snapshot() == jc.snapshot()
        np.testing.assert_array_equal(tp._ref, jp._ref)
        assert tp._free == jp._free


def test_overcommit_gauge_and_one_flight_event():
    """Budget overcommit while a pin blocks eviction shows on the gauge
    and, past 2x the budget, as one flight event per episode."""
    from realhf_tpu_torch.obs import metrics
    metrics.reset_default()
    flight.reset_default()
    cache = P.RadixPrefixCache(capacity_bytes=10_000)
    k = np.zeros((1, 1, 64, 8), np.float32)  # 2 KiB per tensor
    cache.insert(np.arange(64), k, k)        # 4 KiB, within budget
    m = cache.match(np.arange(64), max_len=63)
    cache.capacity_bytes = 1_000
    for _ in range(2):
        cache._evict_to_budget()
    gauge = metrics.default_registry().gauge(
        "serving_prefix_overcommit_bytes")
    assert gauge.value() == cache.bytes_used - 1_000
    evs = [e for e in flight.default_recorder().events()
           if e["kind"] == P.OVERCOMMIT_EVENT]
    assert len(evs) == 1 and cache.stats["overcommit_events"] == 1
    cache.release(m.handle)
    assert cache.bytes_used <= cache.capacity_bytes
    assert gauge.value() == 0 and cache._overcommit_alarmed is False


# ----------------------------------------------------------------------
# prefix fill
# ----------------------------------------------------------------------
def _finish_one(g, prompt, jax_side, **fill_kw):
    g.fill_slot(0, 0, prompt, **fill_kw)
    out = []
    while not out:
        if jax_side:
            g.decode_chunk(jax.random.PRNGKey(0))
        else:
            g.decode_chunk()
        out = g.harvest(export_kv=True)
    return out[0]


def _both(max_prompt_len=64, nm=8, n_slots=1, **kw):
    jg, tg = hyper(max_new_tokens=nm, min_new_tokens=1)
    gk = dict(n_slots=n_slots, max_prompt_len=max_prompt_len,
              eos_token_id=1, pad_token_id=0, chunk_size=4, **kw)
    return jax_gen(jg, **gk), port_gen(tg, **gk)


def same_fill_stats(t, j) -> bool:
    """The port's ``fill_stats`` equal JAX's over the port's keys (JAX
    adds the bucket-pair cap's counters)."""
    return t.fill_stats == {k: j.fill_stats[k] for k in t.fill_stats}


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(2, 120, size=n).astype(
        np.int32)


@pytest.mark.parametrize("donor_len,extra,max_prompt_len", [
    (10, 4, 64),      # a short hit: suffix bucket 16
    (200, 4, 448),    # a 98% hit pays the suffix bucket, not 256
    (300, 4, 448),    # the donor's bucket overflows: trimmed to 256
    (8, 0, 64),       # a 100% hit still prefills one token
])
def test_prefix_fill_matches_jax_and_full_prefill(donor_len, extra,
                                                  max_prompt_len):
    donor = _prompt(donor_len, donor_len)
    new = np.concatenate([donor, _prompt(1, extra)]) if extra else donor
    j, t = _both(max_prompt_len)
    jfs = _finish_one(j, donor, True)
    tfs = _finish_one(t, donor, False)
    assert_same([jfs], [tfs])
    for a, b in zip(jfs.kv, tfs.kv):
        assert a.shape == b.shape == (2, 2, donor_len + len(jfs.tokens), 16)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    c = donor_len
    j2, t2 = _both(max_prompt_len)
    jgot = _finish_one(j2, new, True, cached_len=c,
                       prefix_kv=(jfs.kv[0][:, :, :c], jfs.kv[1][:, :, :c]))
    tgot = _finish_one(t2, new, False, cached_len=c,
                       prefix_kv=(tfs.kv[0][:, :, :c], tfs.kv[1][:, :, :c]))
    assert t2.last_fill == j2.last_fill
    assert same_fill_stats(t2, j2)
    assert t2.last_fill["cached_len"] == min(c, len(new) - 1, 256)
    assert_same([jgot], [tgot])
    for a, b in zip(jgot.kv, tgot.kv):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    _, t3 = _both(max_prompt_len)
    full = _finish_one(t3, new, False)
    np.testing.assert_array_equal(tgot.tokens, full.tokens)
    np.testing.assert_allclose(tgot.logprobs, full.logprobs, rtol=1e-4,
                               atol=1e-5)


def test_bucket_pair_cap_falls_back_to_full_prefill():
    """With JAX's cap of one (donor, suffix) bucket pair, JAX's two fills
    of other pairs fall back to a full prefill. The port has no cap:
    every fill reuses its donor and decodes what JAX's fill decodes
    (tokens equal, log-probs within 1e-4 / 1e-5, the full-prefill
    tolerance of ``test_prefix_fill_matches_jax_and_full_prefill``)."""
    jg, tg = hyper(max_new_tokens=8, min_new_tokens=1)
    gk = dict(n_slots=1, max_prompt_len=128, eos_token_id=1, pad_token_id=0,
              chunk_size=4)
    j, t = jax_gen(jg, bucket_pair_cap=1, **gk), port_gen(tg, **gk)
    donor = _prompt(3, 40)
    jfs, tfs = _finish_one(j, donor, True), _finish_one(t, donor, False)
    for extra, c in ((4, 40), (40, 40), (4, 20)):
        new = np.concatenate([donor, _prompt(extra, extra)])
        jgot, tgot = (_finish_one(
            g, new, side, cached_len=c,
            prefix_kv=(fs.kv[0][:, :, :c], fs.kv[1][:, :, :c]))
            for g, fs, side in ((j, jfs, True), (t, tfs, False)))
        assert t.last_fill["cached_len"] == c
        assert t.last_fill["prefilled"] == len(new) - c
        np.testing.assert_array_equal(tgot.tokens, jgot.tokens)
        np.testing.assert_allclose(tgot.logprobs, jgot.logprobs, rtol=1e-4,
                                   atol=1e-5)
    assert j.fill_stats["bucket_pairs_capped"] == 2
    assert j.fill_stats["prefill_tokens_saved"] == 40
    assert t.fill_stats["prefill_tokens_saved"] == 100


def test_paged_prefix_alias_matches_jax_and_dense():
    """A harvested sequence's whole blocks aliased into the next fill
    (a refcount bump, no KV copy): only the suffix bucket prefills, the
    pool's refcounts follow JAX's, and the sequence decodes what a
    cache-less dense fill decodes (tokens equal, log-probs within
    1e-6)."""
    rng = np.random.default_rng(5)
    common = rng.integers(2, 120, size=16).astype(np.int32)
    p1 = np.concatenate([common, rng.integers(2, 120, size=8).astype(
        np.int32)])
    p2 = np.concatenate([common, rng.integers(2, 120, size=8).astype(
        np.int32)])
    jg, tg = hyper(max_new_tokens=8, min_new_tokens=1)
    kw = dict(n_slots=1, max_prompt_len=24, eos_token_id=1, pad_token_id=0,
              chunk_size=4)
    j = jax_gen(jg, pool=(16, 8, "fp32"), **kw)
    t = port_gen(tg, pool=(16, 8, "fp32"), **kw)
    outs = []
    for g, side in ((j, True), (t, False)):
        g.fill_slot(0, 0, p1)
        for _ in range(3):
            g.decode_chunk(jax.random.PRNGKey(0)) if side \
                else g.decode_chunk()
        fin = g.harvest(export_blocks=True)[0]
        assert fin.blocks and fin.n_rows >= len(p1)
        g.fill_slot(0, 1, p2, cached_len=16, cached_blocks=list(fin.blocks))
        assert g.last_fill["cached_len"] == 16
        assert g.last_fill["bucket"] < 24  # paid the suffix bucket
        assert g.fill_stats["prefill_tokens_saved"] == 16
        for _ in range(3):
            g.decode_chunk(jax.random.PRNGKey(0)) if side \
                else g.decode_chunk()
        outs.append((fin, g.harvest()[0]))
        g.kv_pool.free(fin.blocks)
        assert g.kv_pool.n_free == g.kv_pool.n_blocks
    (jfin, jgot), (tfin, tgot) = outs
    assert (tfin.blocks, tfin.n_rows) == (jfin.blocks, jfin.n_rows)
    assert_same([jgot], [tgot])
    assert t.last_fill == j.last_fill and same_fill_stats(t, j)
    ref = port_gen(tg, **kw).generate_all([p2])[0]
    np.testing.assert_array_equal(tgot.tokens, ref.tokens)
    np.testing.assert_allclose(tgot.logprobs, ref.logprobs, rtol=0,
                               atol=1e-6)


def test_prefix_fill_refusals():
    _, t = _both()
    with pytest.raises(ValueError, match="prefix_kv"):
        t.fill_slot(0, 0, _prompt(0, 8), cached_len=4)
    with pytest.raises(ValueError, match="paged"):
        t.fill_slot(0, 0, _prompt(0, 8), cached_len=4, cached_blocks=[1])
    _, tg = hyper(max_new_tokens=8)
    tp = port_gen(tg, pool=(8, 8, "fp32"), n_slots=1, max_prompt_len=24,
                  eos_token_id=1, pad_token_id=0, chunk_size=4)
    with pytest.raises(ValueError, match="cached_blocks"):
        tp.fill_slot(0, 0, _prompt(0, 20), cached_len=16,
                     prefix_kv=(np.zeros(1), np.zeros(1)))
    with pytest.raises(ValueError, match="cached_blocks"):
        tp.fill_slot(0, 0, _prompt(0, 20), cached_len=16)
