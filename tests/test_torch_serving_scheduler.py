"""The port's serving layer against the JAX package's: the continuous
scheduler's event stream over ``FakeSlotBackend`` for one traffic script
(submit, cancel queued and active, deadlines, a weight push with a
staleness bound, drain), dense, with the host prefix cache, and paged
with the pooled cache (block backpressure, decode OOM relief); the
admission queue's verdicts; ``WeightSync``; the protocol constants;
``ServeConfig``; ``build_server``'s composition of a ``ServingSpec``;
and the scheduler over both packages' real generators (paged pool,
pooled prefix cache, a weight swap mid-run; the port's composed by
``build_server``), whose events agree (tokens equal, log-probs within
1e-5).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from realhf_tpu.base import testing as jtesting
from realhf_tpu.engine import kv_pool as jkvp
from realhf_tpu.serving import prefix_cache as jpc
from realhf_tpu.serving import protocol as jproto
from realhf_tpu.serving import request_queue as jrq
from realhf_tpu.serving import scheduler as jsched
from realhf_tpu.serving import weight_sync as jws
from realhf_tpu_torch.base import testing as ttesting
from realhf_tpu_torch.engine import kv_pool as tkvp
from realhf_tpu_torch.obs import metrics
from realhf_tpu_torch.serving import prefix_cache as tpc
from realhf_tpu_torch.serving import protocol as tproto
from realhf_tpu_torch.serving import request_queue as trq
from realhf_tpu_torch.serving import scheduler as tsched
from realhf_tpu_torch.serving import weight_sync as tws

from test_torch_inflight import LOGP_ATOL, hyper, jax_gen, port_gen

J = dict(testing=jtesting, kvp=jkvp, pc=jpc, rq=jrq, sched=jsched, ws=jws)
P = dict(testing=ttesting, kvp=tkvp, pc=tpc, rq=trq, sched=tsched, ws=tws)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _norm(x):
    """Events and results -> plain comparable values."""
    if dataclasses.is_dataclass(x):
        return {f.name: _norm(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (np.ndarray, list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def _serve(m, variant):
    """One fixed traffic script through package ``m``'s scheduler over
    its ``FakeSlotBackend``: the normalized events of every step, the
    scheduler's and the queue's stats."""
    clock = Clock()
    rq = m["rq"]
    pool = cache = None
    kw = {}
    if variant == "paged":
        pool = m["kvp"].KVPool.host_only(10, 4, bytes_per_row=8)
        kw["kv_pool"] = pool
        cache = m["pc"].PooledPrefixCache(pool, 4 * pool.block_bytes)
    elif variant == "prefix":
        kw["prefix_capable"] = True
        cache = m["pc"].RadixPrefixCache(400)
    backend = m["testing"].FakeSlotBackend(n_slots=3, chunk=4,
                                           max_prompt_len=24, **kw)
    q = rq.RequestQueue(max_depth=6, n_slots=3, max_prompt_len=24,
                        clock=clock)
    ws = m["ws"].WeightSync()
    sched = m["sched"].ContinuousScheduler(backend, q, ws, max_staleness=1,
                                           prefix_cache=cache, clock=clock)
    verdicts, steps = [], []

    def submit(rid, need, plen=6, prio=rq.Priority.BATCH, ttl=None,
               min_v=0, fill=3):
        p = np.full(plen, fill, np.int64)
        p[0] = need
        v = q.submit(rq.GenRequest(
            rid=rid, prompt=p, priority=prio,
            deadline=None if ttl is None else clock.t + ttl,
            min_weight_version=min_v), current_weight_version=ws.version)
        verdicts.append((rid, _norm(v)))

    def step(n=1):
        for _ in range(n):
            clock.t += 1.0
            steps.append(_norm(sched.step(None)))

    for i in range(4):
        submit(f"a{i}", need=6 + 3 * i, fill=3 + (i % 2))
    submit("int", need=3, prio=rq.Priority.INTERACTIVE)
    submit("late", need=5, ttl=0.5)           # expires while queued
    submit("big", need=4, plen=30)             # too long
    submit("ahead", need=4, min_v=3)           # weights behind
    step(2)
    q.cancel("a3")                              # a queued cancel
    sched.cancel("a2")                          # an active cancel
    submit("slow", need=40, ttl=3.5)            # expires while decoding
    submit("long", need=30)                     # goes stale
    for i in range(4):
        submit(f"b{i}", need=5, fill=3)         # one shared prompt
    step(2)
    ws.push({"w": np.ones(2)} if m is J else {"w": torch.ones(2)}, 1)
    step()
    ws.push({"w": np.zeros(2)} if m is J else {"w": torch.zeros(2)}, 2)
    step()
    for i in range(3):
        submit(f"c{i}", need=6, fill=4)
    step(3)
    submit("d0", need=6, fill=4)                # c's prompt: a cache hit
    step()
    bounced = [r.rid for r in q.start_drain() + sched.take_parked()]
    submit("after_drain", need=3)
    for _ in range(30):
        step()
        if sched.idle():
            break
    return dict(verdicts=verdicts, steps=steps, bounced=bounced,
                stats=sched.stats, queue=q.stats,
                expired=[r.rid for r in q.take_expired()],
                version=ws.version, swaps=ws.swaps_installed,
                pool=None if pool is None else pool.stats(),
                cache=None if cache is None else cache.snapshot())


@pytest.mark.parametrize("variant", ["dense", "prefix", "paged"])
def test_scheduler_script_matches_jax(variant):
    metrics.reset_default()
    want, got = _serve(J, variant), _serve(P, variant)
    for key in want:
        assert got[key] == want[key], key
    # every admitted request ended in exactly one terminal event
    kinds = {}
    for step in got["steps"]:
        for ev in step:
            kinds.setdefault(ev["rid"], []).append(ev["kind"])
    for rid, ks in kinds.items():
        assert sum(k in tproto.TERMINAL_KINDS for k in ks) <= 1, (rid, ks)
    st = got["stats"]
    assert st["cancelled"] == 1 and got["queue"]["cancelled"] == 1
    assert got["expired"] == ["late"] and "after_drain" not in kinds
    if variant == "dense":
        assert kinds["long"][-1] == tproto.STALE
        assert kinds["slow"][-1] == tproto.EXPIRED
    if variant == "prefix":
        assert st["prefix_hits"] > 0
    if variant == "paged":
        assert st["kv_parked"] + st["kv_oom_evictions"] > 0


def test_request_queue_matches_jax():
    def run(rq):
        clock = Clock()
        q = rq.RequestQueue(max_depth=3, n_slots=2, max_prompt_len=8,
                            clock=clock)
        out = []
        for rid, prio, plen, ttl, min_v in (
                ("a", rq.Priority.ROLLOUT, 4, None, 0),
                ("b", rq.Priority.BATCH, 4, 2.0, 0),
                ("c", rq.Priority.INTERACTIVE, 4, None, 0),
                ("d", rq.Priority.BATCH, 9, None, 0),
                ("e", rq.Priority.BATCH, 4, None, 2),
                ("f", rq.Priority.BATCH, 4, -1.0, 0),
                ("g", rq.Priority.BATCH, 4, None, 0)):
            out.append(_norm(q.submit(rq.GenRequest(
                rid, np.arange(plen), prio,
                None if ttl is None else clock.t + ttl,
                min_weight_version=min_v), current_weight_version=1)))
        out.append(q.depth_by_class())
        clock.t = 5.0
        q.note_service_time(0.5)
        out.append([getattr(q.pop(), "rid", None) for _ in range(2)])
        out.append([r.rid for r in q.take_expired()])
        out.append(q.cancel("a"))
        out.append([r.rid for r in q.start_drain()])
        out.append(_norm(q.submit(rq.GenRequest("h", np.arange(2)))))
        out.append((len(q), bool(q), q.draining, q.stats))
        return out

    assert run(trq) == run(jrq)


def test_weight_sync_push_poll_and_snapshot():
    ws = tws.WeightSync()
    tree = {"a": torch.ones(3), "b": {"c": torch.zeros(2)}, "n": 3}
    ws.push(tree, 1)
    tree["a"].add_(5)  # the caller updates its tree in place
    ws.push(tree, 2)   # overwrites the pending version 1
    with pytest.raises(ValueError, match="monotonic"):
        ws.push(tree, 2)
    tree["b"]["c"].fill_(7)
    got = []
    assert ws.pending_version == 2
    assert ws.poll(got.append) == 2 and ws.poll(got.append) is None
    assert ws.version == 2 and ws.swaps_installed == 1
    assert torch.equal(got[0]["a"], torch.full((3,), 6.0))
    assert torch.equal(got[0]["b"]["c"], torch.zeros(2))
    assert got[0]["n"] == 3
    shared = {"a": torch.ones(1)}
    ws.push(shared, 3, copy=False)
    ws.poll(got.append)
    assert got[-1]["a"] is shared["a"]


def test_protocol_declarations_match_jax():
    """Each kind and reason the port declares (those its scheduler, queue
    and clients emit or read) has JAX's value."""
    names = [n for n in dir(tproto) if n.isupper()]
    assert {"TERMINAL_KINDS", "STARTED", "TOKENS", "REASON_KV_OOM",
            "REASON_FILL_FAILED", "REASON_BACKPRESSURE"} <= set(names)
    for name in names:
        assert _norm(getattr(tproto, name)) == _norm(getattr(jproto, name)), \
            name


def test_serve_config_builds_the_serving_spec():
    """The port's spec holds the engine's fields, each equal to JAX's
    where both set it; launching the service raises."""
    from realhf_tpu.experiments.serve_exp import ServeConfig as JServe
    from realhf_tpu_torch.api.experiment import ServingSpec
    from realhf_tpu_torch.apps import quickstart
    from realhf_tpu_torch.experiments import ALL_EXPERIMENT_CLASSES
    from realhf_tpu_torch.experiments.serve_exp import ServeConfig

    assert ALL_EXPERIMENT_CLASSES["serve"] is ServeConfig
    kw = dict(n_slots=8, chunk_size=8, max_staleness=1, greedy=True,
              max_new_tokens=128)
    spec = ServeConfig(**kw, paged_kv=True, kv_cache_dtype="bf16",
                       spec_decode_k=4, prefix_cache_bytes=0).build()
    jspec = JServe(**kw).build()
    sv, jsv = spec.serving, jspec.serving
    own = ("paged_kv", "kv_cache_dtype", "spec_decode_k",
           "prefix_cache_bytes")
    for f in dataclasses.fields(sv):
        if f.name not in own:
            assert getattr(sv, f.name) == getattr(jsv, f.name), f.name
    assert (sv.paged_kv, sv.kv_cache_dtype, sv.spec_decode_k,
            sv.prefix_cache_bytes) == (True, "bf16", 4, 0)
    # the defaults of the engine's fields are JAX's
    jdefault = type(jsv)()
    for f in dataclasses.fields(ServingSpec()):
        assert getattr(ServingSpec(), f.name) == getattr(jdefault, f.name), \
            f.name
    assert spec.mfcs == [] and spec.dataset is None
    with pytest.raises(NotImplementedError, match="item 5"):
        quickstart.main(["serve", "model.random_init_size=tiny",
                         "device=cpu"])


@pytest.mark.parametrize("case", ["dense", "dense_bf16", "paged", "int8",
                                  "no_cache"])
def test_build_server_composes_the_spec(case):
    """``build_server`` composes as the JAX package's rollout worker
    does: int8 implies the pool, the pool defaults to fp32 rows at dense
    parity, a paged engine pairs with the pooled prefix cache and a dense
    one with the host cache; the scheduler and queue take the spec's
    settings, and the engine serves a request to its end."""
    from realhf_tpu_torch.api.experiment import ServingSpec
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.serving.server import build_server
    from test_torch_inflight import models
    over = dict(dense={}, dense_bf16=dict(kv_cache_dtype="bf16"),
                paged=dict(paged_kv=True, kv_block_len=8),
                int8=dict(kv_cache_dtype="int8", kv_block_len=8,
                          kv_pool_blocks=30),
                no_cache=dict(prefix_cache_bytes=0))[case]
    sv = ServingSpec(n_slots=2, chunk_size=4, max_prompt_len=40,
                     max_queue_depth=5, max_staleness=2, stream_tokens=False,
                     gconfig=dict(max_new_tokens=6, greedy=True), **over)
    _, _, tcfg, tparams = models()
    eng = build_server(sv, tcfg, tparams, device="cpu")
    gen, pool, cache = eng.generator, eng.kv_pool, eng.prefix_cache
    assert gen.kv_pool is pool and gen.n_slots == 2 and gen.chunk == 4
    if case in ("paged", "int8"):
        assert pool.dtype == ("int8" if case == "int8" else "fp32")
        cache_len = T.round_cache_len(40 + 6)
        assert pool.n_blocks == (30 if case == "int8"
                                 else 2 * -(-cache_len // 8))
        assert isinstance(cache, tpc.PooledPrefixCache)
    else:
        assert pool is None
        assert gen.state["cache"]["k"].dtype == (
            torch.bfloat16 if case == "dense_bf16" else torch.float32)
        assert (cache is None if case == "no_cache"
                else isinstance(cache, tpc.RadixPrefixCache))
    sched = eng.scheduler
    assert (sched.backend, sched.queue, sched.weight_sync) == (
        gen, eng.queue, eng.weight_sync)
    assert (sched.max_staleness, sched.stream_tokens) == (2, False)
    assert eng.queue.max_depth == 5
    prompt = np.arange(2, 14, dtype=np.int32)
    assert eng.queue.submit(trq.GenRequest("a", prompt)).accepted
    events = []
    while not sched.idle() or not events:
        events += sched.step(None)
    assert [e.kind for e in events] == [tproto.STARTED, tproto.DONE]
    want = gen.generate_all([prompt])[0]
    np.testing.assert_array_equal(events[-1].data["result"].tokens,
                                  want.tokens)


# ----------------------------------------------------------------------
# the scheduler over real generators: port vs JAX
# ----------------------------------------------------------------------
def _real_serve(m, side):
    """Paged fp32 pool + pooled prefix cache, 3 slots, 7 requests of
    which 4 share a 16-token prefix, a weight push after 3 steps with
    max_staleness 1: the normalized events and counters. The port's
    engine is composed by ``build_server``."""
    clock = Clock()
    jg, tg = hyper(max_new_tokens=8, min_new_tokens=1)
    if side == "jax":
        g = jax_gen(jg, n_slots=3, max_prompt_len=40, eos_token_id=None,
                    pad_token_id=0, chunk_size=4, pool=(24, 8, "fp32"))
        cache = m["pc"].PooledPrefixCache(g.kv_pool,
                                          12 * g.kv_pool.block_bytes)
        q = m["rq"].RequestQueue(max_depth=16, n_slots=3,
                                 max_prompt_len=g.max_prompt_len,
                                 clock=clock)
        ws = m["ws"].WeightSync()
        sched = m["sched"].ContinuousScheduler(
            g, q, ws, max_staleness=1, prefix_cache=cache, clock=clock)
    else:
        from realhf_tpu_torch.api.experiment import ServingSpec
        from realhf_tpu_torch.serving.server import build_server
        from test_torch_inflight import models
        _, _, tcfg, tparams = models()
        block_bytes = tkvp.KVPool(tcfg, 1, 8, device="cpu").block_bytes
        sv = ServingSpec(
            n_slots=3, chunk_size=4, max_prompt_len=40, max_queue_depth=16,
            max_staleness=1, gconfig=dict(max_new_tokens=8, min_new_tokens=1,
                                          greedy=True),
            paged_kv=True, kv_cache_dtype="fp32", kv_block_len=8,
            kv_pool_blocks=24, prefix_cache_bytes=12 * block_bytes)
        eng = build_server(sv, tcfg, tparams, device="cpu", clock=clock)
        g, q, ws, sched = (eng.generator, eng.queue, eng.weight_sync,
                           eng.scheduler)
    rng = np.random.default_rng(0)
    shared = rng.integers(2, 120, size=16)
    for i in range(7):
        tail = rng.integers(2, 120, size=int(rng.integers(3, 12)))
        p = np.concatenate([shared, tail]) if i % 2 == 0 else tail
        assert q.submit(m["rq"].GenRequest(f"r{i}", p.astype(np.int32))
                        ).accepted
    steps = []
    for n in range(40):
        clock.t += 1.0
        if n == 3:
            ws.push(g.params, 1)  # same weights, new version
        steps.append(sched.step(jax.random.PRNGKey(n) if side == "jax"
                                else None))
        if sched.idle():
            break
    return steps, sched.stats, g.fill_stats, g.kv_pool.stats()


def test_scheduler_over_the_generator_matches_jax():
    jsteps, jstats, jfill, jpool = _real_serve(J, "jax")
    tsteps, tstats, tfill, tpool = _real_serve(P, "port")
    assert tstats == jstats and tpool == jpool
    assert tfill == {k: jfill[k] for k in tfill}  # below JAX's pair cap
    assert jstats["prefix_hits"] > 0 and jfill["prefill_tokens_saved"] > 0
    assert len(tsteps) == len(jsteps)
    n_done = 0
    for js, ts in zip(jsteps, tsteps):
        assert [(e.kind, e.rid) for e in ts] == [(e.kind, e.rid) for e in js]
        for je, te in zip(js, ts):
            jd, td = dict(je.data), dict(te.data)
            jr, tr = jd.pop("result", None), td.pop("result", None)
            for key in ("logprobs",):
                if key in jd:
                    np.testing.assert_allclose(td.pop(key), jd.pop(key),
                                               atol=LOGP_ATOL)
            assert _norm(td) == _norm(jd)
            if jr is not None:
                n_done += 1
                np.testing.assert_allclose(tr.logprobs, jr.logprobs,
                                           atol=LOGP_ATOL)
                tr.logprobs = jr.logprobs
                assert _norm(tr) == _norm(jr)
    assert n_done == 7 - jstats["stale"]
