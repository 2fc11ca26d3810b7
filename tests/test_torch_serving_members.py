"""The serving engine over the members of a layout: the port's
``InflightBatchingGenerator`` on a ``MemberParams`` (members on
``["cpu"] * n``) against the JAX package's generator built on the same
mesh (``mesh=eng.mesh``, ``moe_constraint=eng.moe_constraint``, the 8
virtual CPU devices of ``tests/conftest.py``), on the same numpy weights
and prompts.

Covered: dense at d2t1, d1t2 and d2t2 with and without EOS; a sampled
run at d2t2 against the one-device generator; the slot API with slots
in both data groups; paged fp32 and int8 at d2t2; speculative decoding
(k = 4) at d2t2; a radix suffix fill and a pooled prefix hit whose donor
ran in the other data group; the "seq" route (t4 over 2 KV heads); MoE
at d1t2 with capacity and with ragged dispatch, and with expert
parallelism at d2t1;
the ``gen`` experiment with inflight batching on p2 and c2 engines
(through the decode view); the scheduler over a d2t2 generator with a
weight push; ``build_server`` over a d2t2 model; and a pending
``MemberParams`` push being a copy.

Tolerances: fp32 on the CPU on both sides, sums in different orders:
greedy tokens equal, log-probs within 1e-5 (1e-4 for the int8 pool, as
``test_torch_inflight.py`` allows).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from realhf_tpu.engine import kv_pool as jkvp
from realhf_tpu.engine.inflight import InflightBatchingGenerator as JGen
from realhf_tpu.models.config import MoEConfig as JMoE
from realhf_tpu.serving import prefix_cache as jpc
from realhf_tpu.serving import request_queue as jrq
from realhf_tpu.serving import scheduler as jsched
from realhf_tpu.serving import weight_sync as jws
from realhf_tpu_torch.engine import kv_pool as tkvp
from realhf_tpu_torch.engine.engine import Engine
from realhf_tpu_torch.engine.inflight import InflightBatchingGenerator as TGen
from realhf_tpu_torch.models.config import MoEConfig, TransformerConfig
from realhf_tpu_torch.models.sharding import MemberParams
from realhf_tpu_torch.parallel.mesh import ParallelismConfig
from realhf_tpu_torch.serving import request_queue as trq
from realhf_tpu_torch.serving.weight_sync import WeightSync

from test_torch_inflight import (
    CFG,
    LOGP_ATOL,
    assert_same,
    hyper,
    models,
    probe_eos,
    prompts_of,
)
from test_torch_serving_scheduler import Clock, _norm
from test_torch_tp_engine import _jax_engine

INT8_ATOL = 1e-4
KW = dict(max_prompt_len=40, pad_token_id=0, chunk_size=4)
MOE = {"capacity": dict(num_experts=4, top_k=2, capacity_factor=1.25),
       "ragged": dict(num_experts=4, top_k=2),
       "ep": dict(num_experts=4, top_k=2, capacity_factor=1.25,
                  expert_parallel=True)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: many small ops over several members run
    faster so beside the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_kw(moe=None):
    if moe is None:
        return dict(CFG)
    return dict(CFG, mlp_type="moe", moe=MoEConfig(**MOE[moe]))


@functools.lru_cache(maxsize=None)
def engines(d, t, moe=None):
    """(JAX engine on a d x t mesh, port engine at dNtM on the CPU) over
    ``models()``' weights (a MoE model's of seed 0)."""
    kw = _cfg_kw(moe)
    if moe is None:
        w = jax.device_get(models()[1])
    else:
        from realhf_tpu.models import transformer as JT
        from realhf_tpu.models.config import TransformerConfig as JConfig
        w = jax.device_get(JT.init_params(
            JConfig(**dict(kw, moe=JMoE(**MOE[moe]))),
            jax.random.PRNGKey(0)))
    jeng = _jax_engine(dict(kw, moe=JMoE(**MOE[moe])) if moe else kw, d, t,
                       params=w)
    eng = Engine(TransformerConfig(**kw), w, device="cpu",
                 parallel=ParallelismConfig(data_parallel_size=d,
                                            tensor_parallel_size=t),
                 devices=["cpu"] * (d * t))
    return jeng, eng


def pair(d, t, jg, tg, *, pool=None, moe=None, **kw):
    """(JAX generator on the mesh, port generator over the members);
    ``pool`` = (n_blocks, block_len, dtype)."""
    jeng, eng = engines(d, t, moe)
    jkw, tkw = dict(kw), dict(kw)
    if pool is not None:
        jkw["kv_pool"] = jkvp.KVPool(jeng.cfg, *pool[:2], dtype=pool[2])
        tkw["kv_pool"] = tkvp.KVPool(eng.cfg, *pool[:2], dtype=pool[2],
                                     device="cpu", devices=eng.params.devices,
                                     t=t)
    return (JGen(jeng.cfg, jeng.params, jg, mesh=jeng.mesh,
                 moe_constraint=jeng.moe_constraint, **jkw),
            TGen(eng.cfg, eng.params, tg, device="cpu", **tkw))


def _run(j, t, prompts):
    return (j.generate_all(prompts, jax.random.PRNGKey(0)),
            t.generate_all(prompts))


@pytest.mark.parametrize("eos_mode", ["none", "probe"])
@pytest.mark.parametrize("d,t", [(2, 1), (1, 2), (2, 2)])
def test_dense_matches_jax_on_the_mesh(d, t, eos_mode):
    """6 prompts through 3 slots (the groups hold 2 and 1 at d2):
    refills in both groups, tokens and counts as JAX's."""
    prompts = prompts_of(1, 6)
    eos = probe_eos(prompts) if eos_mode == "probe" else None
    jg, tg = hyper(max_new_tokens=8, min_new_tokens=1)
    j, tt = pair(d, t, jg, tg, n_slots=3, eos_token_id=eos, **KW)
    ref, got = _run(j, tt, prompts)
    assert_same(ref, got)
    assert tt.counts["full_prefills"] == 6
    if eos is not None:
        assert any(not f.no_eos for f in got)


def test_sampled_run_equals_one_device():
    """Sampling at d2t2 draws once over the whole slot batch from the
    caller's generator, as the batch path at members does: the same
    tokens as the one-device generator under the same generator seed."""
    from test_torch_inflight import port_gen
    _, tg = hyper(max_new_tokens=8, greedy=False, top_k=20, top_p=0.9,
                  temperature=0.8)
    prompts = prompts_of(9, 5)
    outs = [g.generate_all(prompts, torch.Generator().manual_seed(4))
            for g in (port_gen(tg, n_slots=3, eos_token_id=None, **KW),
                      pair(2, 2, hyper()[0], tg, n_slots=3,
                           eos_token_id=None, **KW)[1])]
    assert_same(*outs)


def test_slot_api_with_slots_in_both_groups():
    """fill / decode_chunk / snapshot / harvest / release on slots of
    group 0 (slot 1) and group 1 (slot 3) at d2t2, step by step."""
    jg, tg = hyper(max_new_tokens=12)
    j, t = pair(2, 2, jg, tg, n_slots=4, eos_token_id=None, **KW)
    p = prompts_of(4, 3, 5, 30)
    for g, side in ((j, True), (t, False)):
        g.fill_slot(1, 10, p[0])
        g.fill_slot(3, 11, p[1])
    for _ in range(2):
        j.decode_chunk(jax.random.PRNGKey(0))
        t.decode_chunk()
    js, ts = j.snapshot_slots([1, 3]), t.snapshot_slots([1, 3])
    for s in (1, 3):
        np.testing.assert_array_equal(ts[s][0], js[s][0])
        np.testing.assert_allclose(ts[s][1], js[s][1], atol=LOGP_ATOL)
    for g in (j, t):
        g.release_slot(1)
        g.fill_slot(0, 12, p[2])
    assert j.free_slots() == t.free_slots() == [1, 2]
    for _ in range(3):
        j.decode_chunk(jax.random.PRNGKey(0))
        t.decode_chunk()
    assert_same(sorted(j.harvest(), key=lambda f: f.request_id),
                sorted(t.harvest(), key=lambda f: f.request_id))
    assert t.n_live == j.n_live == 0


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_paged_matches_jax_on_the_mesh(dtype):
    """The paged pool at d2t2 (an arena per member over its KV heads,
    one allocator): tokens, log-probs and pool accounting as JAX's."""
    prompts = prompts_of(2, 6)
    eos = probe_eos(prompts)
    jg, tg = hyper(max_new_tokens=8, min_new_tokens=1)
    j, t = pair(2, 2, jg, tg, pool=(24, 8, dtype), n_slots=3,
                eos_token_id=eos, **KW)
    ref, got = _run(j, t, prompts)
    assert_same(ref, got, atol=LOGP_ATOL if dtype == "fp32" else INT8_ATOL)
    assert t.kv_pool.stats() == j.kv_pool.stats()
    assert t.kv_pool.n_free == t.kv_pool.n_blocks
    assert [a["k"].shape[1] for a in t.kv_pool._members] == [1] * 4


@pytest.mark.parametrize("paged", [False, True])
def test_spec_decode_matches_jax_and_plain_greedy(paged):
    """k = 4 at d2t2 on prompts that repeat (drafts get accepted):
    tokens and spec counts as JAX's, and the non-spec run's tokens; paged
    with a cache (256 rows) longer than the verify windows (128)."""
    rng = np.random.default_rng(7)
    prompts = [np.tile(rng.integers(2, 120, size=5), 5)[:n].astype(np.int32)
               for n in (18, 23, 11, 25)]
    jg, tg = hyper(max_new_tokens=10)
    kw = dict(KW, max_prompt_len=200 if paged else 40)
    j, t = pair(2, 2, jg, tg, pool=(80, 8, "fp32") if paged else None,
                n_slots=2, eos_token_id=None, spec_decode_k=4, **kw)
    ref, got = _run(j, t, prompts)
    assert_same(ref, got)
    plain = pair(2, 2, jg, tg, n_slots=2, eos_token_id=None, **kw)[1]
    assert_same(plain.generate_all(prompts),
                [f.__class__(**{**f.__dict__, "spec_proposed": 0,
                                "spec_accepted": 0}) for f in got])
    assert sum(f.spec_accepted for f in got) > 0


def _finish(g, slot, rid, prompt, jax_side, export, **fill_kw):
    g.fill_slot(slot, rid, prompt, **fill_kw)
    out = []
    while not out:
        if jax_side:
            g.decode_chunk(jax.random.PRNGKey(0))
        else:
            g.decode_chunk()
        out = g.harvest(**{export: True})
    return out[0]


@pytest.mark.parametrize("kind,d,t", [("radix", 2, 2), ("pooled", 2, 2),
                                      ("pooled", 2, 4)])
def test_prefix_fill_from_the_other_group(kind, d, t):
    """A donor finished in slot 0 (group 0) seeds a fill of slot 1
    (group 1) at d2t2 (and d2t4, the "seq" route): the radix cache's
    host KV (exported in JAX's layout, every KV head) or the pooled
    cache's aliased blocks (copied into group 1's arenas). Tokens, the
    exported KV, ``last_fill`` and the pool's accounting as JAX's."""
    rng = np.random.default_rng(5)
    common = rng.integers(2, 120, size=16).astype(np.int32)
    p1 = np.concatenate([common, rng.integers(2, 120, size=8)]).astype(
        np.int32)
    p2 = np.concatenate([common, rng.integers(2, 120, size=8)]).astype(
        np.int32)
    jg, tg = hyper(max_new_tokens=8, min_new_tokens=1)
    pool = (16, 8, "fp32") if kind == "pooled" else None
    gens = pair(d, t, jg, tg, pool=pool, n_slots=2, eos_token_id=1,
                max_prompt_len=40, pad_token_id=0, chunk_size=4)
    export = "export_blocks" if kind == "pooled" else "export_kv"
    outs = []
    for g, side in zip(gens, (True, False)):
        fin = _finish(g, 0, 0, p1, side, export)
        fill = (dict(cached_blocks=list(fin.blocks)) if kind == "pooled"
                else dict(prefix_kv=tuple(x[:, :, :16] for x in fin.kv)))
        got = _finish(g, 1, 1, p2, side, export, cached_len=16, **fill)
        outs.append((fin, got))
        assert g.last_fill["cached_len"] == 16
        if kind == "pooled":
            g.kv_pool.free(fin.blocks)
            g.kv_pool.free(got.blocks)
            assert g.kv_pool.n_free == g.kv_pool.n_blocks
    (jfin, jgot), (tfin, tgot) = outs
    assert_same([jfin, jgot], [tfin, tgot])
    assert gens[1].last_fill == gens[0].last_fill
    if kind == "radix":
        for a, b in zip(jgot.kv + jfin.kv, tgot.kv + tfin.kv):
            assert a.shape == b.shape
            np.testing.assert_allclose(b, a, rtol=0, atol=LOGP_ATOL)
    else:
        assert (tfin.blocks, tfin.n_rows) == (jfin.blocks, jfin.n_rows)
        assert gens[1].kv_pool.stats() == gens[0].kv_pool.stats()


@pytest.mark.parametrize("paged", [False, True])
def test_seq_route_matches_jax(paged):
    """t4 over 2 KV heads: every member holds both KV heads over its
    quarter of the slots (K4 with statistics on the card); the dense
    cache and the paged pool, with EOS."""
    prompts = prompts_of(3, 5)
    eos = probe_eos(prompts)
    jg, tg = hyper(max_new_tokens=8, min_new_tokens=1)
    j, t = pair(1, 4, jg, tg, pool=(24, 8, "fp32") if paged else None,
                n_slots=3, eos_token_id=eos, **KW)
    assert t._lay.seq and t._lay.s_loc * 4 == t._lay.slots
    ref, got = _run(j, t, prompts)
    assert_same(ref, got)


@pytest.mark.parametrize("moe,d,t", [("capacity", 1, 2), ("ragged", 1, 2),
                                     ("ep", 2, 1)])
def test_moe_matches_jax_on_the_mesh(moe, d, t):
    """MoE at d1t2: capacity taken over every slot of a decode step (idle
    slots included), as JAX routes the jitted slot batch; ragged
    dispatch exact; expert parallelism at d2t1 (a fill on one group
    reaches the other group's experts)."""
    prompts = prompts_of(6, 5)
    jg, tg = hyper(max_new_tokens=6)
    j, t = pair(d, t, jg, tg, moe=moe, n_slots=3, eos_token_id=None, **KW)
    assert t.params.ep == (moe == "ep")
    ref, got = _run(j, t, prompts)
    assert_same(ref, got)


# ----------------------------------------------------------------------
# the gen experiment through the decode view
# ----------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["p2", "c2"])
def test_gen_experiment_inflight_through_the_view(tmp_path, layout):
    """``gen`` with use_inflight_batching on a p2 and a c2 engine: the
    interface runs the generator on ``Engine.decode_engine()`` (d2t1),
    keeps no reference to the view's weights between calls, and
    generates what JAX's gen experiment on the same layout generates."""
    from realhf_tpu.parallel.mesh import parse_parallelism as jparse
    from realhf_tpu_torch.parallel.mesh import parse_parallelism
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
    from realhf_tpu_torch.models.convert import params_from_numpy
    path = str(tmp_path / "prompts.jsonl")
    _prompts(path)
    jspec = _spec(JaxGenConfig, jax_overrides, JaxTokenizer(vocab_size=1000),
                  path)
    tspec = _spec(GenerationConfig, apply_overrides,
                  IntegerTokenizer(vocab_size=1000), path)
    jspec.models["default"].parallel = jparse(layout)
    tspec.models["default"].parallel = parse_parallelism(layout)
    for spec in (jspec, tspec):
        spec.mfcs[0].interface_impl.args.update(use_inflight_batching=True,
                                               inflight_slots=3)
    jax_runner = JaxRunner(jspec)
    runner = InlineRunner(tspec, device="cpu")
    eng = runner.models["default"].engine
    eng.set_params(params_from_numpy(
        jax_runner.models["default"].engine.params_numpy()))
    want = _generated(jax_runner)
    got = _generated(runner)
    assert got == want
    itf = runner.interfaces["gen"]
    assert itf._inflight._lay.d == 2 and itf._inflight.params is None
    assert eng.decode_view_param_bytes() > 0


# ----------------------------------------------------------------------
# the scheduler and the server over members
# ----------------------------------------------------------------------
def _serve(side, d=2, t=2):
    """Paged fp32 pool + pooled prefix cache, 3 slots, 7 requests of
    which 4 share a 16-token prefix, a push of the generator's own
    weights after 3 steps under max_staleness 1: the normalized events
    and counters. The port's engine is composed by ``build_server``
    over the d2t2 engine's ``MemberParams``."""
    clock = Clock()
    jg, tg = hyper(max_new_tokens=8, min_new_tokens=1)
    jeng, eng = engines(d, t)
    if side == "jax":
        g = JGen(jeng.cfg, jeng.params, jg, n_slots=3, max_prompt_len=40,
                 eos_token_id=None, pad_token_id=0, chunk_size=4,
                 mesh=jeng.mesh, moe_constraint=jeng.moe_constraint,
                 kv_pool=jkvp.KVPool(jeng.cfg, 24, 8, dtype="fp32"))
        cache = jpc.PooledPrefixCache(g.kv_pool, 12 * g.kv_pool.block_bytes)
        q = jrq.RequestQueue(max_depth=16, n_slots=3,
                             max_prompt_len=g.max_prompt_len, clock=clock)
        ws = jws.WeightSync()
        sched = jsched.ContinuousScheduler(
            g, q, ws, max_staleness=1, prefix_cache=cache, clock=clock)
        rq = jrq
    else:
        from realhf_tpu_torch.api.experiment import ServingSpec
        from realhf_tpu_torch.serving.server import build_server
        block_bytes = tkvp.KVPool(eng.cfg, 1, 8, device="cpu").block_bytes
        sv = ServingSpec(
            n_slots=3, chunk_size=4, max_prompt_len=40, max_queue_depth=16,
            max_staleness=1, gconfig=dict(max_new_tokens=8, min_new_tokens=1,
                                          greedy=True),
            paged_kv=True, kv_cache_dtype="fp32", kv_block_len=8,
            kv_pool_blocks=24, prefix_cache_bytes=12 * block_bytes)
        srv = build_server(sv, eng.cfg, eng.params, device="cpu", clock=clock)
        g, q, ws, sched = (srv.generator, srv.queue, srv.weight_sync,
                           srv.scheduler)
        assert srv.kv_pool.devices == eng.params.devices
        rq = trq
    rng = np.random.default_rng(0)
    shared = rng.integers(2, 120, size=16)
    for i in range(7):
        tail = rng.integers(2, 120, size=int(rng.integers(3, 12)))
        p = np.concatenate([shared, tail]) if i % 2 == 0 else tail
        assert q.submit(rq.GenRequest(f"r{i}", p.astype(np.int32))).accepted
    steps = []
    for n in range(40):
        clock.t += 1.0
        if n == 3:
            ws.push(g.params, 1)  # the same weights, a new version
        steps.append(sched.step(jax.random.PRNGKey(n) if side == "jax"
                                else None))
        if sched.idle():
            break
    return steps, sched.stats, g.fill_stats, g.kv_pool.stats(), g


def test_scheduler_over_members_matches_jax():
    jsteps, jstats, jfill, jpool, _ = _serve("jax")
    tsteps, tstats, tfill, tpool, gen = _serve("port")
    assert isinstance(gen.params, MemberParams)
    assert tstats == jstats and tpool == jpool
    assert tfill == {k: jfill[k] for k in tfill}
    assert jstats["prefix_hits"] > 0 and tstats["swaps"] == 1
    assert len(tsteps) == len(jsteps)
    for js, ts in zip(jsteps, tsteps):
        assert [(e.kind, e.rid) for e in ts] == [(e.kind, e.rid) for e in js]
        for je, te in zip(js, ts):
            jd, td = dict(je.data), dict(te.data)
            jr, tr = jd.pop("result", None), td.pop("result", None)
            if "logprobs" in jd:
                np.testing.assert_allclose(td.pop("logprobs"),
                                           jd.pop("logprobs"),
                                           atol=LOGP_ATOL)
            assert _norm(td) == _norm(jd)
            if jr is not None:
                np.testing.assert_allclose(tr.logprobs, jr.logprobs,
                                           atol=LOGP_ATOL)
                tr.logprobs = jr.logprobs
                assert _norm(tr) == _norm(jr)


def test_build_server_over_a_d2t2_model():
    """A dense engine with the host radix cache over the d2t2 members
    serves what the same spec over the d1t1 weights serves; a canonical
    tree pushed to it is sharded onto its members; a pipeline layout is
    refused."""
    from realhf_tpu_torch.api.experiment import ServingSpec
    from realhf_tpu_torch.serving.server import build_server
    _, eng = engines(2, 2)
    tree = models()[3]
    sv = ServingSpec(n_slots=3, chunk_size=4, max_prompt_len=40,
                     gconfig=dict(max_new_tokens=6, greedy=True),
                     prefix_cache_bytes=1 << 20, kv_cache_dtype="fp32")
    rng = np.random.default_rng(2)
    shared = rng.integers(2, 120, size=20)
    prompts = [np.concatenate([shared, rng.integers(2, 120, size=4)]).astype(
        np.int32) for _ in range(5)]
    results = []
    for params in (eng.params, tree):
        srv = build_server(sv, eng.cfg, params, device="cpu")
        out = {}
        for i, p in enumerate(prompts):
            srv.queue.submit(trq.GenRequest(f"r{i}", p))
            for _ in range(50):
                for ev in srv.scheduler.step(None):
                    if "result" in ev.data:
                        out[ev.rid] = ev.data["result"]
                if srv.scheduler.idle():
                    break
        results.append((out, srv))
    (got, srv), (want, _) = results
    assert sorted(got) == sorted(want) == [f"r{i}" for i in range(5)]
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
        np.testing.assert_allclose(got[rid].logprobs, want[rid].logprobs,
                                   atol=LOGP_ATOL)
    assert srv.scheduler.stats["prefix_hits"] > 0
    srv.weight_sync.push(tree, 1)
    srv.scheduler.step(None)
    assert isinstance(srv.generator.params, MemberParams)
    assert srv.generator.params.trees[3]["blocks"]["attn"]["wq"].shape == (
        eng.params.trees[3]["blocks"]["attn"]["wq"].shape)
    pp = Engine(eng.cfg, models()[3], device="cpu",
                parallel=ParallelismConfig(pipeline_parallel_size=2),
                devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="decode view"):
        build_server(sv, eng.cfg, pp.params, device="cpu")


def test_pending_member_push_is_a_copy():
    """``WeightSync.push`` of a ``MemberParams`` snapshots every member's
    tree: an in-place step on the pushed weights after the push leaves
    the pending weights as they were."""
    _, eng = engines(2, 2)
    mp = MemberParams([{"w": torch.ones(2)} for _ in range(4)],
                      list(eng.params.devices), 2, 2)
    ws = WeightSync()
    ws.push(mp, 1)
    for tr in mp.trees:
        tr["w"].add_(1.0)
    got = []
    ws.poll(got.append)
    (pushed,) = got
    assert isinstance(pushed, MemberParams) and (pushed.d, pushed.t) == (2, 2)
    assert all(torch.equal(tr["w"], torch.ones(2)) for tr in pushed.trees)
