"""KV heads replicated over the model members (t not dividing the KV
heads) and the decode's "seq" route, against the JAX package.

A model of one KV head at t2 (and at d2t2) and one of two KV heads at t4
run in the port's ``Engine`` on ``["cpu"] * n`` and in the JAX
``Engine`` at the same layout (GSPMD splits the KV columns there; the
port holds them whole on every member, and member j computes the one KV
head its query heads read) from the same numpy weights: forward
log-probs, greedy generation (the port decodes through the "seq" route:
each member its slice of the cache slots, K4's plain version with
statistics, then the flash merge), two train steps, a reallocation to
and from d1t1 and a save bit-equal to a d1t1 engine's. The merge
itself (``ops/decode_attention.decode_attention_seqsplit``) is held
against the JAX package's ``sharded_decode_attention_seqsplit`` with
its interpret-mode statistics kernel over four sequence shards, as
``tests/ops/test_sharded_kernels.py`` runs it: rows valid across
shards, a row valid on one shard, an empty row, a window, and the
stacked cache.

Tolerances: fp32 on both sides, sums in other orders. Log-probs 1e-4
absolute, losses and grad norms 1e-5 relative, weights after two AdamW
steps at lr 1e-2 1e-5 absolute (as ``test_torch_tp_engine.py``); the
merge 2e-5 (as the JAX test); reallocations and saves bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realhf_tpu.ops import decode_attention as jdec
from realhf_tpu.ops.attention import decode_attention as jdecode_attention
from realhf_tpu.ops.sampling import GenerationHyperparameters as JGen
from realhf_tpu.parallel.mesh import ParallelismConfig as JPar
from realhf_tpu.parallel.mesh import make_mesh as jmake_mesh
from realhf_tpu_torch.interfaces import sft
from realhf_tpu_torch.models import sharding
from realhf_tpu_torch.models.hf import save_hf_checkpoint_streamed
from realhf_tpu_torch.ops import decode_attention as dec
from realhf_tpu_torch.ops.attention import kv_replicated, member_heads
from realhf_tpu_torch.ops.sampling import GenerationHyperparameters
from realhf_tpu_torch.parallel.realloc import reallocate
from test_torch_tp_engine import (
    ATOL,
    OPT,
    TINY,
    _batch,
    _files,
    _jax_engine,
    _params_close,
    _port,
    _prompts,
    _sft_microbatches,
)

KV1 = dict(TINY, n_kv_heads=1)
KV2 = dict(TINY, n_kv_heads=2)
# (config, d, t): one KV head at t2 and d2t2, two at t4
CASES = [("kv1", 1, 2), ("kv2", 1, 4), ("kv1", 2, 2)]
CFGS = {"kv1": KV1, "kv2": KV2}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops over several members: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return {name: _jax_engine(kw, 1, 1, seed=3).params_numpy()
            for name, kw in CFGS.items()}


@pytest.mark.parametrize("name,d,t", CASES)
def test_forward_logprobs_match_jax(weights, name, d, t):
    kw, w = CFGS[name], weights[name]
    assert kv_replicated(kw["n_kv_heads"], t)
    eng = _port(kw, d, t, w)
    jeng = _jax_engine(kw, d, t, params=w)
    ids, seg, mask = _batch(5)
    np.testing.assert_allclose(
        eng.forward_logprobs(ids, seg, logits_mask=mask).numpy(),
        np.asarray(jeng.forward_logprobs(ids, seg, logits_mask=mask)),
        atol=ATOL, rtol=0)
    # every model member holds the whole KV weights
    wk = w["blocks"]["attn"]["wk"]
    for tr in eng.params.trees:
        np.testing.assert_array_equal(
            tr["blocks"]["attn"]["wk"].numpy(), wk)


@pytest.mark.parametrize("name,d,t", CASES[:2])
def test_greedy_generation_through_the_seq_route_matches_jax(
        weights, name, d, t):
    kw, w = CFGS[name], weights[name]
    ids, seg, pos = _prompts()
    gc = dict(max_new_tokens=8, greedy=True)
    want = jax.device_get(_jax_engine(kw, d, t, params=w).generate(
        ids, seg, pos, jax.random.PRNGKey(0), JGen(**gc), None, 0))
    one = _port(kw, 1, 1, w).generate(
        ids, seg, pos, None, GenerationHyperparameters(**gc), None, 0)
    eng = _port(kw, d, t, w)
    calls = []
    real = dec.seqsplit_merge

    def merge(parts, dtype):
        calls.append(len(parts))
        return real(parts, dtype)

    dec.seqsplit_merge = merge
    try:
        got = eng.generate(ids, seg, pos, None,
                           GenerationHyperparameters(**gc), None, 0)
    finally:
        dec.seqsplit_merge = real
    # one merge of t partials a layer a decode step
    assert calls == [t] * (kw["n_layers"] * 8)
    for ref in (want, one):
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(ref.tokens))
        np.testing.assert_allclose(got.logprobs.numpy(),
                                   np.asarray(ref.logprobs), atol=ATOL)


@pytest.mark.parametrize("name,d,t", CASES)
def test_train_steps_match_jax(weights, name, d, t):
    kw, w = CFGS[name], weights[name]
    jeng = _jax_engine(kw, d, t, params=w, opt=OPT)
    eng = _port(kw, d, t, w, opt=OPT)
    mbs, wts = _sft_microbatches(d, seed=2)
    for _ in range(2):
        want = jeng.train_batch(mbs, jsft_loss(jeng), loss_weights=wts,
                                loss_fn_key="sft")
        got = eng.train_batch(mbs, sft._make_loss_fn(eng.cfg), wts)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)
    _params_close(jeng, eng, atol=1e-5)
    # the replicated KV weights stay equal on every member after the
    # steps (their gradient was summed over the members that hold them)
    first = eng.params.trees[0]["blocks"]["attn"]
    for tr in eng.params.trees[1:]:
        for name_ in ("wk", "wv"):
            assert torch.equal(tr["blocks"]["attn"][name_], first[name_])


def jsft_loss(jeng):
    from realhf_tpu.interfaces import sft as jsft
    return jsft._make_loss_fn(jeng.cfg)


def test_reallocation_and_save_at_replicated_kv(tmp_path, weights):
    """d1t1 -> d1t2 (KV replicated) -> d1t4 -> the canonical tree,
    bit-equal; a d1t2 engine's streamed save is a d1t1 engine's file for
    file."""
    w = weights["kv1"]
    one = _port(KV1, 1, 1, w)
    t2 = _port(KV1, 1, 2, w)
    t4 = _port(KV1, 1, 4, w)
    for p in t2.params.trees + t4.params.trees:
        for leaf in jax.tree.leaves(p):
            leaf.zero_()
    reallocate(t2.cfg, one.params, t2)
    reallocate(t4.cfg, t2.params, t4)
    back = _port(KV1, 1, 1, w)
    for leaf in jax.tree.leaves(back.params):
        leaf.zero_()
    reallocate(back.cfg, t4.params, back)
    for a, b in zip(jax.tree.leaves(back.params_numpy()),
                    jax.tree.leaves(w)):
        np.testing.assert_array_equal(a, b)
    for name, e in (("one", one), ("t2", t2)):
        save_hf_checkpoint_streamed(
            str(tmp_path / name), "llama", one.cfg,
            e.gathered_params("cpu") if e.sharded else e.params)
    assert _files(str(tmp_path / "one")) == _files(str(tmp_path / "t2"))
    assert sharding.param_specs(t2.cfg, 2)["blocks"]["attn"]["wk"] == \
        (None, None, None)


def test_member_heads_and_the_decode_route():
    assert member_heads(8, 4, 2, 1) == ((4, 8), (2, 4))
    # one KV head over two members: each computes it for its 4 q heads
    assert [member_heads(8, 1, 2, j) for j in range(2)] == [
        ((0, 4), (0, 1)), ((4, 8), (0, 1))]
    assert [member_heads(8, 2, 4, j)[1] for j in range(4)] == [
        (0, 1), (0, 1), (1, 2), (1, 2)]
    with pytest.raises(ValueError, match="query heads"):
        member_heads(6, 2, 4)
    with pytest.raises(ValueError, match="parts of two KV heads"):
        member_heads(12, 3, 2)
    assert dec.choose_decode_route(4, 256, 2) == "heads"
    assert dec.choose_decode_route(2, 256, 4) == "seq"
    assert dec.seq_cache_len(17, 2) == 128
    assert dec.seq_cache_len(640, 4) == 768
    for s in (255, 320):  # not t slices, or slices of part tiles
        with pytest.raises(ValueError, match="whole 64-slot tiles"):
            dec.choose_decode_route(2, s, 4)


def _mesh():
    par = JPar(data_parallel_size=2, tensor_parallel_size=4)
    return jmake_mesh(par, devices=jax.devices("cpu")[:8])


def _jax_seqsplit(q, k, v, keep, layer=None):
    def fn_stats(q_l, k_l, v_l, keep_l, lidx):
        if layer is None:
            return jdec.flash_decode_attention(
                q_l, k_l, v_l, keep_l.astype(bool), interpret=True,
                return_stats=True)
        return jdec.flash_decode_attention_stacked(
            q_l, k_l, v_l, keep_l.astype(bool), lidx, interpret=True,
            return_stats=True)

    args = [jnp.asarray(a) for a in (q, k, v, keep)]
    if layer is None:
        return np.asarray(jax.jit(lambda *a: jdec.sharded_decode_attention_seqsplit(
            fn_stats, _mesh(), a[0], (a[1], a[2]), a[3], stacked=False))(
                *args))
    return np.asarray(jax.jit(lambda *a: jdec.sharded_decode_attention_seqsplit(
        fn_stats, _mesh(), a[0], (a[1], a[2]), a[3], a[4], stacked=True))(
            *args, jnp.asarray(layer, jnp.int32)))


def _port_seqsplit(q, k, v, keep, t=4, layer=None):
    ks, vs, kp = (torch.from_numpy(np.ascontiguousarray(a)).chunk(t, dim=-2)
                  if a.ndim > 2 else torch.from_numpy(a).chunk(t, dim=1)
                  for a in (k, v, keep))
    return dec.decode_attention_seqsplit(
        torch.from_numpy(q), ks, vs, kp, layer_index=layer).numpy()


@pytest.mark.parametrize("case", ["rows", "window", "stacked"])
def test_seqsplit_merge_matches_jax(case):
    rng = np.random.default_rng(4)
    nl, b, s, nq, nkv, hd = 3, 4, 256, 8, 2, 128
    q = rng.standard_normal((b, nq, hd)).astype(np.float32)
    shape = ((nl,) if case == "stacked" else ()) + (b, nkv, s, hd)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    valid = np.zeros((b, s), bool)
    valid[0, :200] = True
    valid[1, 64:192] = True   # valid across the shards
    valid[2, :40] = True      # valid on shard 0 alone
    # row 3 empty: the merge gives zeros, never NaNs
    slot = window = None
    if case == "window":
        valid[3, :220] = True
        slot, window = np.asarray([199, 191, 39, 219], np.int32), 100
    keep = np.array(jdec.window_keep(
        jnp.asarray(valid), window, None if slot is None
        else jnp.asarray(slot)))
    assert (dec.window_keep(torch.from_numpy(valid), window, None
                            if slot is None else torch.from_numpy(slot))
            .numpy() == keep).all()
    layer = 2 if case == "stacked" else None
    got = _port_seqsplit(q, k, v, keep, layer=layer)
    want = _jax_seqsplit(q, k, v, keep, layer)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    assert np.isfinite(got).all()
    if case != "window":
        np.testing.assert_array_equal(got[3], 0.0)
    # and the whole-cache decode on the rows with a kept slot
    kk, vv = (a[layer] if layer is not None else a for a in (k, v))
    dense = np.asarray(jdecode_attention(
        jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv), jnp.asarray(valid),
        sliding_window=window,
        slot=None if slot is None else jnp.asarray(slot)))
    rows = keep.any(1)
    np.testing.assert_allclose(got[rows], dense[rows], atol=2e-5, rtol=2e-5)


def test_merge_tests_m_never_l():
    """K4 writes m = NEG_INF and l = S for a slice with no kept slot: a
    merge that trusted l would weight that slice's zeros by S."""
    b, nq, hd = 2, 4, 64
    o = torch.ones((b, nq, hd))
    live = (o, torch.zeros((b, nq)), torch.ones((b, nq)))
    empty = (torch.zeros((b, nq, hd)), torch.full((b, nq), dec.NEG_INF),
             torch.full((b, nq), 256.0))
    np.testing.assert_array_equal(
        dec.seqsplit_merge([live, empty], torch.float32).numpy(), 1.0)
    np.testing.assert_array_equal(
        dec.seqsplit_merge([empty, empty], torch.float32).numpy(), 0.0)
