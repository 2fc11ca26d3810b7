"""The port's paged KV pool against the JAX package's: the host
allocator over random op sequences (free list, refcounts, OOM, stats
after every op), block tables to flat rows, per-row int8 quantization,
and the pool's gather and scatter in fp32, bf16 and int8, all bit-equal
to JAX's on the same numpy inputs; masked lanes land on the scratch
block only; and the paged generator's capacity accounting.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realhf_tpu.engine import kv_pool as J
from realhf_tpu_torch.base.safetensors_io import tensor_to_numpy
from realhf_tpu_torch.engine import kv_pool as P

from test_torch_inflight import hyper, jax_gen, models, port_gen


def _apply(pool, op):
    """One allocator op -> its observable result (or the error type)."""
    kind, arg = op
    try:
        if kind == "alloc":
            return ("ok", pool.alloc(arg))
        if kind == "free":
            return ("ok", pool.free(arg))
        if kind == "incref":
            return ("ok", pool.incref(arg))
    except (P.KVPoolOOM, J.KVPoolOOM) as e:
        return ("oom", e.requested, e.free, e.shortfall)
    except ValueError:
        return ("value_error",)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_op_sequences_match_jax(seed):
    rng = np.random.default_rng(seed)
    jp, tp = J.KVPool.host_only(12, 4, 8), P.KVPool.host_only(12, 4, 8)
    held = []
    for _ in range(300):
        r = rng.random()
        if r < 0.4:
            op = ("alloc", int(rng.integers(0, 6)))
        elif r < 0.75 and held:
            op = ("free", [held.pop(int(rng.integers(len(held))))])
        elif r < 0.9 and held:
            op = ("incref", [held[int(rng.integers(len(held)))]])
        else:  # a bad op: double free / unallocated incref / scratch
            op = (["free", "incref"][int(rng.integers(2))],
                  [int(rng.integers(0, 13))])
        a, b = _apply(jp, op), _apply(tp, op)
        assert a == b, op
        if op[0] == "alloc" and a[0] == "ok":
            held.extend(a[1])
        if op[0] == "incref" and a[0] == "ok":
            held.extend(op[1])
        assert tp._free == jp._free
        np.testing.assert_array_equal(tp._ref, jp._ref)
        assert tp.stats() == jp.stats()
        assert (tp.n_free, tp.n_in_use, tp.block_bytes) == (
            jp.n_free, jp.n_in_use, jp.block_bytes)
    assert [tp.blocks_for_rows(n) for n in range(-1, 20)] == \
        [jp.blocks_for_rows(n) for n in range(-1, 20)]


def test_window_rows_match_jax():
    rng = np.random.default_rng(0)
    bt = rng.integers(0, 9, size=(3, 5)).astype(np.int32)
    war = np.arange(37, dtype=np.int32)
    want = np.asarray(J.window_rows(jnp.asarray(bt), jnp.asarray(war), 8))
    got = P.window_rows(torch.from_numpy(bt), torch.from_numpy(war), 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_rows_match_jax():
    """Per-row int8: random rows, rows of zeros, and values on exact
    half steps (round half to even in both)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 6, 32)).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 1] = np.linspace(-127, 127, 32).astype(np.float32) * 0.5  # .5 steps
    x[1, 1, 0] = 127.0
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        jq, js = J._quantize_rows(jnp.asarray(x).astype(dt))
        tq, ts = P._quantize_rows(torch.from_numpy(x).to(tdt))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the round trip stays inside the bound the int8 path promises
    deq = tq.float() * ts[..., None]
    xb = torch.from_numpy(x).bfloat16().float()
    bound = P.int8_roundtrip_error_bound(xb.numpy())
    assert float((deq - xb).abs().max()) <= bound
    assert bound == J.int8_roundtrip_error_bound(np.asarray(xb))


def _pools(dtype, cfg_j, cfg_t, seed):
    """A JAX and a port pool holding the same random rows."""
    jp = J.KVPool(cfg_j, 6, 4, dtype=dtype)
    tp = P.KVPool(cfg_t, 6, 4, dtype=dtype, device="cpu")
    rng = np.random.default_rng(seed)
    arrays = {}
    for name, a in jp.arrays().items():
        if a.dtype == jnp.int8:
            v = rng.integers(-127, 128, size=a.shape).astype(np.int8)
        else:
            v = rng.normal(size=a.shape).astype(np.float32)
            if name.endswith("scale"):
                v = np.abs(v) / 100
        arrays[name] = jnp.asarray(v).astype(a.dtype)
    jp.update(arrays)
    for name, a in arrays.items():
        tp.arrays()[name].copy_(torch.from_numpy(np.array(
            a.astype(jnp.float32))).to(tp.arrays()[name].dtype))
    return jp, tp


def _np(t):
    return np.asarray(tensor_to_numpy(t).astype(np.float32)) \
        if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_gather_and_scatter_bit_equal_to_jax(dtype, cdt):
    jcfg, _, tcfg, _ = models()
    jp, tp = _pools(dtype, jcfg, tcfg, 0)
    for name in jp.arrays():
        np.testing.assert_array_equal(
            _np(tp.arrays()[name]),
            np.asarray(jp.arrays()[name].astype(jnp.float32)))
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 28, size=(2, 9)).astype(np.int32)
    jk, jv = J.pool_gather(jp.meta, jp.arrays(), jnp.asarray(rows), cdt)
    tk, tv = P.pool_gather(tp.meta, tp.arrays(), torch.from_numpy(rows),
                           getattr(torch, cdt))
    assert tk.is_contiguous() and tuple(tk.shape) == tuple(jk.shape)
    for a, b in ((jk, tk), (jv, tv)):
        np.testing.assert_array_equal(_np(b), np.asarray(a.astype(
            jnp.float32)))
    # scatter: distinct live rows, masked lanes (some clamped onto live
    # rows' indices) that must land on the scratch block only
    nl, nkv, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    dst = rng.permutation(np.arange(4, 28))[:10].reshape(2, 5).astype(np.int32)
    mask = np.ones((2, 5), bool)
    mask[1, 3:] = False
    dst[1, 3:] = dst[0, 0]  # a masked lane aimed at a live row
    new_k = rng.normal(size=(nl, 2, nkv, 5, hd)).astype(np.float32)
    new_v = rng.normal(size=(nl, 2, nkv, 5, hd)).astype(np.float32)
    ja = J.pool_scatter(jp.meta, jp.arrays(), jnp.asarray(dst),
                        jnp.asarray(new_k).astype(cdt),
                        jnp.asarray(new_v).astype(cdt), jnp.asarray(mask))
    ta = P.pool_scatter(tp.meta, tp.arrays(), torch.from_numpy(dst),
                        torch.from_numpy(new_k).to(getattr(torch, cdt)),
                        torch.from_numpy(new_v).to(getattr(torch, cdt)),
                        torch.from_numpy(mask))
    blen = tp.block_len
    for name in ja:
        want = np.asarray(ja[name].astype(jnp.float32))
        got = _np(ta[name])
        # live rows bit-equal; the scratch block took the masked lanes
        np.testing.assert_array_equal(got[:, :, blen:], want[:, :, blen:],
                                      err_msg=name)
    # the live row a masked lane aimed at holds its own lane's value
    if (dtype, cdt) == ("fp32", "float32"):
        np.testing.assert_array_equal(_np(ta["k"])[:, :, dst[0, 0]],
                                      new_k[:, 0, :, 0])


def test_device_pool_guards():
    _, _, tcfg, _ = models()
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        P.KVPool(tcfg, 4, 4, dtype="fp8", device="cpu")
    with pytest.raises(ValueError):
        P.KVPool(tcfg, 0, 4, device="cpu")
    with pytest.raises(RuntimeError, match="host_only"):
        P.KVPool.host_only(4, 4).arrays()
    pool = P.KVPool(tcfg, 4, 4, dtype="int8", device="cpu")
    jpool = J.KVPool(models()[0], 4, 4, dtype="int8")
    assert pool.stats() == jpool.stats()
    assert set(pool.arrays()) == set(jpool.arrays())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            P.KVPool(tcfg, 4, 4)  # entry points default to the card


def test_block_tables_grow_lazily_and_oom_raises():
    """The generator reserves blocks per chunk as JAX's does, and a pool
    too small for the chunk's growth raises KVPoolOOM in both."""
    jg, tg = hyper(max_new_tokens=8, min_new_tokens=1)
    kw = dict(n_slots=2, max_prompt_len=24, eos_token_id=None,
              pad_token_id=0, chunk_size=4)
    j = jax_gen(jg, pool=(4, 8, "fp32"), **kw)
    t = port_gen(tg, pool=(4, 8, "fp32"), **kw)
    p = np.arange(2, 18, dtype=np.int32)  # 16 tokens = 2 blocks
    for g in (j, t):
        g.fill_slot(0, 0, p)
        assert len(g._slot_blocks[0]) == 2
    j.decode_chunk(jax.random.PRNGKey(0))
    t.decode_chunk()
    assert t._slot_blocks == j._slot_blocks
    np.testing.assert_array_equal(t._bt_host, j._bt_host)
    assert t._slot_rows_ub == j._slot_rows_ub
    assert t.kv_pool_stats() == j.kv_pool_stats()
    with pytest.raises(J.KVPoolOOM):
        j.fill_slot(1, 1, p[:9])  # 2 blocks, 1 free
    with pytest.raises(P.KVPoolOOM):
        t.fill_slot(1, 1, p[:9])
    for g in (j, t):
        g.fill_slot(1, 1, p[:5])  # the last free block
    with pytest.raises(J.KVPoolOOM) as je:
        j.decode_chunk(jax.random.PRNGKey(0))
    with pytest.raises(P.KVPoolOOM) as te:
        t.decode_chunk()
    assert (te.value.requested, te.value.free) == (je.value.requested,
                                                   je.value.free)
    for g in (j, t):
        assert [g.admission_blocks_needed(n, c) for n in (1, 8, 9, 24)
                for c in (0, 7, 8, 16, 30)] == \
            [j.admission_blocks_needed(n, c) for n in (1, 8, 9, 24)
             for c in (0, 7, 8, 16, 30)]
        g.release_slot(0)
        g.release_slot(1)
    assert t.kv_pool.n_free == j.kv_pool.n_free == 4
