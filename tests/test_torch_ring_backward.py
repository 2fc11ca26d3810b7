"""The differentiable ring on the CPU: ``RingAttentionFn``'s backward,
on the plain per-round schedule the CUDA path runs, against ``jax.vjp``
of the JAX package's ``ring_attention`` over the virtual CPU mesh; the
extended backward rounds (keys' own segment ids, global offsets, fp32
partials) and the ring's lse against dense attention; the backward
against autograd through the plain ring's forward; the round count and
each round's ``on_device`` entry.

Inputs come from a numpy seed, fp32 on both sides. Tolerance 2e-5
absolute and relative: two fp32 computations of the same softmax
backward that sum in other orders (JAX's blockwise ring with its own
autodiff, the port's per-round K2/K3 arithmetic from the final lse),
on values of order 1.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from realhf_tpu.ops.ring_attention import ring_attention as jax_ring
from realhf_tpu_torch.ops import flash_attention as FA
from realhf_tpu_torch.ops import ring_attention_fused as RF
from realhf_tpu_torch.ops.ring_attention import (
    ring_attention_plain,
    ring_bwd_rounds,
)

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops over several members crawl beside the other xdist
    workers' threads: one intra-op thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b=2, l=64, nq=4, nkv=2, hd=16, pad_row=False):
    """q/k/v/do and segment ids: records that cross the shard boundaries
    (cuts at 13, 37, 50 of 64), trailing padding, and with ``pad_row``
    a stream of padding only."""
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, l, nq, hd)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, l, nkv, hd)).astype(np.float32)
            for _ in range(2))
    seg = np.zeros((b, l), np.int32)
    seg[0, :13], seg[0, 13:37], seg[0, 37:50], seg[0, 50:60] = 1, 2, 3, 4
    seg[1, :l - 5] = 7
    if pad_row:
        seg[1] = 0
    return q, k, v, seg, do


def _port_ring(q, k, v, seg, do, n, window):
    """The port's ring over n CPU members through ``RingAttentionFn``:
    (o, dq, dk, dv) as numpy."""
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    shards = [list(t.chunk(n, dim=1)) for t in (qt, kt, vt)]
    segs = list(torch.tensor(seg).chunk(n, dim=1))
    outs = RF.ring_attention_fused(*shards, segs, sliding_window=window,
                                   block_q=8, block_k=8)
    o = torch.cat(outs, dim=1)
    (o * torch.tensor(do)).sum().backward()
    return [x.detach().numpy() for x in (o, qt.grad, kt.grad, vt.grad)]


def _jax_ring(q, k, v, seg, do, n, window):
    mesh = Mesh(np.array(jax.devices("cpu")[:n]).reshape(1, n),
                ("data", "ctx"))

    @jax.jit
    def f(q, k, v, seg, do):
        o, vjp = jax.vjp(lambda q, k, v: jax_ring(
            q, k, v, seg, mesh, "ctx", sliding_window=window, block_q=8,
            block_k=8), q, k, v)
        return (o, *vjp(do))

    return [np.asarray(x) for x in f(*(jnp.asarray(a)
                                       for a in (q, k, v, seg, do)))]


@pytest.mark.parametrize("n,window,pad_row", [
    (2, None, False), (4, None, False), (4, 11, False), (2, None, True)])
def test_ring_backward_matches_jax_vjp(n, window, pad_row):
    """GQA (4 q heads over 2 KV heads), records across the shard
    boundaries, a sliding window, a stream of padding only (its rows get
    exact zeros, never NaN)."""
    args = _inputs(n + (window or 0), pad_row=pad_row)
    got = _port_ring(*args, n, window)
    want = _jax_ring(*args, n, window)
    seg = args[3]
    valid = seg != 0
    np.testing.assert_allclose(got[0][valid], want[0][valid], **TOL)
    for g, w, name in zip(got[1:], want[1:], ("dq", "dk", "dv")):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    if pad_row:
        for g in got:
            assert not g[1].any()


def _split(t, n):
    return [x.contiguous() for x in torch.as_tensor(t).chunk(n, dim=1)]


def test_ring_lse_matches_flash_lse_row_by_row():
    """The plain ring's lse, and the round kernel's plain version writing
    it on the last round of the CUDA schedule (``_run_ring`` with lse
    buffers, both directions), are K1's convention over the gathered
    stream: the same number row by row, NEG_INF exactly on a row with no
    valid key."""
    q, k, v, seg, _ = _inputs(5, pad_row=True)
    n = 4
    shards = [_split(a, n) for a in (q, k, v, seg)]
    outs, lses = ring_attention_plain(*shards, block_q=8, block_k=8,
                                      return_lse=True)
    bufs = [torch.empty(2, 4, 16) for _ in range(n)]
    sched = RF._run_ring(*shards, n_dirs=2, lch=8, scale=16 ** -0.5,
                         causal=True, sliding_window=None, lses=bufs)
    o, lse = FA.flash_attention_plain(*(torch.as_tensor(a)
                                        for a in (q, k, v, seg)))
    for got in (torch.cat(lses, dim=-1), torch.cat(bufs, dim=-1)):
        np.testing.assert_allclose(got.numpy(), lse.numpy(), **TOL)
        assert (got[1] == FA.NEG_INF).all()
    assert (lse[1] == FA.NEG_INF).all()
    for got in (outs, sched):
        np.testing.assert_allclose(torch.cat(got, 1).numpy(), o.numpy(),
                                   **TOL)


@pytest.mark.parametrize("window", [None, 20])
def test_backward_rounds_match_dense_attention(window):
    """One round (member i's q shard against shard src's keys, the keys'
    own ids, global offsets, fp32 out) is that pair's share of dense
    attention's gradient: dk/dv of shard src with do zero outside shard
    i, and dq_i summed over its rounds."""
    q, k, v, seg, do = _inputs(7)
    n, lc = 4, 16
    qt, kt, vt = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
                  for a in (q, k, v))
    seg_t = torch.tensor(seg)
    o, lse = FA.flash_attention_plain(qt, kt, vt, seg_t, window=window)
    for i in range(n):
        mask = torch.zeros_like(qt)
        mask[:, i * lc:(i + 1) * lc] = 1.0
        dq, dk, dv = torch.autograd.grad(
            (o * torch.tensor(do, dtype=torch.float64) * mask).sum(),
            (qt, kt, vt), retain_graph=True)
        rows = slice(i * lc, (i + 1) * lc)
        delta = FA.attention_delta(o[:, rows].detach(),
                                   torch.tensor(do[:, rows],
                                                dtype=torch.float64))
        dq_sum = torch.zeros_like(qt[:, rows])
        for src in range(n):
            cols = slice(src * lc, (src + 1) * lc)
            kw = dict(causal=True, window=window, seg_k=seg_t[:, cols],
                      q_off=i * lc, k_off=src * lc,
                      out_dtype=torch.float32)
            args = (qt[:, rows].detach(), kt[:, cols].detach(),
                    vt[:, cols].detach(), seg_t[:, rows],
                    torch.tensor(do[:, rows], dtype=torch.float64),
                    lse[:, :, rows].detach(), delta)
            pq = FA.flash_bwd_dq(*args, **kw)
            pk, pv = FA.flash_bwd_dkv(*args, **kw)
            assert pq.dtype == pk.dtype == torch.float32
            np.testing.assert_allclose(pk.numpy(), dk[:, cols].numpy(),
                                       **TOL)
            np.testing.assert_allclose(pv.numpy(), dv[:, cols].numpy(),
                                       **TOL)
            dq_sum += pq
        np.testing.assert_allclose(dq_sum.numpy(), dq[:, rows].numpy(),
                                   **TOL)


def test_round_count_and_each_rounds_device_entry(monkeypatch):
    """Causal without a window the backward runs n (n + 1) / 2 of the n * n
    rounds (a window skips the earlier rounds out of its reach too); each
    round's K2 and K3 calls run inside ``_build.on_device`` of member i's
    device, with member i's q shard and shard src's keys, in the
    schedule's order (the CPU stand-in for the card's launches)."""
    assert len(ring_bwd_rounds(4, 16, True, None)) == 10
    assert len(ring_bwd_rounds(4, 16, True, 17)) == 7
    assert len(ring_bwd_rounds(4, 16, False, None)) == 16
    events, entered = [], []

    @contextlib.contextmanager
    def on_device(dev):
        entered.append(dev)
        yield
        entered.pop()

    def stub(name, real):
        def call(q, k, *a, **kw):
            events.append((name, entered[-1] if entered else None,
                           kw["q_off"], kw["k_off"]))
            return real(q, k, *a, **kw)
        return call

    monkeypatch.setattr(RF._build, "on_device", on_device)
    monkeypatch.setattr(RF.FA, "flash_bwd_dq", stub("dq", FA.flash_bwd_dq))
    monkeypatch.setattr(RF.FA, "flash_bwd_dkv",
                        stub("dkv", FA.flash_bwd_dkv))
    q, k, v, seg, do = _inputs(9)
    _port_ring(q, k, v, seg, do, 4, None)
    want = [(name, torch.device("cpu"), i * 16, src * 16)
            for _, i, src in ring_bwd_rounds(4, 16, True, None)
            for name in ("dq", "dkv")]
    assert events == want


def test_backward_matches_autograd_of_the_plain_ring():
    """The schedule's gradients (``RingAttentionFn`` on CPU members: K2/K3's
    plain arithmetic per round, from the final lse) equal autograd through
    the plain ring's forward (its blockwise online softmax, every round's
    partial differentiated), with a window skipping rounds."""
    q, k, v, seg, do = _inputs(11)
    n, window = 4, 11
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    shards = [list(t.chunk(n, dim=1)) for t in leaves]
    outs = ring_attention_plain(*shards, _split(seg, n), block_q=8,
                                block_k=8, sliding_window=window)
    (torch.cat(outs, 1) * torch.tensor(do)).sum().backward()
    got = _port_ring(q, k, v, seg, do, n, window)
    for g, t, name in zip(got[1:], leaves, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, t.grad.numpy(), err_msg=name, **TOL)
