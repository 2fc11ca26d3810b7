"""The port's ring attention on the CPU against the JAX package's.

Two port paths are held against JAX on the same numpy inputs (packed
segments with padded tails, built as the JAX package's own fused-ring
tests build them): ``ring_attention_fused`` on CPU members, which runs
the plain ring (``ring_attention_plain``), and ``_run_ring``, the
schedule the CUDA members run (slots, pushes, rounds, global offsets),
here with the round kernel's plain version. The references are JAX's
``ring_attention`` (shard_map + ppermute) and ``ring_attention_fused``
in Pallas interpret mode on the virtual CPU mesh. Then ``_fit_block`` /
``_plan_dirs`` against JAX, the plain ring's gradients, the schedule's
launch counts, and the CUDA wrapper's checks on stub tensors.

Tolerance: fp32 on both sides, sums in other orders; values of order 1
agree to ~1e-6, so 2e-5 (the JAX tests' own) hides no masking or offset
fault, which shows up as O(1). Gradients, as in the JAX tests: 2e-4.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from realhf_tpu.ops import ring_attention as jra
from realhf_tpu.ops import ring_attention_fused as jrf
from realhf_tpu.ops.ring_attention import ring_attention as jax_ring
from realhf_tpu_torch.ops import ring_attention as ra
from realhf_tpu_torch.ops import ring_attention_fused as rf

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


def make_inputs(b=2, l=64, nq=4, nkv=2, hd=8, seed=0, n_seqs=2):
    """As ``tests/ops/test_ring_attention_fused.py`` builds them: n_seqs
    packed segments per row, the last 4 tokens padding."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, l, nq, hd)).astype(np.float32)
    k = rng.normal(size=(b, l, nkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, l, nkv, hd)).astype(np.float32)
    seg = np.zeros((b, l), np.int32)
    for bi in range(b):
        bounds = np.sort(rng.choice(
            np.arange(8, l - 8), size=n_seqs - 1, replace=False))
        prev, sid = 0, 1
        for e in list(bounds) + [l - 4]:
            seg[bi, prev:e] = sid
            prev, sid = e, sid + 1
    return q, k, v, seg


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]).reshape(n), ("ctx",))


def _shards(a, n):
    return [c.contiguous() for c in torch.from_numpy(a).chunk(n, dim=1)]


def _port(fn, inputs, n, **kw):
    """A port ring over n CPU members -> the gathered [B, L, nq, hd]."""
    return torch.cat(fn(*(_shards(a, n) for a in inputs), **kw),
                     dim=1).numpy()


def _schedule(q, k, v, seg, *, bidirectional=True, block_k=512, causal=True,
              sliding_window=None, n=4):
    """The CUDA members' schedule (``_run_ring``) with plain rounds."""
    lc = q.shape[1] // n
    n_dirs, lch, _ = rf._plan_dirs(lc, block_k, bidirectional)
    return _port(rf._run_ring, (q, k, v, seg), n, n_dirs=n_dirs, lch=lch,
                 scale=q.shape[-1] ** -0.5, causal=causal,
                 sliding_window=sliding_window)


# the cases the JAX fused kernel is held to, with their inputs
CASES = {
    "causal": (dict(), dict(seed=0)),
    "noncausal": (dict(causal=False), dict(seed=0)),
    "window24": (dict(sliding_window=24), dict(seed=3)),
    "unidirectional": (dict(bidirectional=False), dict(seed=11)),
}


@functools.lru_cache(maxsize=None)
def _jax_refs(case):
    kw, make = CASES[case]
    inputs = make_inputs(**make)
    jkw = {k: v for k, v in kw.items() if k != "bidirectional"}
    mesh = _mesh(4)
    args = [jax.numpy.asarray(a) for a in inputs]
    unfused = jax.jit(lambda *a: jax_ring(*a, mesh=mesh, **jkw))(*args)
    fused = jax.jit(lambda *a: jrf.ring_attention_fused(
        *a, mesh=mesh, interpret=True, **kw))(*args)
    return inputs, np.asarray(unfused), np.asarray(fused)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_ring_matches_jax_ring(case):
    inputs, unfused, _ = _jax_refs(case)
    kw = {k: v for k, v in CASES[case][0].items() if k != "bidirectional"}
    got = _port(ra.ring_attention_plain, inputs, 4, **kw)
    np.testing.assert_allclose(got, unfused, **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_entry_and_schedule_match_jax_fused_interpret(case):
    """The entry on CPU members (plain ring) and the CUDA schedule with
    plain rounds, against the Pallas kernel itself."""
    inputs, _, fused = _jax_refs(case)
    kw = CASES[case][0]
    got = _port(rf.ring_attention_fused, inputs, 4, **kw)
    np.testing.assert_allclose(got, fused, **TOL)
    np.testing.assert_allclose(_schedule(*inputs, **kw), fused, **TOL)


def test_ring8_shard_longer_than_a_block():
    """8 members, shards of 32 tokens in tiles of 16, GQA 8/2."""
    inputs = make_inputs(b=1, l=256, nq=8, nkv=2, seed=5)
    mesh = _mesh(8)
    want = np.asarray(jax.jit(lambda *a: jax_ring(
        *a, mesh=mesh, block_q=16, block_k=16))(
            *map(jax.numpy.asarray, inputs)))
    got = _port(rf.ring_attention_fused, inputs, 8, block_q=16, block_k=16)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(_schedule(*inputs, n=8, block_k=16), want,
                               **TOL)
    plain = _port(ra.ring_attention_plain, inputs, 8, block_q=16,
                  block_k=16)
    np.testing.assert_allclose(plain, want, **TOL)


def test_masked_rows_are_exactly_zero():
    """Padding tokens and an all-padding row see no valid key: 0, never
    NaN, on both port paths (and in JAX)."""
    q, k, v, seg = make_inputs(b=3, seed=2)
    seg[2] = 0
    pad = seg == 0
    for got in (_port(rf.ring_attention_fused, (q, k, v, seg), 4),
                _schedule(q, k, v, seg)):
        assert np.isfinite(got).all()
        assert (got[pad] == 0).all()
        assert not (got[~pad] == 0).all(-1).any()


@pytest.mark.parametrize("lc,block,bidir", [
    (16, 512, True), (8, 512, True), (16, 512, False), (64, 16, True),
    (24, 8, True), (200, 512, True), (36, 512, True), (18, 512, True),
    (8192, 512, True), (9, 512, False)])
def test_fit_block_and_plan_dirs_match_jax(lc, block, bidir):
    assert rf._plan_dirs(lc, block, bidir) == jrf._plan_dirs(lc, block, bidir)
    assert (rf._fit_block(lc, block, rf.MIN_TILE)
            == jrf._fit_block(lc, block))
    assert ra._fit_block(lc, block) == jra._fit_block(lc, block)


def test_fit_block_refuses_a_shard_without_a_tile():
    for fit in (functools.partial(rf._fit_block, min_tile=rf.MIN_TILE),
                jrf._fit_block):
        with pytest.raises(ValueError, match="no >=8 tile"):
            fit(14, 6)
    assert ra._fit_block(14, 6) == jra._fit_block(14, 6) == 2
    inputs = make_inputs(l=28)   # lc 7: no tile of 8
    with pytest.raises(ValueError, match="no >=8 tile"):
        _port(rf.ring_attention_fused, inputs, 4)


def test_one_member_is_attention_over_its_shard():
    inputs = make_inputs(seed=4)
    mesh = _mesh(1)
    want = np.asarray(jax_ring(*map(jax.numpy.asarray, inputs), mesh=mesh))
    np.testing.assert_allclose(_port(rf.ring_attention_fused, inputs, 1),
                               want, **TOL)
    np.testing.assert_allclose(_schedule(*inputs, n=1), want, **TOL)


def test_plain_ring_gradients_match_jax():
    q, k, v, seg = make_inputs(b=1, l=32, nq=2, nkv=1, seed=7)
    w = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)
    mesh = _mesh(4)
    jgrads = jax.grad(lambda a, b, c: (jax_ring(
        a, b, c, jax.numpy.asarray(seg), mesh) * w).sum(),
        argnums=(0, 1, 2))(*map(jax.numpy.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    outs = ra.ring_attention_plain(*(list(t.chunk(4, dim=1)) for t in ts),
                                   list(torch.from_numpy(seg).chunk(4, 1)))
    (torch.cat(outs, 1) * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **GRAD_TOL)


@pytest.mark.parametrize("n,bidir", [(4, True), (4, False), (2, True),
                                     (1, True)])
def test_schedule_issues_one_round_per_member_per_round(monkeypatch, n,
                                                        bidir):
    """n rounds per member, a push per member per round but the last,
    each push naming both directions' k, v and seg (one direction when
    unidirectional); the CPU never moves the launch counters."""
    rounds, pushes = [], []
    orig_round, orig_push = rf._launch_round, rf._launch_push

    def count_round(*a, **kw):
        rounds.append((kw["q_off"], tuple(kw["k_offs"]), kw["first"],
                       kw["last"]))
        return orig_round(*a, **kw)

    monkeypatch.setattr(rf, "_launch_round", count_round)
    monkeypatch.setattr(rf, "_launch_push",
                        lambda pairs: (pushes.append(len(pairs)),
                                       orig_push(pairs)))
    before = (rf.round_launches, rf.push_launches)
    inputs = make_inputs(seed=9)
    _schedule(*inputs, n=n, bidirectional=bidir)
    assert len(rounds) == n * n and len(pushes) == n * (n - 1)
    n_dirs = 2 if bidir else 1
    assert set(pushes) <= {3 * n_dirs}
    lc = 64 // n
    # round-major: round r of member j holds shard (j - r) % n's first
    # half and (j + r) % n's second half, at global offsets
    for i, (q_off, k_offs, first, last) in enumerate(rounds):
        r, j = divmod(i, n)
        assert q_off == j * lc and first == (r == 0) and last == (r == n - 1)
        want = [((j - r) % n) * lc]
        if bidir:
            want.append(((j + r) % n) * lc + lc // 2)
        assert list(k_offs) == want
    assert (rf.round_launches, rf.push_launches) == before


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: drives the CUDA
    wrapper's checks without a device."""

    @property
    def is_cuda(self):
        return True


def _stub_members(inputs, n=4, grad=False, dtype=None):
    out = []
    for i, a in enumerate(inputs):
        shards = _shards(a, n)
        if dtype is not None and i < 3:
            shards = [s.to(dtype) for s in shards]
        shards = [s.as_subclass(_OnCard) for s in shards]
        if grad and i < 3:
            shards = [s.requires_grad_() for s in shards]
        out.append(shards)
    return out


def test_cuda_wrapper_checks_before_it_launches(monkeypatch):
    launched = []

    def fake_ring(qs, *a, **kw):
        launched.append(kw.get("lses"))
        return [torch.zeros(q.shape, dtype=q.dtype) for q in qs]

    monkeypatch.setattr(rf, "_run_ring", fake_ring)
    inputs = make_inputs(hd=64)
    bf16 = torch.bfloat16
    # inputs that ask for a gradient go through the differentiable ring,
    # whose forward asks K6 for the rows' lse
    outs = rf.ring_attention_fused(*_stub_members(inputs, grad=True,
                                                  dtype=bf16))
    assert type(outs[0].grad_fn).__name__ == "RingAttentionFnBackward"
    assert len(launched.pop()) == 4
    with pytest.raises(TypeError, match="bfloat16 q"):
        rf.ring_attention_fused(*_stub_members(inputs))
    with pytest.raises(ValueError, match="hd 64, 128 or 256"):
        rf.ring_attention_fused(*_stub_members(make_inputs(), dtype=bf16))
    qs, ks, vs, segs = _stub_members(inputs, dtype=bf16)
    with pytest.raises(ValueError, match="seg must be contiguous"):
        rf.ring_attention_fused(qs, ks, vs, segs[:1] + [
            segs[1].t().contiguous().t()] + segs[2:])
    with pytest.raises(ValueError, match="differ from member 0"):
        rf.ring_attention_fused(qs, ks[:3] + [ks[3][:, :8]], vs, segs)
    with pytest.raises(ValueError, match="CPU and on CUDA"):
        rf.ring_attention_fused(qs[:3] + [qs[3].as_subclass(torch.Tensor)],
                                ks, vs, segs)
    assert not launched
    with torch.no_grad():  # a valid call reaches the launch, without lse
        rf.ring_attention_fused(qs, ks, vs, segs)
    assert launched == [None]
