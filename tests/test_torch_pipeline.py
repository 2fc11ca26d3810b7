"""The port's pipeline (``parallel/pipeline.py`` GPipe,
``parallel/schedule.py`` 1F1B) against the JAX package's on the same
numpy inputs.

Covered: the tick streams and the analytics, equal to JAX's for S in
{2, 4} and M in {1..12}; ``microbatch_weights`` and ``pad_streams``;
the pipelined forward and its gradients under both schedules against
JAX's ``pipeline_blocks`` / ``pipeline_blocks_1f1b`` on a p2 mesh (M in
{2, 4}, and a remainder stream); the MoE aux losses against JAX's
pipelined ones, a padded microbatch included; both runners' aux values
per microbatch and their cotangents; the 1F1B stage inputs the
same at 4 and 8 layers, as ``fwd_residual_shapes`` says; and a CUDA stub
that every stage's recompute runs on its own device.

Tolerances: fp32 on the CPU on both sides. Hidden states and gradients
2e-5 absolute and relative (JAX's own test of the same pipeline against
its scan takes 2e-5 forward and 1e-4 on gradients; the port's gradient
of a leaf sums M microbatch partials where JAX's sums in its scan).
Aux losses 1e-6 absolute, 1e-5 relative, as JAX's test; the router's
gradient of the aux losses 1e-6 absolute, 1e-4 relative (JAX's gradient
tolerance; the router sums in fp32 over each microbatch's tokens).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realhf_tpu.models import sharding as jshard
from realhf_tpu.models import transformer as JT
from realhf_tpu.models.config import MoEConfig as JMoE
from realhf_tpu.models.config import TransformerConfig as JConfig
from realhf_tpu.parallel import pipeline as jpipe
from realhf_tpu.parallel import schedule as JS
from realhf_tpu.parallel.mesh import ParallelismConfig as JPar
from realhf_tpu.parallel.mesh import make_mesh as jmake_mesh
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import MoEConfig, TransformerConfig
from realhf_tpu_torch.models.convert import params_from_numpy
from realhf_tpu_torch.parallel import pipeline as P
from realhf_tpu_torch.parallel import schedule as S

BASE = dict(n_layers=4, n_kv_heads=2, n_q_heads=4, hidden_dim=32,
            intermediate_dim=64, vocab_size=128, apply_rotary=True,
            layer_norm_type="rms", mlp_type="llama",
            use_attention_bias=False, use_attn_proj_bias=False,
            use_mlp_bias=False, activation_function="silu",
            compute_dtype="float32", param_dtype="float32",
            gradient_checkpointing=True)
TOL = dict(rtol=2e-5, atol=2e-5)
MOE = dict(num_experts=4, top_k=2, aux_loss_coeff=0.01, z_loss_coeff=0.001)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its many small ops over
    several members run faster so, above all beside the other test
    workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ops(stream):
    return [(t.op, t.microbatch, t.phase) for t in stream]


@pytest.mark.parametrize("n_stages", [2, 4])
@pytest.mark.parametrize("n_mb", list(range(1, 13)))
def test_streams_and_analytics_equal_jax(n_stages, n_mb):
    for s in range(n_stages):
        for ours, theirs in ((S.forward_stage_stream, JS.forward_stage_stream),
                             (S.backward_stage_stream,
                              JS.backward_stage_stream),
                             (S.train_stage_stream, JS.train_stage_stream)):
            assert _ops(ours(n_stages, n_mb, s)) == _ops(
                theirs(n_stages, n_mb, s))
    assert [_ops(x) for x in S.train_schedule(n_stages, n_mb)] == [
        _ops(x) for x in JS.train_schedule(n_stages, n_mb)]
    for fn in ("ticks_per_pass", "train_ticks", "bubble_fraction"):
        assert getattr(S, fn)(n_stages, n_mb) == getattr(JS, fn)(
            n_stages, n_mb)
    for sched in S.SCHEDULES:
        assert S.computed_stage_steps(n_stages, n_mb, sched) == \
            JS.computed_stage_steps(n_stages, n_mb, sched)
        assert S.train_bubble_factor(n_stages, n_mb, sched) == \
            JS.train_bubble_factor(n_stages, n_mb, sched)
        assert S.default_microbatches(n_stages, sched) == \
            JS.default_microbatches(n_stages, sched)
    # every stage runs each microbatch once a pass, no bubble computes
    for s in range(n_stages):
        ops = [t.microbatch for t in S.forward_stage_stream(n_stages, n_mb, s)
               if t.op == "F"]
        assert ops == list(range(n_mb))
    for b in (1, n_mb, 2 * n_mb + 1):
        bm = -(-b // n_mb)
        np.testing.assert_array_equal(P.microbatch_weights(b, bm, n_mb),
                                      jpipe.microbatch_weights(b, bm, n_mb))
    x = np.arange(3 * 5, dtype=np.float32).reshape(3, 5)
    (got,), b = P.pad_streams([torch.from_numpy(x)], n_mb)
    (want,), jb = jpipe.pad_streams([jnp.asarray(x)], n_mb)
    assert b == jb == 3
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _batch(b=4, l=32, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, BASE["vocab_size"], size=(b, l)).astype(np.int32)
    seg = np.ones((b, l), np.int32)
    seg[:, l // 2:] = 2
    seg[-1, -l // 4:] = 0
    return ids, seg


def _jax_pipe(n_mb, sched):
    par = JPar(pipeline_parallel_size=2)
    mesh = jmake_mesh(par, devices=jax.devices("cpu")[:2])
    return mesh, jpipe.PipelineContext(mesh=mesh, n_stages=2,
                                       n_microbatches=n_mb, schedule=sched)


def _jax_params(cfg_kw, seed=0):
    jcfg = JConfig(**{k: v for k, v in cfg_kw.items() if k != "moe"},
                   moe=JMoE(**MOE) if "moe" in cfg_kw else None)
    return jcfg, JT.init_params(jcfg, jax.random.PRNGKey(seed))


def _port_cfg(cfg_kw):
    kw = dict(cfg_kw)
    if "moe" in kw:
        kw["moe"] = MoEConfig(**MOE)
    return TransformerConfig(**kw)


def _loss_jax(jcfg, ids, seg, pipe):
    """The loss and, as its aux, the pipelined hidden states."""
    def loss(p):
        h, _ = JT.forward(jcfg, p, ids, seg, pipeline=pipe)
        return (jax.nn.log_softmax(JT.lm_logits(jcfg, p, h)) ** 2).mean(), h
    return loss


def _grads_port(cfg, tree, ids, seg, pipe):
    tree = jax.tree.map(lambda a: a.detach().clone().requires_grad_(), tree)
    h, _ = T.forward(cfg, tree, torch.from_numpy(ids), torch.from_numpy(seg),
                     pipeline=pipe)
    loss = (torch.log_softmax(T.lm_logits(cfg, tree, h), -1) ** 2).mean()
    loss.backward()
    return h.detach(), jax.tree.map(lambda a: a.grad.numpy(), tree)


@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
@pytest.mark.parametrize("n_mb,b", [(2, 4), (4, 4), (2, 3)])
def test_pipelined_forward_and_grads_match_jax(sched, n_mb, b):
    """(2, 3): three streams in two microbatches, the last half
    padding."""
    jcfg, jparams = _jax_params(BASE)
    ids, seg = _batch(b=b)
    mesh, jp = _jax_pipe(n_mb, sched)
    psh = jax.device_put(jparams, jshard.param_shardings(jcfg, mesh))
    want_g, want_h = jax.jit(jax.grad(_loss_jax(jcfg, ids, seg, jp),
                                      has_aux=True))(psh)
    cfg = _port_cfg(BASE)
    tree = params_from_numpy(jax.tree.map(np.asarray, jparams))
    got_h, got_g = _grads_port(cfg, tree, ids, seg,
                               P.PipelineContext(2, n_mb, sched))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, want_g)))
    for path, g in jax.tree_util.tree_leaves_with_path(got_g):
        np.testing.assert_allclose(g, want[path], **TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_moe_aux_matches_jax_with_a_padded_microbatch():
    """Three streams, M 2: microbatch 1 holds one real stream and one
    padding stream, so the aux losses weigh 2/3 and 1/3, under both
    schedules; their router gradient against JAX's GPipe one (JAX's
    1F1B VJP refuses aux cotangents on jax 0.9: its ``bwd_run`` takes
    them as scalars under ``P(None)``)."""
    kw = dict(BASE, mlp_type="moe", moe=True)
    jcfg, jparams = _jax_params(kw, seed=1)
    ids, _ = _batch(b=3)
    seg = np.ones((3, 32), np.int32)
    mesh, jgp = _jax_pipe(2, "gpipe")
    psh = jax.device_put(jparams, jshard.param_shardings(jcfg, mesh))
    want_g = jax.jit(jax.grad(lambda p: sum(JT.forward(
        jcfg, p, ids, seg, return_aux=True, pipeline=jgp)[2].values())))(psh)
    cfg = _port_cfg(kw)
    tree = params_from_numpy(jax.tree.map(np.asarray, jparams))
    for sched in ("gpipe", "1f1b"):
        _, jp = _jax_pipe(2, sched)
        _, _, want = jax.jit(lambda p: JT.forward(
            jcfg, p, ids, seg, return_aux=True, pipeline=jp))(psh)
        leaves = jax.tree.map(lambda a: a.detach().clone().requires_grad_(),
                              tree)
        _, _, got = T.forward(cfg, leaves, torch.from_numpy(ids),
                              torch.from_numpy(seg), return_aux=True,
                              pipeline=P.PipelineContext(2, 2, sched))
        assert sorted(got) == sorted(want) and got
        for k in want:
            np.testing.assert_allclose(got[k].item(), float(want[k]),
                                       atol=1e-6, rtol=1e-5, err_msg=k)
        sum(got.values()).backward()
        g = leaves["blocks"]["mlp"]["router"].grad.numpy()
        np.testing.assert_allclose(
            g, np.asarray(want_g["blocks"]["mlp"]["router"]), atol=1e-6,
            rtol=1e-4)


@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
def test_aux_values_come_back_per_microbatch(sched):
    """Both runners hand back each microbatch's aux values keyed ``(m,
    key)``, summed over the stages and not weighted (the caller weighs
    them), a padded microbatch included; the cotangents the caller's
    weighting gives them reach every stage's leaf."""
    x = torch.randn(3, 4, 8, generator=torch.Generator().manual_seed(0))
    seg = torch.ones(3, 4, dtype=torch.int32)
    cos = sin = torch.zeros(3, 4, 1)
    ws = [torch.randn(8, generator=torch.Generator().manual_seed(s + 1))
          for s in range(2)]

    def step(s, trees, xs, segs, coss, sins, m):
        y = xs[0] * trees[0]["blocks"]["w"]
        return [y], {"a": y.sum()}

    leaves = [w.clone().requires_grad_() for w in ws]
    stages = [([{"blocks": {"w": w}}], [torch.device("cpu")])
              for w in leaves]
    run = P.pipeline_blocks if sched == "gpipe" else S.pipeline_blocks_1f1b
    h, aux = run(P.PipelineContext(2, 2, sched), stages, [x], seg, cos, sin,
                 step, return_aux=True)
    assert sorted(aux) == [(0, "a"), (1, "a")]
    w0, w1 = (w.clone().requires_grad_() for w in ws)
    y0 = x * w0
    want = {m: (y0[r] + y0[r] * w1).sum()
            for m, r in ((0, slice(0, 2)), (1, slice(2, 3)))}
    for m in (0, 1):
        torch.testing.assert_close(aux[(m, "a")], want[m])
    torch.testing.assert_close(h[0], y0 * w1)
    weights = P.microbatch_weights(3, 2, 2)
    sum(float(weights[m]) * aux[(m, "a")] for m in (0, 1)).backward()
    sum(float(weights[m]) * want[m] for m in (0, 1)).backward()
    for got, ref in zip(leaves, (w0, w1)):
        torch.testing.assert_close(got.grad, ref.grad)


def test_1f1b_saved_inputs_do_not_grow_with_depth():
    ids, seg = _batch(b=8, l=32)
    pipe = P.PipelineContext(2, 4, "1f1b")
    saved = []
    for n_layers in (4, 8):
        cfg = TransformerConfig(**dict(BASE, n_layers=n_layers))
        tree = jax.tree.map(lambda a: a.requires_grad_(), T.init_params(
            cfg, torch.Generator().manual_seed(0)))
        h, _ = T.forward(cfg, tree, torch.from_numpy(ids),
                         torch.from_numpy(seg), pipeline=pipe)
        saved.append(S.last_saved_bytes)
        h.square().mean().backward()
    want = S.fwd_residual_shapes(pipe, 8, 32, BASE["hidden_dim"],
                                 torch.float32)
    assert want["shape"] == (2, 4, 2, 32, 32)
    assert saved == [want["bytes"]] * 2 == [2 * 8 * 32 * 32 * 4] * 2


def test_each_stage_recomputes_on_its_own_device(monkeypatch):
    """The 1F1B backward runs on the autograd thread of the output's
    device; each stage-tick's recompute must enter its stage's device
    (``ops/_build.py`` ``on_device``), as the kernels launch on the
    current device. Stages stubbed onto cuda:0 / cuda:1 (their tensors
    stay on the CPU: the boundary copies are stubbed too)."""
    cfg = TransformerConfig(**BASE)
    tree = jax.tree.map(lambda a: a.requires_grad_(), T.init_params(
        cfg, torch.Generator().manual_seed(0)))
    stages = [([{"blocks": T._tree_narrow(tree["blocks"], 2 * s, 2)}],
               [torch.device("cuda", s)]) for s in range(2)]
    seen = []

    def recording(device):
        seen.append(device)
        return contextlib.nullcontext()

    monkeypatch.setattr(P, "on_device", recording)
    monkeypatch.setattr(S, "on_device", recording)
    monkeypatch.setattr(P, "_to", lambda x, device: x)
    ids, seg = _batch(b=4)
    seg_t = torch.from_numpy(seg)
    pos = T.positions_from_segments(seg_t)
    x = T._embed(cfg, tree, torch.from_numpy(ids).long(), pos)
    cos, sin = T._rotary_tables(cfg, pos)
    hs, _ = S.pipeline_blocks_1f1b(P.PipelineContext(2, 2, "1f1b"), stages,
                                   [x], seg_t, cos, sin,
                                   T._stage_step(cfg, None))
    fwd = list(seen)
    seen.clear()
    hs[0].square().mean().backward()
    cuda = [torch.device("cuda", i) for i in range(2)]
    # forward ticks: F(0) on stage 0; F(1) on 0, F(0) on 1; F(1) on 1
    assert fwd == [cuda[0], cuda[0], cuda[1], cuda[1]]
    # backward: the last stage leads (B(0) on 1; B(1) on 1, B(0) on 0;
    # B(1) on 0)
    assert seen == [cuda[1], cuda[1], cuda[0], cuda[0]]
    assert all(p.grad is not None for p in jax.tree.leaves(tree["blocks"]))
