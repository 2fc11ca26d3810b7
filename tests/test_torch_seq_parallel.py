"""Sequence parallelism (``s``) in the port on the CPU: the forward at
``d1t2s`` and ``d2t2s`` against the JAX package's ``T.forward`` under
``activation_constraint(mesh, True)`` on the virtual CPU mesh (as
``tests/model/test_sharded_forward.py`` runs it), and bit-equal to the
port's own layout without ``s``; the reduce-scatter; a train step with
``s`` (gradient checkpointing on and off) against the same layout
without it.

Inputs from a numpy seed, fp32 on both sides. Against JAX: 1e-4
relative and absolute on logits of order 1, the JAX package's own limit
for a sharded forward against one device (sums in other orders). Port
against port without ``s``: bit-equal, since the reduce-scatter sums in
the all-reduce's order and every op on the shard is per token, on
every token with seg != 0 (a padding row has no valid key; the CPU's
plain packed attention gives it the mean of every value row of the
stream, so the padding that ``s`` adds to reach a multiple of 8 t
tokens moves it, where K1 writes 0). The train step: loss 1e-6
relative, grad norm 1e-5 relative, weights 1e-6 absolute after one
AdamW step (lr 1e-3; the backward of the gathers and slices sums the
same gradients in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from realhf_tpu.models import sharding as jshard
from realhf_tpu.models import transformer as JT
from realhf_tpu.models.config import TransformerConfig as JConfig
from realhf_tpu.parallel.mesh import ParallelismConfig as JParallel
from realhf_tpu.parallel.mesh import make_mesh as jmake_mesh
from realhf_tpu_torch.engine.engine import Engine
from realhf_tpu_torch.engine.optim import OptimizerConfig
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.ops import functional as F
from realhf_tpu_torch.parallel import collectives as C
from realhf_tpu_torch.parallel.mesh import parse_parallelism

TINY = dict(n_layers=2, n_kv_heads=4, n_q_heads=8, hidden_dim=64,
            intermediate_dim=128, vocab_size=128, apply_rotary=True,
            layer_norm_type="rms", mlp_type="llama",
            use_attention_bias=False, use_attn_proj_bias=False,
            use_mlp_bias=False, activation_function="silu",
            compute_dtype="float32")
JAX_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops over several members crawl beside the other xdist
    workers' threads: one intra-op thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """Numpy weights of the JAX package's init and a batch of 4 streams
    of 40 tokens (records crossing the members' token shards, padding);
    40 is no multiple of 8 * t, so the port pads inside."""
    jcfg = JConfig(**TINY)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, size=(4, 40)).astype(np.int32)
    seg = np.ones_like(ids)
    seg[:, 13:29] = 2
    seg[1, 35:] = 0
    seg[3, 21:] = 3
    return jcfg, params, jax.tree.map(np.asarray, params), ids, seg


def _jax_logits(jcfg, params, ids, seg, dp, tp):
    par = JParallel(data_parallel_size=dp, tensor_parallel_size=tp,
                    sequence_parallel=True)
    mesh = jmake_mesh(par, devices=jax.devices("cpu")[:dp * tp])
    p = jax.device_put(params, jshard.param_shardings(jcfg, mesh))
    batch = NamedSharding(mesh, jshard.batch_pspec())
    constrain = jshard.activation_constraint(mesh, True)

    @jax.jit
    def fwd(p, i, s):
        h, _ = JT.forward(jcfg, p, i, s, activation_constraint=constrain)
        return JT.lm_logits(jcfg, p, h)

    return np.asarray(fwd(p, jax.device_put(jnp.asarray(ids), batch),
                          jax.device_put(jnp.asarray(seg), batch)))


def _port_logits(weights, ids, seg, layout):
    par = parse_parallelism(layout)
    eng = Engine(TransformerConfig(**TINY), weights, device="cpu",
                 parallel=par, devices=["cpu"] * par.world_size)
    with torch.no_grad():
        ids_t, seg_t = torch.as_tensor(ids), torch.as_tensor(seg)
        h, _ = T.forward(eng.cfg, eng.params, ids_t, seg_t)
        return T.lm_logits(eng.cfg, eng.params, h)


@pytest.mark.parametrize("dp", [1, 2])
def test_sp_forward_matches_jax_and_equals_no_sp(model, dp):
    jcfg, params, weights, ids, seg = model
    # the JAX batch must split over its data axis: the first 2 * dp rows
    rows = slice(0, 2 * dp)
    want = _jax_logits(jcfg, params, ids[rows], seg[rows], dp, 2)
    got = _port_logits(weights, ids[rows], seg[rows], f"d{dp}t2s")
    valid = seg[rows] != 0
    np.testing.assert_allclose(got.numpy()[valid], want[valid], **JAX_TOL)
    plain = _port_logits(weights, ids[rows], seg[rows], f"d{dp}t2")
    assert torch.equal(got[torch.as_tensor(valid)],
                       plain[torch.as_tensor(valid)])


def test_reduce_scatter_sums_in_member_order_and_slices():
    """Member j gets the j-th slice of ``reduce_sum``'s sum (bit-equal to
    the all-reduce's, then sliced), and its gradient is the all-gather of
    the slices' gradients."""
    rng = np.random.default_rng(1)
    xs = [torch.tensor(rng.standard_normal((2, 8, 3)), dtype=torch.float32,
                       requires_grad=True) for _ in range(4)]
    devs = [torch.device("cpu")] * 4
    outs = C.reduce_scatter(xs, devs, dim=1)
    full = C.all_reduce(xs, devs)[0]
    for j, o in enumerate(outs):
        assert torch.equal(o, full[:, 2 * j:2 * j + 2])
    g = [torch.full_like(o, float(j + 1)) for j, o in enumerate(outs)]
    torch.autograd.backward(outs, g)
    want = torch.cat(g, dim=1)
    for x in xs:
        assert torch.equal(x.grad, want)


@pytest.mark.parametrize("remat", [False, True])
def test_sp_train_step_matches_the_layout_without_s(model, remat):
    """One train step at d2t2s against d2t2 (the same tree split, the
    residual split once more along the tokens)."""
    _, _, weights, ids, seg = model
    cfg = dataclasses.replace(TransformerConfig(**TINY),
                              gradient_checkpointing=remat)
    opt = OptimizerConfig(lr=1e-3, warmup_steps_proportion=0.0)

    def loss_fn(p, mb):
        h, _ = T.forward(cfg, p, mb["input_ids"], mb["seg_ids"])
        return -F.shifted_logprobs_from_hidden(
            cfg, p, h, mb["input_ids"], mb["seg_ids"]).mean(), {}

    out = {}
    for layout in ("d2t2", "d2t2s"):
        eng = Engine(cfg, weights, device="cpu", optimizer=opt,
                     total_train_steps=2,
                     parallel=parse_parallelism(layout), devices=["cpu"] * 4)
        st = eng.train_batch([dict(input_ids=ids, seg_ids=seg)], loss_fn)
        out[layout] = (st, eng.params_numpy())
    (a, wa), (b, wb) = out["d2t2s"], out["d2t2"]
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)
    np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)
    for x, y in zip(jax.tree.leaves(wa), jax.tree.leaves(wb)):
        np.testing.assert_allclose(x, y, atol=1e-6)
