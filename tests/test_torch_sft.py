"""One SFT optimizer step of the port's ``Engine.train_batch`` against the
JAX package's on the same weights (carried with ``params_from_numpy``)
and the same two microbatches of unequal answer-token counts: loss,
grad norm, stats and every updated leaf; then a 3-step trajectory; the
reserved ``__skip_update__`` stat; gradient checkpointing; the
minibatch split and stream packing; and the options this slice leaves
for later.

Tolerances: fp32 on the CPU on both sides, sums in different orders.
Losses of order 5 agree to ~1e-6 relative. After one AdamW step (lr
1e-2) a param moves by ~lr * g / (|g| + eps) per element, so a relative
gradient difference of ~1e-5 moves it by ~1e-7: 1e-5 absolute after one
step, 5e-5 after three.
"""

import jax
import numpy as np
import pytest
import torch

from realhf_tpu.api.config import ModelName
from realhf_tpu.engine.engine import Engine as JEngine
from realhf_tpu.engine.optim import OptimizerConfig as JOpt
from realhf_tpu.interfaces import sft as jsft
from realhf_tpu.models import transformer as JT
from realhf_tpu.models.config import TransformerConfig as JConfig
from realhf_tpu.parallel.mesh import (
    MeshContext,
    ParallelismConfig,
    default_devices,
    make_mesh,
)
from realhf_tpu_torch.engine.engine import Engine
from realhf_tpu_torch.engine.optim import OptimizerConfig
from realhf_tpu_torch.interfaces import common
from realhf_tpu_torch.interfaces import sft
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.models.convert import params_numpy

TINY = dict(n_layers=2, n_kv_heads=2, n_q_heads=4, hidden_dim=32,
            intermediate_dim=64, vocab_size=97, apply_rotary=True,
            layer_norm_type="rms", mlp_type="llama",
            use_attention_bias=False, use_attn_proj_bias=False,
            use_mlp_bias=False, activation_function="silu",
            param_dtype="float32", compute_dtype="float32",
            gradient_checkpointing=True)
OPT = dict(lr=1e-2, lr_scheduler_type="cosine", warmup_steps_proportion=0.2)


def _microbatches(seed=0):
    """Two packed microbatches (3 and 2 sequences) with different
    prompt shares, padded to one shape, and their answer counts."""
    rng = np.random.default_rng(seed)
    sbs = []
    for lens, plens in (([20, 13, 31], [5, 9, 4]), ([17, 25], [12, 20])):
        ids = rng.integers(2, 97, size=sum(lens)).astype(np.int32)
        pm = np.concatenate([np.arange(n) < p for n, p in zip(lens, plens)])
        sbs.append(common.build_stream_batch(
            lens, dict(input_ids=ids, prompt_mask=pm), bucket=16))
    sbs = common.pad_stream_batches(sbs)
    weights = [float((~b.arrays["prompt_mask"] & (b.arrays["seg_ids"] != 0))
                     .sum()) for b in sbs]
    assert weights[0] != weights[1]
    return [b.arrays for b in sbs], weights


def _engines(total=10):
    jcfg = JConfig(**TINY)
    parallel = ParallelismConfig()
    mesh = make_mesh(parallel, devices=default_devices()[:1])
    ctx = MeshContext(ModelName("sft", 0), mesh, parallel)
    jeng = JEngine(jcfg, ctx, JT.init_params(jcfg, jax.random.PRNGKey(0)),
                   optimizer=JOpt(**OPT), total_train_steps=total)
    eng = Engine(TransformerConfig(**TINY), jeng.params_numpy(), device="cpu",
                 optimizer=OptimizerConfig(**OPT), total_train_steps=total)
    return jeng, eng


def _port_params():
    """Weights for the port-only tests (no JAX engine to build)."""
    cfg = TransformerConfig(**TINY)
    return params_numpy(T.init_params(cfg, torch.Generator().manual_seed(0)))


def _train(jeng, eng, mbs, weights):
    want = jeng.train_batch(mbs, jsft._make_loss_fn(jeng.cfg),
                            loss_weights=weights, loss_fn_key="sft")
    got = eng.train_batch(mbs, sft._make_loss_fn(eng.cfg),
                          loss_weights=weights)
    return want, got


def _assert_params_close(jeng, eng, atol):
    want = jax.tree_util.tree_leaves_with_path(jeng.params_numpy())
    got = dict(jax.tree_util.tree_leaves_with_path(eng.params_numpy()))
    for path, a in want:
        np.testing.assert_allclose(got[path], a, rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def test_one_step_matches_jax_engine():
    jeng, eng = _engines()
    mbs, weights = _microbatches()
    before = eng.params_numpy()
    # warmup int(0.2 * 10) = 2 steps: the first step has lr 0, so also
    # take a second step, which moves the params
    for _ in range(2):
        want, got = _train(jeng, eng, mbs, weights)
        assert set(got) == set(want) == {"loss", "grad_norm", "nll",
                                         "n_tokens"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    _assert_params_close(jeng, eng, atol=1e-5)
    moved = jax.tree.map(lambda a, b: np.abs(a - b).max(), before,
                         eng.params_numpy())
    assert min(jax.tree.leaves(moved)) > 0
    assert eng.version == 2


def test_three_step_trajectory_matches_jax_engine():
    jeng, eng = _engines(total=3)
    mbs, weights = _microbatches(seed=1)
    losses = []
    for _ in range(3):
        want, got = _train(jeng, eng, mbs, weights)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-4)
        losses.append(got["loss"])
    assert losses[2] < losses[1]
    _assert_params_close(jeng, eng, atol=5e-5)


def test_skip_update_leaves_params_and_optimizer_state():
    eng = Engine(TransformerConfig(**TINY), _port_params(), device="cpu",
                 optimizer=OptimizerConfig(lr=1e-2))
    mbs, weights = _microbatches()
    loss_fn = sft._make_loss_fn(eng.cfg)

    def with_skip(flag):
        def fn(params, mb):
            loss, st = loss_fn(params, mb)
            return loss, dict(st, __skip_update__=torch.tensor(flag))
        return fn

    before = eng.params_numpy()
    out = eng.train_batch(mbs, with_skip(1.0), loss_weights=weights)
    assert out["early_stop_skipped"] == 1.0 and "__skip_update__" not in out
    jax.tree.map(np.testing.assert_array_equal, eng.params_numpy(), before)
    assert eng.optimizer.count == 0
    assert all(not m.any() and not v.any()
               for m, v in zip(eng.optimizer.m, eng.optimizer.v))
    out = eng.train_batch(mbs, with_skip(0.0), loss_weights=weights)
    assert out["early_stop_skipped"] == 0.0 and eng.optimizer.count == 1


def test_gradient_checkpointing_gives_the_same_gradients():
    mbs, _ = _microbatches()
    params = _port_params()
    grads = []
    for remat in (True, False):
        cfg = TransformerConfig(**dict(TINY, gradient_checkpointing=remat))
        eng = Engine(cfg, params, device="cpu")
        leaves = jax.tree.leaves(eng.params)
        for p in leaves:
            p.requires_grad_(True)
        batch = {k: torch.from_numpy(v) for k, v in mbs[0].items()}
        sft._make_loss_fn(cfg)(eng.params, batch)[0].backward()
        grads.append([p.grad.numpy() for p in leaves])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_minibatch_split_and_stream_packing_match_jax():
    """``SequenceSample.split`` (balanced contiguous partition) and the
    stream packing of the interfaces, shifted keys included, give the
    JAX package's arrays exactly."""
    from realhf_tpu.api.data import SequenceSample as JSample
    from realhf_tpu.interfaces import common as jcommon
    from realhf_tpu_torch.api.data import SequenceSample
    rng = np.random.default_rng(7)
    lens = [int(x) for x in rng.integers(3, 40, size=9)]
    data = dict(packed_input_ids=rng.integers(0, 97, sum(lens))
                .astype(np.int32),
                prompt_mask=rng.random(sum(lens)) > 0.5)
    got_mbs = common.split_minibatches(
        SequenceSample.from_default(lens, list(range(9)), dict(data)), 3)
    want_mbs = jcommon.split_minibatches(
        JSample.from_default(lens, list(range(9)), dict(data)), 3)
    assert [m.ids for m in got_mbs] == [m.ids for m in want_mbs]
    sbs = []
    for c, mods in ((common, got_mbs), (jcommon, want_mbs)):
        built = []
        for mb in mods:
            ln = c.flat_seqlens(mb)
            n = sum(ln)
            built.append(c.build_stream_batch(
                ln, dict(input_ids=mb.data["packed_input_ids"]),
                shifted_keys=dict(lp=np.arange(n - len(ln), dtype=np.float32)),
                n_streams=2, bucket=16))
        sbs.append(c.pad_stream_batches(built))
    for got, want in zip(*sbs):
        assert got.n_tokens == want.n_tokens
        assert set(got.arrays) == set(want.arrays) == {"seg_ids",
                                                      "input_ids", "lp"}
        for k in want.arrays:
            np.testing.assert_array_equal(got.arrays[k], want.arrays[k])


def test_options_of_later_slices_raise():
    cfg = TransformerConfig(**TINY)
    params = _port_params()
    for kw in (dict(offload=True), dict(zero1=True)):
        with pytest.raises(NotImplementedError):
            Engine(cfg, params, device="cpu", optimizer=OptimizerConfig(**kw))
    eng = Engine(cfg, params, device="cpu")
    with pytest.raises(RuntimeError, match="no optimizer"):
        eng.train_batch(_microbatches()[0], sft._make_loss_fn(cfg))
    with pytest.raises(NotImplementedError, match="PPO"):
        Engine(cfg, params, device="cpu",
               optimizer=OptimizerConfig()).train_minibatches([], None)


def test_sft_interface_rejects_unknown_arguments():
    from realhf_tpu_torch.api.config import ModelInterfaceAbstraction
    from realhf_tpu_torch.api.model import make_interface
    assert isinstance(make_interface(ModelInterfaceAbstraction("sft")),
                      sft.SFTInterface)
    with pytest.raises(TypeError):
        make_interface(ModelInterfaceAbstraction(
            "sft", args={"token_normalize_scope": "global"}))
