"""The port's ``Engine`` at pipeline layouts (``dNtMpP`` over ``[cpu] *
n``) against the JAX package's ``Engine`` at the same layout (on the
virtual CPU devices ``tests/conftest.py`` forces), and against the port
at d1t1.

Covered: train steps at p2, d1t2p2 and d2t1p2 under 1F1B and GPipe
against the JAX engine's (its 1F1B; its GPipe gives the same loss):
loss, grad norm and the updated params over two steps, one case with
clipping firing and ZeRO-1 over the data members; inference
(log-probs, values) at p2 and d2t2p2 against the JAX d1t1 engine's
``forward_logprobs`` (JAX's own inference forward at p > 1 raises on
jax 0.9, ``realhf_tpu/models/sharding.py:253``); a Gemma-style tied
embedding at p2 against the port's d1t1 (the two uses' gradients
summed); the optimizer state and HF save of a p2 / d2t1p2 engine
bit-equal to a d1t1 engine's in the same state, loaded back into a p2
role; ``reallocate`` d1t1 -> p2 -> d2t2 -> d1t2p2 -> d1t1 bit-equal;
offload; the
engine's pipeline contexts; and the layouts that still raise.

Tolerances: fp32 on the CPU on both sides, sums in different orders:
losses and grad norms 1e-5 relative, params after two AdamW steps at lr
1e-2 1e-5 absolute (as ``test_torch_tp_engine.py``), log-probs and
values 1e-4 absolute.
"""

import os

import jax
import numpy as np
import pytest
import torch

from realhf_tpu.api.config import ModelName
from realhf_tpu.engine.engine import Engine as JEngine
from realhf_tpu.engine.optim import OptimizerConfig as JOpt
from realhf_tpu.interfaces import sft as jsft
from realhf_tpu.models.config import TransformerConfig as JConfig
from realhf_tpu.parallel.mesh import MeshContext
from realhf_tpu.parallel.mesh import ParallelismConfig as JPar
from realhf_tpu.parallel.mesh import make_mesh as jmake_mesh
from realhf_tpu_torch.engine.engine import Engine
from realhf_tpu_torch.engine.optim import OptimizerConfig
from realhf_tpu_torch.interfaces import common, sft
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import MoEConfig, TransformerConfig
from realhf_tpu_torch.models.convert import params_numpy
from realhf_tpu_torch.models.hf import save_hf_checkpoint_streamed
from realhf_tpu_torch.parallel.mesh import (
    ParallelismConfig,
    parse_parallelism,
)

VOCAB = 107
TINY = dict(n_layers=2, n_kv_heads=4, n_q_heads=8, hidden_dim=64,
            intermediate_dim=96, vocab_size=VOCAB, apply_rotary=True,
            layer_norm_type="rms", mlp_type="llama",
            use_attention_bias=False, use_attn_proj_bias=False,
            use_mlp_bias=False, activation_function="silu",
            param_dtype="float32", compute_dtype="float32",
            gradient_checkpointing=True)
OPT = dict(lr=1e-2, lr_scheduler_type="constant", warmup_steps_proportion=0)
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its many small ops over
    several members run faster so, above all beside the other test
    workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_engine(cfg_kw, layout, params, opt=None):
    jp = parse_parallelism(layout)
    par = JPar(data_parallel_size=jp.data_parallel_size,
               tensor_parallel_size=jp.tensor_parallel_size,
               pipeline_parallel_size=jp.pipeline_parallel_size)
    ctx = MeshContext(ModelName("m", 0), jmake_mesh(
        par, jax.devices("cpu")[:par.world_size]), par)
    return JEngine(JConfig(**cfg_kw), ctx, params,
                   optimizer=None if opt is None else JOpt(**opt),
                   total_train_steps=10)


def _port(cfg_kw, layout, params, opt=None, schedule="1f1b"):
    par = parse_parallelism(layout)
    par = ParallelismConfig(**{**par.__dict__, "pipeline_schedule": schedule})
    return Engine(TransformerConfig(**cfg_kw), params, device="cpu",
                  parallel=par, devices=["cpu"] * par.world_size,
                  optimizer=None if opt is None else OptimizerConfig(**opt),
                  total_train_steps=10)


@pytest.fixture(scope="module")
def weights():
    cfg = TransformerConfig(**TINY)
    return params_numpy(T.init_params(cfg, torch.Generator().manual_seed(0)))


def _sft_microbatches(n_streams, seed=0):
    """Two microbatches of unequal answer-token counts, packed into
    ``n_streams`` streams."""
    rng = np.random.default_rng(seed)
    sbs = []
    for lens, plens in (([20, 13, 31, 9], [5, 9, 4, 2]),
                        ([17, 25, 6], [12, 20, 3])):
        ids = rng.integers(2, VOCAB, size=sum(lens)).astype(np.int32)
        pm = np.concatenate([np.arange(n) < p for n, p in zip(lens, plens)])
        sbs.append(common.build_stream_batch(
            lens, dict(input_ids=ids, prompt_mask=pm), bucket=16,
            n_streams=n_streams))
    sbs = common.pad_stream_batches(sbs)
    weights = [float((~b.arrays["prompt_mask"] & (b.arrays["seg_ids"] != 0))
                     .sum()) for b in sbs]
    return [b.arrays for b in sbs], weights


def _params_close(want_tree, eng, atol):
    want = dict(jax.tree_util.tree_leaves_with_path(want_tree))
    got = jax.tree_util.tree_leaves_with_path(eng.params_numpy())
    assert len(got) == len(want)
    for path, a in got:
        np.testing.assert_allclose(a, want[path], rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("layout,clip", [("p2", 1.0), ("d1t2p2", 1.0),
                                         ("d2t1p2", 0.05)])
def test_train_steps_match_jax_at_layout(weights, layout, clip):
    opt = dict(OPT, gradient_clipping=clip)
    jeng = _jax_engine(TINY, layout, weights, opt)
    engs = {s: _port(TINY, layout, weights, opt, s)
            for s in ("1f1b", "gpipe")}
    assert engs["1f1b"].pipeline_ctx.n_microbatches == 8
    assert engs["gpipe"].pipeline_ctx.n_microbatches == 4
    assert jeng.n_streams == engs["1f1b"].n_streams
    for _ in range(2):
        mbs, w = _sft_microbatches(jeng.n_streams)
        want = jeng.train_batch(mbs, jsft._make_loss_fn(jeng.cfg),
                                loss_weights=w, loss_fn_key="sft")
        for sched, eng in engs.items():
            # GPipe's streams: d * its own M, the same tokens
            m, wg = _sft_microbatches(eng.n_streams)
            got = eng.train_batch(m, sft._make_loss_fn(eng.cfg), wg)
            for k in ("loss", "grad_norm", "nll"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           err_msg=f"{sched} {k}")
            if clip < 1:
                assert got["grad_norm"] > 10 * clip  # clipping fired
    jw = jeng.params_numpy()
    for eng in engs.values():
        _params_close(jw, eng, atol=1e-5)
    if layout.startswith("d2"):  # ZeRO-1: each data member half a state
        assert engs["1f1b"]._zero1[0][0] is not None


CRITIC = dict(TINY, is_critic=True)


@pytest.fixture(scope="module")
def jax_inference(weights):
    """The JAX d1t1 engine's outputs on one batch: log-probs at
    temperature 1 and at 0.7 under a logits mask, hidden states, and a
    critic's values."""
    rng = np.random.default_rng(1)
    ids = rng.integers(0, VOCAB, size=(5, 24)).astype(np.int32)
    seg = np.ones((5, 24), np.int32)
    seg[0, 10:] = 2
    seg[4, 17:] = 0
    mask = rng.random((5, 24, VOCAB)) > 0.3
    mask[..., 0] = True
    jone = _jax_engine(TINY, "d1t1", weights)
    cw = params_numpy(T.init_params(TransformerConfig(**CRITIC),
                                    torch.Generator().manual_seed(2)))
    want = dict(
        lp=[np.asarray(jone.forward_logprobs(ids, seg, temperature=temp,
                                             logits_mask=m))
            for temp, m in ((1.0, None), (0.7, mask))],
        hidden=np.asarray(jone.forward_hidden(ids, seg)),
        values=np.asarray(_jax_engine(CRITIC, "d1t1", cw).forward_values(
            ids, seg)))
    return (ids, seg, mask, cw), want


@pytest.mark.parametrize("layout", ["p2", "d2t2p2"])
def test_inference_matches_jax_d1t1(weights, jax_inference, layout):
    (ids, seg, mask, cw), want = jax_inference
    eng = _port(TINY, layout, weights)
    assert eng.pipeline_ctx_infer.schedule == "gpipe"
    for (temp, m), w in zip(((1.0, None), (0.7, mask)), want["lp"]):
        np.testing.assert_allclose(
            eng.forward_logprobs(ids, seg, temperature=temp,
                                 logits_mask=m).numpy(), w,
            atol=ATOL, rtol=0)
    np.testing.assert_allclose(eng.forward_hidden(ids, seg).numpy(),
                               want["hidden"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        _port(CRITIC, layout, cw).forward_values(ids, seg).numpy(),
        want["values"], atol=ATOL, rtol=0)


def test_tied_embedding_at_p2_sums_both_uses():
    """A Gemma-style tied ``wte``: stage 0's copy takes the embedding's
    gradient, the last stage's the head's; summed over the stages they
    are d1t1's."""
    kw = dict(TINY, layer_norm_type="gemma", tied_embedding=True,
              normalize_embed=True, activation_function="gelu_new")
    cfg = TransformerConfig(**kw)
    w = params_numpy(T.init_params(cfg, torch.Generator().manual_seed(8)))
    one, eng = _port(kw, "d1t1", w, OPT), _port(kw, "p2", w, OPT)
    m1, w1 = _sft_microbatches(1, seed=5)
    m8, w8 = _sft_microbatches(eng.n_streams, seed=5)
    want = one.train_batch(m1, sft._make_loss_fn(cfg), w1)
    got = eng.train_batch(m8, sft._make_loss_fn(cfg), w8)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    _params_close(one.params_numpy(), eng, atol=1e-5)
    a, b = (tr["embed"]["wte"] for tr in eng.params.trees)
    assert torch.equal(a, b)  # both stages' copies took the same update


def _files(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def test_saves_at_p2_are_bit_equal_to_d1t1(tmp_path, weights):
    from realhf_tpu_torch.engine import opt_checkpoint
    one = _port(TINY, "d1t1", weights, OPT)
    mbs, w = _sft_microbatches(1)
    one.train_batch(mbs, sft._make_loss_fn(one.cfg), w)
    cfg = one.cfg
    d = str(tmp_path / "one")
    save_hf_checkpoint_streamed(d, "llama", cfg, one.params)
    opt_checkpoint.save_opt_state_iter(d, one.iter_opt_state_numpy())
    for layout in ("p2", "d2t1p2"):
        eng = _port(TINY, layout, one.params_numpy(), OPT)
        eng.load_opt_state(one.opt_state_numpy())
        assert [s for s, _ in eng.opt_state_spec()] == [
            s for s, _ in one.opt_state_spec()]
        d = str(tmp_path / layout)
        save_hf_checkpoint_streamed(d, "llama", cfg,
                                    eng.gathered_params("cpu"))
        opt_checkpoint.save_opt_state_iter(d, eng.iter_opt_state_numpy())
        assert _files(str(tmp_path / "one")) == _files(d), layout
    from realhf_tpu_torch.api.experiment import ModelSpec
    from realhf_tpu_torch.system.model_host import build_model
    back = build_model("m", ModelSpec(
        path=str(tmp_path / "p2"), bf16=False, gradient_checkpointing=True,
        optimizer=OptimizerConfig(**OPT), restore_optimizer_state=True,
        parallel=parse_parallelism("p2")), None, init_seed=1, device="cpu",
        total_steps=10).engine
    assert back.params.p == 2 and back.pipeline_ctx.schedule == "1f1b"
    for a, b in zip(jax.tree.leaves(back.params_numpy()),
                    jax.tree.leaves(one.params_numpy())):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(back.opt_state_numpy(), one.opt_state_numpy()):
        np.testing.assert_array_equal(a, b)


def test_reallocate_around_pipeline_layouts_is_bit_equal(weights):
    from realhf_tpu_torch.parallel.realloc import reallocate
    other = params_numpy(T.init_params(TransformerConfig(**TINY),
                                       torch.Generator().manual_seed(3)))
    src = _port(TINY, "d1t1", weights)
    for layout in ("p2", "d2t2", "d1t2p2", "d1t1"):
        dst = _port(TINY, layout, other)
        epoch = dst.params_epoch
        reallocate(src.cfg, src.params, dst)
        assert dst.params_epoch == epoch + 1
        for a, b in zip(jax.tree.leaves(dst.params_numpy()),
                        jax.tree.leaves(weights)):
            np.testing.assert_array_equal(a, b)
        src = dst


def test_offload_and_contexts_at_p2(weights):
    eng = _port(TINY, "d2t1p2", weights, OPT, schedule="gpipe")
    assert eng.pipeline_ctx.schedule == "gpipe"
    assert eng.n_streams == 2 * 4 and eng.params.pipeline is eng.pipeline_ctx
    assert [tr["blocks"]["ln1"]["scale"].shape[0]
            for tr in eng.params.trees] == [1] * 4
    before = eng.params_numpy()
    eng.offload()
    eng.ensure_on_device()
    for a, b in zip(jax.tree.leaves(before),
                    jax.tree.leaves(eng.params_numpy())):
        np.testing.assert_array_equal(a, b)
    par = ParallelismConfig(pipeline_parallel_size=2,
                            pipeline_microbatches=3)
    eng = Engine(TransformerConfig(**TINY), weights, device="cpu",
                 parallel=par, devices=["cpu"] * 2)
    assert eng.pipeline_ctx.n_microbatches == 3 and eng.n_streams == 3


def test_replicated_kv_heads_train_in_pipeline_stages_as_jax():
    """One KV head at t2p2: each stage's model members hold the KV
    weights whole and compute the one head (``member_views``); two 1F1B
    train steps against the JAX engine at the same layout."""
    kw = dict(TINY, n_kv_heads=1)
    w = params_numpy(T.init_params(TransformerConfig(**kw),
                                   torch.Generator().manual_seed(5)))
    jeng = _jax_engine(kw, "d1t2p2", w, OPT)
    eng = _port(kw, "d1t2p2", w, OPT)
    for _ in range(2):
        mbs, wt = _sft_microbatches(jeng.n_streams, seed=5)
        want = jeng.train_batch(mbs, jsft._make_loss_fn(jeng.cfg),
                                loss_weights=wt, loss_fn_key="sft")
        got = eng.train_batch(mbs, sft._make_loss_fn(eng.cfg), wt)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)
    _params_close(jeng.params_numpy(), eng, atol=1e-5)


def test_layouts_that_still_raise(weights):
    """Context with pipeline parallelism (JAX's refusal, with its
    message), layers the stages do not split, and a KV prefill on a
    pipeline layout. Sequence parallelism and MoE in pipeline stages
    build (below and ``test_torch_moe_pipeline.py``)."""
    with pytest.raises(ValueError, match="not divisible"):
        _port(dict(TINY, n_layers=3), "p2", None)
    with pytest.raises(NotImplementedError, match="cannot be combined with "
                       "context parallelism"):
        _port(TINY, "p2c2", weights)
    moe = dict(TINY, mlp_type="moe", moe=MoEConfig(num_experts=4, top_k=2))
    cfg = TransformerConfig(**moe)
    w = params_numpy(T.init_params(cfg, torch.Generator().manual_seed(9)))
    for layout in ("t2p2s", "d1t2p2"):
        assert _port(moe if layout == "d1t2p2" else TINY, layout,
                     w if layout == "d1t2p2" else weights).params.p == 2
    eng = _port(moe, "d2t1p2", w, OPT)
    with pytest.raises(ValueError, match="decode view"):
        T.prefill(cfg, eng.params, torch.zeros((2, 4), dtype=torch.int32),
                  torch.ones((2, 4), dtype=torch.int32))


def _jax_sp_engine(layout, params, opt):
    """The JAX engine at ``layout`` with its sequence-parallel flag."""
    jp = parse_parallelism(layout)
    par = JPar(data_parallel_size=jp.data_parallel_size,
               tensor_parallel_size=jp.tensor_parallel_size,
               pipeline_parallel_size=jp.pipeline_parallel_size,
               sequence_parallel=jp.sequence_parallel)
    ctx = MeshContext(ModelName("m", 0), jmake_mesh(
        par, jax.devices("cpu")[:par.world_size]), par)
    return JEngine(JConfig(**TINY), ctx, params, optimizer=JOpt(**opt),
                   total_train_steps=10)


@pytest.mark.parametrize("layout", ["d1t2p2s", "d2t2p2s"])
def test_sequence_parallel_with_pipeline_trains_as_jax(weights, layout):
    """Two 1F1B steps at t2p2s / d2t2p2s against the JAX engine at the
    same layout (``s`` is a sharding constraint there, so it moves no
    number), the boundary passing each member's token shard."""
    eng = _port(TINY, layout, weights, OPT)
    assert eng.params.sp and eng.params.p == 2
    jeng = _jax_sp_engine(layout, weights, OPT)
    for _ in range(2):
        mbs, w = _sft_microbatches(jeng.n_streams)
        want = jeng.train_batch(mbs, jsft._make_loss_fn(jeng.cfg),
                                loss_weights=w, loss_fn_key="sft")
        got = eng.train_batch(mbs, sft._make_loss_fn(eng.cfg), w)
        for k in ("loss", "grad_norm", "nll"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)
    _params_close(jeng.params_numpy(), eng, atol=1e-5)


@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
def test_sequence_parallel_with_pipeline_forward_is_bit_equal(weights,
                                                              sched):
    """t2p2s against t2p2 (both on fp32 CPU members): hidden states and
    log-probs of the real tokens bit for bit, over streams of 24 tokens
    (padded to a multiple of 8t under ``s``), under each schedule's
    forward. (A padding token's hidden state is no output: ``s`` gives
    it another value, as at d1t2s.)"""
    rng = np.random.default_rng(1)
    ids = rng.integers(0, VOCAB, size=(5, 24)).astype(np.int32)
    seg = np.ones((5, 24), np.int32)
    seg[0, 10:] = 2
    seg[4, 17:] = 0
    with_s, without = (_port(TINY, lay, weights, schedule=sched)
                       for lay in ("t2p2s", "t2p2"))
    real = torch.from_numpy(seg != 0)
    assert torch.equal(with_s.forward_hidden(ids, seg)[real],
                       without.forward_hidden(ids, seg)[real])
    assert torch.equal(with_s.forward_logprobs(ids, seg)[real],
                       without.forward_logprobs(ids, seg)[real])
