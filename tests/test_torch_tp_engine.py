"""The port's ``Engine`` at data- and tensor-parallel layouts against the
JAX package's ``Engine`` at the same layout (on the virtual CPU devices
``tests/conftest.py`` forces), and against the port at d1t1.

The port's members are ``["cpu"] * (d * t)``. The same numpy weights and
inputs go through both packages; the vocabulary is prime (107), so the
head and ``wte`` are padded at t = 2 and 4. Covered: logits, log-probs
(with and without a logits mask and a temperature), entropy and critic
values at (d, t) in {(2,1), (1,2), (2,2), (1,4)}; greedy generation at
d2t2 and a sampled batch at d2t1 against d1t1; ``train_batch`` and
``train_minibatches`` at d2t2, with and without ZeRO-1, on streams of
unequal token counts, one case with clipping firing; the optimizer
state and HF saves of a d2t2 engine bit-equal to a d1t1 engine's in the
same state, and loaded back into a d2t2 role; offload; a GPT-2- and a
Gemma-style model at d2t2 against the port's d1t1; MoE inference at
d2t1; and the layouts that still raise.

Tolerances: fp32 on the CPU on both sides, sums in different orders.
Logits, log-probs, values and entropy: 1e-4 absolute. Losses and grad
norms: 1e-5 relative. Params after two AdamW steps at lr 1e-2: 1e-5
absolute (an element moves by ~lr, a relative gradient difference of
1e-5 moves it by ~1e-7).
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
from realhf_tpu.models import transformer as JT
from realhf_tpu.models.config import TransformerConfig as JConfig
from realhf_tpu.ops.sampling import GenerationHyperparameters as JGen
from realhf_tpu.parallel.mesh import MeshContext
from realhf_tpu.parallel.mesh import ParallelismConfig as JPar
from realhf_tpu.parallel.mesh import make_mesh as jmake_mesh
from realhf_tpu_torch.base import seeding
from realhf_tpu_torch.engine import packing
from realhf_tpu_torch.engine.engine import Engine
from realhf_tpu_torch.engine.optim import OptimizerConfig
from realhf_tpu_torch.interfaces import common, sft
from realhf_tpu_torch.models import sharding
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import MoEConfig, TransformerConfig
from realhf_tpu_torch.models.convert import params_numpy
from realhf_tpu_torch.models.hf import save_hf_checkpoint_streamed
from realhf_tpu_torch.ops import functional as F
from realhf_tpu_torch.ops.sampling import GenerationHyperparameters
from realhf_tpu_torch.parallel.mesh import ParallelismConfig

VOCAB = 107
TINY = dict(n_layers=2, n_kv_heads=4, n_q_heads=8, hidden_dim=64,
            intermediate_dim=96, vocab_size=VOCAB, apply_rotary=True,
            layer_norm_type="rms", mlp_type="llama",
            use_attention_bias=False, use_attn_proj_bias=False,
            use_mlp_bias=False, activation_function="silu",
            param_dtype="float32", compute_dtype="float32",
            gradient_checkpointing=True)
OPT = dict(lr=1e-2, lr_scheduler_type="constant", warmup_steps_proportion=0)
LAYOUTS = [(2, 1), (1, 2), (2, 2), (1, 4)]
ATOL = 1e-4


def _jax_engine(cfg_kw, d, t, params=None, opt=None, seed=0):
    jcfg = JConfig(**cfg_kw)
    par = JPar(data_parallel_size=d, tensor_parallel_size=t)
    ctx = MeshContext(ModelName("m", 0),
                      jmake_mesh(par, jax.devices("cpu")[:d * t]), par)
    if params is None:
        params = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return JEngine(jcfg, ctx, params,
                   optimizer=None if opt is None else JOpt(**opt),
                   total_train_steps=10)


def _port(cfg_kw, d, t, params, opt=None):
    par = ParallelismConfig(data_parallel_size=d, tensor_parallel_size=t)
    return Engine(TransformerConfig(**cfg_kw), params, device="cpu",
                  parallel=par, devices=["cpu"] * (d * t),
                  optimizer=None if opt is None else OptimizerConfig(**opt),
                  total_train_steps=10)


def _batch(seed=0, s=4, l=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, size=(s, l)).astype(np.int32)
    seg = np.ones((s, l), np.int32)
    seg[0, 10:] = 2
    seg[s - 1, l - 7:] = 0   # padding
    mask = rng.random((s, l, VOCAB)) > 0.3
    mask[..., 0] = True
    return ids, seg, mask


@pytest.fixture(scope="module")
def jax_one():
    return _jax_engine(TINY, 1, 1)


@pytest.mark.parametrize("d,t", LAYOUTS)
def test_forwards_match_jax_at_layout(jax_one, d, t):
    w = jax_one.params_numpy()
    jeng = _jax_engine(TINY, d, t, params=w)
    eng = _port(TINY, d, t, w)
    assert eng.n_streams == d and len(eng.params.trees) == d * t
    ids, seg, mask = _batch()
    tid, tseg = torch.from_numpy(ids), torch.from_numpy(seg)
    h, _ = T.forward(eng.cfg, eng.params, tid, tseg)
    logits = T.lm_logits(eng.cfg, eng.params, h)
    jh = jeng.forward_hidden(ids, seg)
    want = np.asarray(JT.lm_logits(jeng.cfg, jeng.params, jh))
    assert logits.shape == (4, 24, VOCAB)
    np.testing.assert_allclose(logits.numpy(), want, atol=ATOL, rtol=0)
    for temp, m in ((1.0, None), (0.7, mask)):
        got = eng.forward_logprobs(ids, seg, temperature=temp, logits_mask=m)
        exp = np.asarray(jeng.forward_logprobs(ids, seg, temperature=temp,
                                               logits_mask=m))
        np.testing.assert_allclose(got.numpy(), exp, atol=ATOL, rtol=0)
    one = _port(TINY, 1, 1, w)
    ent = F.entropy_from_hidden(eng.cfg, eng.params, h, temperature=0.7)
    h1, _ = T.forward(one.cfg, one.params, tid, tseg)
    np.testing.assert_allclose(
        ent.numpy(), F.entropy_from_hidden(one.cfg, one.params, h1,
                                           temperature=0.7).numpy(),
        atol=ATOL, rtol=0)
    np.testing.assert_allclose(eng.forward_hidden(ids, seg).numpy(),
                               np.asarray(jh), atol=ATOL, rtol=0)


@pytest.mark.parametrize("d,t", [(2, 2), (1, 4)])
def test_critic_values_match_jax_at_layout(d, t):
    kw = dict(TINY, is_critic=True)
    jone = _jax_engine(kw, 1, 1, seed=4)
    w = jone.params_numpy()
    eng, jeng = _port(kw, d, t, w), _jax_engine(kw, d, t, params=w)
    ids, seg, _ = _batch(1)
    np.testing.assert_allclose(
        eng.forward_values(ids, seg).numpy(),
        np.asarray(jeng.forward_values(ids, seg)), atol=ATOL, rtol=0)


def _prompts():
    rng = np.random.default_rng(7)
    return packing.left_padded_prompts(
        [rng.integers(2, VOCAB, size=int(n)).astype(np.int32)
         for n in (3, 9, 5, 6, 4)], pad_id=0)


def test_greedy_generation_at_d2t2_matches_jax_and_d1t1(jax_one):
    w = jax_one.params_numpy()
    ids, seg, pos = _prompts()
    gc = dict(max_new_tokens=8, greedy=True)
    want = jax.device_get(_jax_engine(TINY, 2, 2, params=w).generate(
        ids, seg, pos, jax.random.PRNGKey(0), JGen(**gc), None, 0))
    one = _port(TINY, 1, 1, w).generate(
        ids, seg, pos, None, GenerationHyperparameters(**gc), None, 0)
    eng = _port(TINY, 2, 2, w)
    got = eng.generate(ids, seg, pos, None, GenerationHyperparameters(**gc),
                       None, 0)
    # five streams over two data groups: an uneven 3 + 2 split
    assert T.data_rows(5, 2) == [(0, 3), (3, 5)]
    for ref in (want, one):
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(ref.tokens))
        np.testing.assert_allclose(got.logprobs.numpy(),
                                   np.asarray(ref.logprobs), atol=ATOL)
    assert bool(got.logits_mask.all())


def test_sampled_generation_at_d2t1_draws_as_d1t1(jax_one):
    w = jax_one.params_numpy()
    ids, seg, pos = _prompts()
    gc = GenerationHyperparameters(max_new_tokens=8, greedy=False, top_k=20,
                                   top_p=0.9, temperature=0.8)
    outs = [_port(TINY, d, t, w).generate(ids, seg, pos,
                                          seeding.generator(5), gc, 3, 0)
            for d, t in ((1, 1), (2, 1), (2, 2))]
    for o in outs[1:]:
        np.testing.assert_array_equal(o.tokens.numpy(),
                                      outs[0].tokens.numpy())
        np.testing.assert_array_equal(o.logits_mask.numpy(),
                                      outs[0].logits_mask.numpy())
        np.testing.assert_allclose(o.logprobs.numpy(),
                                   outs[0].logprobs.numpy(), atol=ATOL)


def _sft_microbatches(n_streams, seed=0):
    """Two microbatches of unequal answer-token counts, packed into
    ``n_streams`` streams of unequal token counts."""
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
    seg = sbs[0].arrays["seg_ids"]
    assert n_streams == 1 or (seg != 0).sum(1)[0] != (seg != 0).sum(1)[-1]
    return [b.arrays for b in sbs], weights


def _params_close(jeng, eng, atol):
    want = dict(jax.tree_util.tree_leaves_with_path(jeng.params_numpy()))
    got = jax.tree_util.tree_leaves_with_path(eng.params_numpy())
    assert len(got) == len(want)
    for path, a in got:
        np.testing.assert_allclose(a, want[path], rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("zero1,clip", [(True, 1.0), (False, 1.0),
                                        (True, 0.05)])
def test_train_batch_at_d2t2_matches_jax(jax_one, zero1, clip):
    w = jax_one.params_numpy()
    opt = dict(OPT, zero1=zero1, gradient_clipping=clip)
    jeng = _jax_engine(TINY, 2, 2, params=w, opt=opt)
    eng = _port(TINY, 2, 2, w, opt=opt)
    if zero1:  # every member holds half of each wq's state
        assert eng._zero1[0][0] is not None
    mbs, weights = _sft_microbatches(2)
    for _ in range(2):
        want = jeng.train_batch(mbs, jsft._make_loss_fn(jeng.cfg),
                                loss_weights=weights, loss_fn_key="sft")
        got = eng.train_batch(mbs, sft._make_loss_fn(eng.cfg),
                              loss_weights=weights)
        for k in ("loss", "grad_norm", "nll"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        if clip < 1:
            assert got["grad_norm"] > 10 * clip  # clipping fired
    _params_close(jeng, eng, atol=1e-5)
    # every data member of a model index holds the same shard
    for a, b in zip(eng.params.trees[:2], eng.params.trees[2:]):
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            assert torch.equal(x, y)


def test_train_minibatches_at_d2t2_matches_jax(jax_one):
    w = jax_one.params_numpy()
    jeng = _jax_engine(TINY, 2, 2, params=w, opt=OPT)
    eng = _port(TINY, 2, 2, w, opt=OPT)
    one = _port(TINY, 1, 1, w, opt=OPT)
    mbs, weights = _sft_microbatches(2, seed=3)
    mb2, w2 = _sft_microbatches(2, seed=4)
    s = [[mbs[0]], [mb2[1]]]
    ws = [[weights[0]], [w2[1]]]
    want = jeng.train_minibatches(s, jsft._make_loss_fn(jeng.cfg), ws, "sft")
    got = eng.train_minibatches(s, sft._make_loss_fn(eng.cfg), ws)
    ref = one.train_minibatches(s, sft._make_loss_fn(one.cfg), ws)
    for g, wnt, r in zip(got, want, ref):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], wnt[k], rtol=1e-5, err_msg=k)
            np.testing.assert_allclose(g[k], r[k], rtol=1e-5, err_msg=k)
    _params_close(jeng, eng, atol=1e-5)
    assert eng.version == 2
    # the canonical optimizer state is the d1t1 engine's, to the
    # rounding of the summed gradients
    got_st, ref_st = eng.opt_state_numpy(), one.opt_state_numpy()
    assert [x.shape for x in got_st] == [x.shape for x in ref_st]
    assert [x.shape for x in got_st] == [s for s, _ in eng.opt_state_spec()]
    for a, b in zip(got_st, ref_st):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)


def _files(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def test_saves_at_d2t2_are_bit_equal_to_d1t1(tmp_path, jax_one):
    from realhf_tpu_torch.engine import opt_checkpoint
    w = jax_one.params_numpy()
    one = _port(TINY, 1, 1, w, opt=OPT)
    mbs, weights = _sft_microbatches(1)
    one.train_batch(mbs, sft._make_loss_fn(one.cfg), weights)
    eng = _port(TINY, 2, 2, one.params_numpy(), opt=OPT)
    eng.load_opt_state(one.opt_state_numpy())
    cfg = one.cfg
    for name, e in (("one", one), ("dt", eng)):
        d = str(tmp_path / name)
        save_hf_checkpoint_streamed(
            d, "llama", cfg, e.gathered_params("cpu") if e.sharded
            else e.params)
        opt_checkpoint.save_opt_state_iter(d, e.iter_opt_state_numpy())
    assert _files(str(tmp_path / "one")) == _files(str(tmp_path / "dt"))
    # the model host loads the save into a d2t2 role by sharding, its
    # optimizer state too
    from realhf_tpu_torch.api.experiment import ModelSpec
    from realhf_tpu_torch.system.model_host import build_model
    back = build_model("m", ModelSpec(
        path=str(tmp_path / "dt"), bf16=False, gradient_checkpointing=True,
        optimizer=OptimizerConfig(**OPT), restore_optimizer_state=True,
        parallel=ParallelismConfig(data_parallel_size=2,
                                   tensor_parallel_size=2)), None,
        init_seed=1, device="cpu", total_steps=10).engine
    assert back.sharded and len(back.params.trees) == 4
    for a, b in zip(jax.tree.leaves(back.params_numpy()),
                    jax.tree.leaves(one.params_numpy())):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(back.opt_state_numpy(), one.opt_state_numpy()):
        np.testing.assert_array_equal(a, b)
    assert opt_checkpoint.restore_engine_opt_state(back, str(tmp_path / "dt"))


def test_offload_moves_every_member_and_keeps_bits(jax_one):
    w = jax_one.params_numpy()
    eng = _port(TINY, 2, 2, w, opt=OPT)
    before = eng.params_numpy()
    eng.offload()  # on the CPU only the flags move
    assert eng.offloaded
    eng.ensure_on_device()
    for a, b in zip(jax.tree.leaves(before),
                    jax.tree.leaves(eng.params_numpy())):
        np.testing.assert_array_equal(a, b)


def test_layouts_of_later_parts_raise(jax_one):
    w = jax_one.params_numpy()
    # t not dividing the KV heads, and MoE at t > 1, infer as d1t1 (held
    # against the JAX engine by test_torch_kv_replicated.py and
    # test_torch_moe_parallel.py)
    moe = dict(TINY, mlp_type="moe", moe=MoEConfig(num_experts=4, top_k=2))
    ids, seg, _ = _batch(8)
    for kw, t in ((dict(TINY, n_kv_heads=2), 4), (moe, 2)):
        wk = params_numpy(T.init_params(TransformerConfig(**kw),
                                        torch.Generator().manual_seed(3)))
        np.testing.assert_allclose(
            _port(kw, 1, t, wk).forward_logprobs(ids, seg).numpy(),
            _port(kw, 1, 1, wk).forward_logprobs(ids, seg).numpy(),
            atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="parts of two KV heads"):
        _port(dict(TINY, n_kv_heads=3, n_q_heads=12, hidden_dim=96), 1, 4,
              None)
    # sequence parallelism with pipeline parallelism builds now (held
    # against the JAX engine by test_torch_pp_engine.py)
    sp_pp = Engine(TransformerConfig(**TINY), w, device="cpu",
                   parallel=ParallelismConfig(tensor_parallel_size=2,
                                              pipeline_parallel_size=2,
                                              sequence_parallel=True),
                   devices=["cpu"] * 4)
    assert sp_pp.params.sp and sp_pp.params.p == 2
    # the serving engine runs over members (held against the JAX
    # generator on the mesh by test_torch_serving_members.py): it builds
    # at d1t2 and one decode chunk steps both slots
    from realhf_tpu_torch.engine.inflight import InflightBatchingGenerator
    eng = _port(TINY, 1, 2, w)
    gen = InflightBatchingGenerator(
        eng.cfg, eng.params, GenerationHyperparameters(
            max_new_tokens=4, greedy=True, force_no_logits_mask=True),
        n_slots=2, max_prompt_len=8, eos_token_id=None, pad_token_id=0,
        chunk_size=2, device="cpu")
    for slot in range(2):
        gen.fill_slot(slot, slot, ids[slot, :6])
    gen.decode_chunk()
    assert gen.counts == dict(decode_steps=2, full_prefills=2,
                              suffix_prefills=0)
    assert [len(gen.snapshot_slot(s)[0]) for s in range(2)] == [2, 2]
    assert sharding.padded_vocab_size(eng.cfg, 2) == 108
    from realhf_tpu_torch.ops.attention import member_heads
    assert member_heads(8, 4, 2, 1) == ((4, 8), (2, 4))
    assert member_heads(8, 4, 4, 3) == ((6, 8), (3, 4))


FAMILY_CFGS = {
    # biases, LayerNorm, a position table, gelu: bo / bd added after
    # the row-parallel sums, wpe after the vocab-parallel embedding
    "gpt2": dict(TINY, apply_rotary=False, layer_norm_type=None,
                 mlp_type=None, use_attention_bias=True,
                 use_attn_proj_bias=True, use_mlp_bias=True,
                 activation_function="gelu_new", n_positions=64),
    # a tied head: the LM head is the vocab-split wte transposed
    "gemma": dict(TINY, layer_norm_type="gemma", tied_embedding=True,
                  normalize_embed=True, activation_function="gelu_new"),
}


@pytest.mark.parametrize("family", sorted(FAMILY_CFGS))
def test_other_families_at_d2t2_match_d1t1(family):
    """A forward and one train step of a GPT-2- and a Gemma-style model
    at d2t2 against the port at d1t1 (the JAX package's same layouts
    are held by the llama tests above)."""
    kw = FAMILY_CFGS[family]
    cfg = TransformerConfig(**kw)
    w = params_numpy(T.init_params(cfg, torch.Generator().manual_seed(8)))
    one, eng = _port(kw, 1, 1, w, opt=OPT), _port(kw, 2, 2, w, opt=OPT)
    ids, seg, mask = _batch(2)
    np.testing.assert_allclose(
        eng.forward_logprobs(ids, seg, logits_mask=mask).numpy(),
        one.forward_logprobs(ids, seg, logits_mask=mask).numpy(),
        atol=ATOL, rtol=0)
    mbs, weights = _sft_microbatches(2, seed=5)
    got = eng.train_batch(mbs, sft._make_loss_fn(cfg), weights)
    mbs1, _ = _sft_microbatches(1, seed=5)
    want = one.train_batch(mbs1, sft._make_loss_fn(cfg), weights)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    for a, b in zip(jax.tree.leaves(eng.params_numpy()),
                    jax.tree.leaves(one.params_numpy())):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_moe_at_d2t1_infers_as_d1t1_and_refuses_training():
    """MoE at d2t1 infers as d1t1, and (no longer refused) trains as
    d1t1: the router losses come from both data shards' sums."""
    kw = dict(TINY, mlp_type="moe", moe=MoEConfig(num_experts=4, top_k=2))
    cfg = TransformerConfig(**kw)
    w = params_numpy(T.init_params(cfg, torch.Generator().manual_seed(9)))
    one, eng = _port(kw, 1, 1, w, opt=OPT), _port(kw, 2, 1, w, opt=OPT)
    ids, seg, _ = _batch(3)
    np.testing.assert_allclose(eng.forward_logprobs(ids, seg).numpy(),
                               one.forward_logprobs(ids, seg).numpy(),
                               atol=ATOL, rtol=0)
    mbs, weights = _sft_microbatches(2)
    mbs1, _ = _sft_microbatches(1)
    got = eng.train_batch(mbs, sft._make_loss_fn(cfg), weights)
    want = one.train_batch(mbs1, sft._make_loss_fn(cfg), weights)
    for k in ("loss", "grad_norm", "moe_aux_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_kernel_launches_run_on_their_tensors_device(monkeypatch):
    """A ctypes launch goes to the current device's context, so the K4
    and K1 wrappers make their tensors' device current first (members
    of a layout may sit on other cards than the caller's current one);
    driven on CPU tensors that say they are on the card."""
    from realhf_tpu_torch.ops import _build
    from realhf_tpu_torch.ops import decode_attention as da
    from realhf_tpu_torch.ops import flash_attention as fa
    from test_torch_decode_split import _stub, make_case
    seen = []
    real = _build.on_device

    def recording(device):
        seen.append(device)
        return real(device)

    monkeypatch.setattr(_build, "on_device", recording)
    monkeypatch.setattr(da, "_kernel", lambda: lambda *a: 0)
    monkeypatch.setattr(da, "_stream", lambda dev: 0)
    q, k, v, valid, _, _ = make_case(0, ["full", "full"], 96, 2, 4, 64, None)
    tq, tk, tv, tvalid = _stub(q, k, v, valid)
    bf = torch.bfloat16
    da.flash_decode_attention(tq.to(bf), tk.to(bf), tv.to(bf), tvalid)
    assert seen == [tq.device]
    monkeypatch.setattr(fa, "_kernel", lambda name: lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    x = torch.zeros(1, 8, 2, 64)
    fa._launch("flash_fwd_bf16", (x,), x, x, True, 0.1, None)
    assert seen == [tq.device, x.device]
