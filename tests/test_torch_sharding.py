"""The port's tensor-parallel split rules, vocabulary padding, ZeRO-1
spec, parameter streaming, mesh helpers and member collectives, against
the JAX package's ``models/sharding.py`` and ``parallel/param_stream.py``.

The split rules are compared leaf by leaf with ``param_pspecs`` over
five model families (dense llama, GPT-2 with biases, LayerNorm and a
position table, a critic, a tied-embedding Gemma and a MoE), the padding
functions on a prime vocabulary (107, so the padding differs per t), and
``shard_params`` / ``gather_params`` round trips exactly. No tolerance is
needed: every comparison here is exact.
"""

import numpy as np
import pytest
import torch

from realhf_tpu.models import sharding as jshard
from realhf_tpu.models.config import MoEConfig as JMoE
from realhf_tpu.models.config import TransformerConfig as JConfig
from realhf_tpu.parallel import param_stream as jstream
from realhf_tpu_torch.models import sharding
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import MoEConfig, TransformerConfig
from realhf_tpu_torch.models.convert import params_numpy
from realhf_tpu_torch.parallel import collectives as C
from realhf_tpu_torch.parallel import mesh
from realhf_tpu_torch.parallel import param_stream

VOCAB = 107
BASE = dict(n_layers=2, n_kv_heads=2, n_q_heads=4, hidden_dim=32,
            intermediate_dim=64, vocab_size=VOCAB, apply_rotary=True,
            layer_norm_type="rms", mlp_type="llama",
            use_attention_bias=False, use_attn_proj_bias=False,
            use_mlp_bias=False, activation_function="silu",
            param_dtype="float32", compute_dtype="float32")
FAMILIES = {
    "llama": dict(BASE),
    "gpt2": dict(BASE, apply_rotary=False, layer_norm_type=None,
                 mlp_type=None, use_attention_bias=True,
                 use_attn_proj_bias=True, use_mlp_bias=True,
                 activation_function="gelu_new", n_positions=64),
    "critic": dict(BASE, is_critic=True),
    "gemma": dict(BASE, layer_norm_type="gemma", tied_embedding=True,
                  normalize_embed=True, activation_function="gelu_new"),
    "moe": dict(BASE, mlp_type="moe"),
}


def _cfgs(name):
    kw = dict(FAMILIES[name])
    jkw = dict(kw)
    if name == "moe":
        kw["moe"] = MoEConfig(num_experts=4, top_k=2)
        jkw["moe"] = JMoE(num_experts=4, top_k=2)
    return TransformerConfig(**kw), JConfig(**jkw)


def _walk(a, b, fn, path=()):
    assert set(a) == set(b), path
    for k in a:
        if isinstance(a[k], dict):
            _walk(a[k], b[k], fn, path + (k,))
        else:
            fn(path + (k,), a[k], b[k])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_split_rules_match_param_pspecs(family):
    cfg, jcfg = _cfgs(family)
    got = sharding.param_specs(cfg)

    def check(path, spec, pspec):
        assert spec == tuple(pspec), path

    _walk(got, jshard.param_pspecs(jcfg), check)
    # the same keys as the weights, in the order the engine walks them
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    _walk(got, params, lambda *a: None)
    assert [p for p, _ in sharding.flat_specs(cfg)] == [
        p for p, _ in param_stream.flatten_params(params_numpy(params))]


@pytest.mark.parametrize("family", ["llama", "critic", "gemma"])
@pytest.mark.parametrize("tp", [1, 2, 3, 4])
def test_vocab_padding_matches_jax(family, tp):
    cfg, jcfg = _cfgs(family)
    assert sharding.padded_vocab_size(cfg, tp) == jshard.padded_vocab_size(
        jcfg, tp)
    params = params_numpy(T.init_params(cfg, torch.Generator().manual_seed(1)))
    want = jshard.pad_vocab(jcfg, params, tp)
    got = sharding.pad_vocab(cfg, params, tp)
    _walk(got, want, lambda p, a, b: np.testing.assert_array_equal(a, b))
    other = jshard.pad_vocab(jcfg, params, 5)
    _walk(sharding.normalize_vocab_padding(cfg, other, tp),
          jshard.normalize_vocab_padding(jcfg, other, tp),
          lambda p, a, b: np.testing.assert_array_equal(a, b))
    _walk(sharding.unpad_vocab(cfg, got), params,
          lambda p, a, b: np.testing.assert_array_equal(a, b))
    for path, leaf in param_stream.flatten_params(other):
        np.testing.assert_array_equal(
            sharding.repad_vocab_leaf(cfg, path, leaf, tp),
            jshard.repad_vocab_leaf(jcfg, path, leaf, tp))
    # tensors pad the same way
    tens = sharding.pad_vocab(cfg, T.init_params(
        cfg, torch.Generator().manual_seed(1)), tp)
    _walk(params_numpy(tens), want,
          lambda p, a, b: np.testing.assert_array_equal(a, b))


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("dp", [1, 2, 4])
def test_zero1_moment_spec_matches_jax(family, dp):
    cfg, jcfg = _cfgs(family)
    params = sharding.pad_vocab(
        cfg, params_numpy(T.init_params(cfg, torch.Generator())), 2)
    specs = jshard.param_pspecs(jcfg)

    def check(path, leaf, pspec):
        got = sharding.zero1_moment_spec(tuple(pspec), leaf.shape, dp)
        want = jshard.zero1_moment_spec(pspec, leaf.shape, dp)
        assert got == tuple(want), path

    _walk(params, specs, check)


@pytest.mark.parametrize("family", sorted(set(FAMILIES) - {"moe"}))
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_then_gather_is_exact(family, tp):
    cfg, jcfg = _cfgs(family)
    params = T.init_params(cfg, torch.Generator().manual_seed(2))
    trees = sharding.shard_params(cfg, params, tp)
    specs = jshard.param_pspecs(jcfg)
    padded = sharding.pad_vocab(cfg, params, tp)
    port = dict(sharding.flat_specs(cfg, tp))

    def check(path, leaf, pspec):
        full = padded
        for k in path:
            full = full[k]
        # JAX's split, but for KV leaves at a t that does not divide the
        # KV heads: the port holds those whole on every model member
        kv = path[-1] in ("wk", "wv", "bk", "bv") and cfg.n_kv_heads % tp
        assert port[path] == ((None,) * len(pspec) if kv
                              else tuple(pspec)), path
        d = sharding.split_dim(port[path])
        for j, tr in enumerate(trees):
            mine = tr
            for k in path:
                mine = mine[k]
            want = full if d is None else full.chunk(tp, dim=d)[j]
            assert torch.equal(mine, want), path

    _walk(params, specs, check)
    back = sharding.gather_params(cfg, trees)
    _walk(back, params, lambda p, a, b: torch.equal(a, b) or pytest.fail(
        str(p)))
    # numpy trees as well, with shapes the canonical ones
    nback = sharding.gather_params(cfg, sharding.shard_params(
        cfg, params_numpy(params), tp))
    _walk(nback, params_numpy(params),
          lambda p, a, b: np.testing.assert_array_equal(a, b))
    for (path, spec), leaf in zip(sharding.flat_specs(cfg, tp),
                                  (x for _, x in param_stream.flatten_params(
                                      trees[0]))):
        assert sharding.canonical_shape(cfg, path, spec, leaf.shape, tp) == \
            tuple(dict(param_stream.flatten_params(params))[path].shape)


def test_param_stream_matches_jax():
    cfg, _ = _cfgs("gpt2")
    params = params_numpy(T.init_params(cfg, torch.Generator().manual_seed(3)))
    flat, jflat = (param_stream.flatten_params(params),
                   jstream.flatten_params(params))
    assert [p for p, _ in flat] == [p for p, _ in jflat]
    for limit in (1, 4096, 1 << 20):
        chunks = param_stream.plan_chunks(flat, limit)
        assert chunks == jstream.plan_chunks(jflat, limit)
        assert param_stream.build_manifest(flat, chunks) == \
            jstream.build_manifest(jflat, chunks)
        payload = param_stream.chunk_payload(flat, chunks[0])
        assert payload.keys() == jstream.chunk_payload(jflat, chunks[0]).keys()
    back = param_stream.unflatten_params(dict(flat))
    _walk(back, params, lambda p, a, b: np.testing.assert_array_equal(a, b))
    t = torch.zeros(3, 5, dtype=torch.bfloat16)
    assert param_stream.leaf_nbytes(t) == 30


@pytest.mark.parametrize("spec,d,t", [("d2t2", 2, 2), ("d4t1", 4, 1),
                                      ("d1t4", 1, 4), ("t2d3", 3, 2)])
def test_mesh_groups(spec, d, t):
    par = mesh.parse_parallelism(spec)
    m = mesh.make_mesh(par, ["cpu"] * par.world_size)
    assert m.shape == dict(pipe=1, data=d, ctx=1, model=t)
    for i in range(d * t):
        assert (mesh.data_index(m, i), mesh.model_index(m, i)) == divmod(i, t)
        assert mesh.model_group(m, i) == [i // t * t + j for j in range(t)]
        assert mesh.data_group(m, i) == [g * t + i % t for g in range(d)]


def test_collectives_sum_gather_and_differentiate():
    devs = [torch.device("cpu")] * 3
    xs = [torch.full((2, 2), float(i + 1), requires_grad=True)
          for i in range(3)]
    outs = C.all_reduce(xs, devs)
    assert all(torch.equal(o, torch.full((2, 2), 6.0)) for o in outs)
    # every member uses the sum: each input's gradient is the sum of
    # the members' output gradients
    sum(o.sum() * (k + 1) for k, o in enumerate(outs)).backward()
    for x in xs:
        assert torch.equal(x.grad, torch.full((2, 2), 6.0))
    g = C.all_gather([torch.arange(2.0), torch.arange(2.0, 5.0)],
                     devs[:2], dim=0)
    assert all(torch.equal(x, torch.arange(5.0)) for x in g)
    mx = C.all_reduce_max([torch.tensor([1.0, 5.0]), torch.tensor([3.0, 2.0])],
                          devs[:2])
    assert torch.equal(mx[1], torch.tensor([3.0, 5.0]))
    assert C.broadcast(xs[0], devs)[2] is xs[0]
    assert torch.equal(C.reduce_sum(xs, devs[0]), torch.full((2, 2), 6.0))


def test_numpy_params_enter_the_members_of_a_layout():
    """``params_from_numpy`` with a layout's devices: a JAX-padded tree
    (t = 4) in, one tree per member of d2t2 out, member i holding shard
    i % 2 as its own copy."""
    from realhf_tpu_torch.models.convert import params_from_numpy
    cfg, jcfg = _cfgs("llama")
    params = params_numpy(T.init_params(cfg, torch.Generator().manual_seed(5)))
    padded = jshard.pad_vocab(jcfg, params, 4)
    trees = params_from_numpy(padded, cfg=cfg, devices=["cpu"] * 4, t=2,
                              dtype=torch.float32)
    assert len(trees) == 4
    want = sharding.shard_params(cfg, params, 2)
    for i, tr in enumerate(trees):
        _walk(tr, want[i % 2], lambda p, a, b: np.testing.assert_array_equal(
            a.numpy(), b))
    assert trees[0]["embed"]["wte"].shape == (54, 32)
    assert (trees[0]["embed"]["wte"].data_ptr()
            != trees[2]["embed"]["wte"].data_ptr())
