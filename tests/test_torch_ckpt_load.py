"""Checkpoints across the two packages: a directory written by the JAX
package's ``save_hf_checkpoint`` (eager) or ``save_hf_checkpoint_streamed``
loads in the port, eager and streamed, and the port's saves load in the
JAX package's ``load_hf_checkpoint`` (and its streamed load), fp32 and
bf16, one ``model.safetensors`` or several shards (both packages'
``_SHARD_SIZE`` made small), actor and critic (the value head in
``value_head.safetensors``). Bits must be equal: no tolerance. A critic
made from an actor's checkpoint gets the JAX package's head. The logits
of a loaded model match the JAX forward on the same checkpoint within
1e-4 (fp32 on the CPU, sums in different orders, as
``test_torch_transformer.py``).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from realhf_tpu.models import hf as jhf
from realhf_tpu.models import transformer as JT
from realhf_tpu.models.config import TransformerConfig as JConfig
from realhf_tpu.models.hf import registry as jreg
from realhf_tpu.parallel.mesh import (
    ParallelismConfig,
    default_devices,
    make_mesh,
)
from realhf_tpu_torch.models import hf
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.models.convert import params_from_numpy, params_numpy
from realhf_tpu_torch.models.hf import registry as reg

TINY = dict(n_layers=3, n_kv_heads=2, n_q_heads=4, hidden_dim=32,
            intermediate_dim=48, vocab_size=61, apply_rotary=True,
            layer_norm_type="rms", mlp_type="llama",
            use_attention_bias=False, use_attn_proj_bias=False,
            use_mlp_bias=False, activation_function="silu",
            n_positions=128)
TOL = dict(rtol=1e-4, atol=1e-4)
NP_DT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def _params(cfg, dtype, seed=0):
    """A random tree of the JAX layout (biases and scales too)."""
    host = jax.device_get(JT.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32) + 0.05 * rng.standard_normal(
            a.shape)).astype(NP_DT[dtype]), host)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_equal(got, want, path=""):
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_equal(got[k], want[k], f"{path}{k}.")
            continue
        g = got[k]
        if isinstance(g, torch.Tensor):
            g = params_numpy({"x": g})["x"]
        g, w = np.asarray(g), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, path + k
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=path + k)


@pytest.fixture(params=[False, True], ids=["one_file", "sharded"])
def sharded(request, monkeypatch):
    if request.param:  # a few tensors a shard
        monkeypatch.setattr(jreg, "_SHARD_SIZE", 20000)
        monkeypatch.setattr(reg, "_SHARD_SIZE", 20000)
    return request.param


def _n_shards(path):
    return len([p for p in path.iterdir() if p.suffix == ".safetensors"
                and p.name != "value_head.safetensors"])


@pytest.mark.parametrize("critic", [False, True], ids=["actor", "critic"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoints_load_in_port(tmp_path, sharded, dtype, critic):
    jcfg = JConfig(**TINY, is_critic=critic)
    params = _params(jcfg, dtype)
    eager, streamed = tmp_path / "eager", tmp_path / "streamed"
    jhf.save_hf_checkpoint(str(eager), "llama", jcfg, params)
    jhf.save_hf_checkpoint_streamed(str(streamed), "llama", jcfg, params)
    assert (_n_shards(eager) > 1) == sharded
    assert _n_shards(streamed) == TINY["n_layers"] + 1
    for d in (eager, streamed):
        cfg, got = hf.load_hf_checkpoint(str(d), is_critic=critic)
        assert cfg.n_layers == TINY["n_layers"] and cfg.is_critic == critic
        _assert_equal(got, params)
        _, got = hf.load_hf_checkpoint_streamed(
            str(d), "cpu", is_critic=critic, param_dtype=dtype)
        _assert_equal(got, params)


@pytest.mark.parametrize("critic", [False, True], ids=["actor", "critic"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoints_load_in_jax(tmp_path, sharded, dtype, critic):
    jcfg = JConfig(**TINY, is_critic=critic)
    cfg = TransformerConfig(**TINY, is_critic=critic)
    params = _params(jcfg, dtype, seed=1)
    eager, streamed = tmp_path / "eager", tmp_path / "streamed"
    hf.save_hf_checkpoint(str(eager), "llama", cfg, params)
    hf.save_hf_checkpoint_streamed(str(streamed), "llama", cfg,
                                   params_from_numpy(params))
    assert (_n_shards(eager) > 1) == sharded
    for d in (eager, streamed):
        _, got = jhf.load_hf_checkpoint(str(d), is_critic=critic)
        _assert_equal(got, params)
    if dtype == "bfloat16":  # the JAX streamed load too (one dtype: slow)
        mesh = make_mesh(ParallelismConfig(), devices=default_devices()[:1])
        _, got = jhf.load_hf_checkpoint_streamed(
            str(streamed), mesh, is_critic=critic, param_dtype=dtype)
        _assert_equal(jax.device_get(got), params)


def test_critic_from_actor_checkpoint_gets_the_jax_head(tmp_path):
    jcfg = JConfig(**TINY)
    params = _params(jcfg, "float32", seed=2)
    jhf.save_hf_checkpoint(str(tmp_path), "llama", jcfg, params)
    _, want = jhf.load_hf_checkpoint(str(tmp_path), is_critic=True)
    _, got = hf.load_hf_checkpoint(str(tmp_path), is_critic=True)
    _assert_equal(got, want)
    _, got = hf.load_hf_checkpoint_streamed(str(tmp_path), "cpu",
                                            is_critic=True)
    _assert_equal(got, want)
    assert want["head"]["w"].shape == (TINY["hidden_dim"], 1)


@pytest.mark.parametrize("critic", [False, True], ids=["actor", "critic"])
def test_loaded_model_matches_jax_forward(tmp_path, critic):
    jcfg = JConfig(**TINY, is_critic=critic, compute_dtype="float32")
    params = _params(jcfg, "float32", seed=3)
    jhf.save_hf_checkpoint(str(tmp_path), "llama", jcfg, params)
    cfg, tp = hf.load_hf_checkpoint_streamed(str(tmp_path), "cpu",
                                             is_critic=critic)
    cfg.compute_dtype = "float32"
    rng = np.random.default_rng(0)
    ids = rng.integers(0, TINY["vocab_size"], size=(2, 24)).astype(np.int32)
    seg = np.zeros((2, 24), np.int32)
    seg[0, :10], seg[0, 10:20], seg[1, 3:] = 1, 2, 1
    jp = jax.tree.map(jnp.asarray, params)
    jh, _ = JT.forward(jcfg, jp, jnp.asarray(ids), jnp.asarray(seg))
    th, _ = T.forward(cfg, tp, torch.from_numpy(ids), torch.from_numpy(seg))
    if critic:
        want, got = JT.critic_values(jcfg, jp, jh), T.critic_values(
            cfg, tp, th)
    else:
        want, got = JT.lm_logits(jcfg, jp, jh), T.lm_logits(cfg, tp, th)
    valid = seg != 0
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               **TOL)


def test_streamed_load_reads_one_tensor_at_a_time(tmp_path, monkeypatch):
    """The streamed load never reads a whole file: every read is one
    tensor, and each is read once (the embeddings too)."""
    from realhf_tpu_torch.base import safetensors_io as st
    jcfg = JConfig(**TINY)
    jhf.save_hf_checkpoint(str(tmp_path), "llama", jcfg,
                           _params(jcfg, "bfloat16", seed=4))
    reads = []
    orig = st.SafeOpen.get_tensor
    monkeypatch.setattr(st.SafeOpen, "get_tensor",
                        lambda self, k: reads.append(k) or orig(self, k))
    monkeypatch.setattr(reg, "load_file", None)  # never a whole file
    hf.load_hf_checkpoint_streamed(str(tmp_path), "cpu")
    assert len(reads) == len(set(reads)) == 3 + 9 * TINY["n_layers"]
