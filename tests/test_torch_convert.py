"""Weights carried from the JAX package into the PyTorch port and back:
bit-exact, with the same paths and shapes."""

import jax
import numpy as np
import pytest
import torch

from realhf_tpu.models import transformer as JT
from realhf_tpu.models.config import TransformerConfig as JConfig
from realhf_tpu_torch.engine.engine import Engine
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.models.convert import params_from_numpy, params_numpy

LLAMA = dict(n_layers=2, n_kv_heads=2, n_q_heads=4, hidden_dim=32,
             intermediate_dim=64, vocab_size=128, apply_rotary=True,
             layer_norm_type="rms", mlp_type="llama",
             use_attention_bias=False, use_attn_proj_bias=False,
             use_mlp_bias=False, activation_function="silu")
GPT2 = dict(n_layers=2, n_kv_heads=4, n_q_heads=4, hidden_dim=32,
            intermediate_dim=64, vocab_size=128, n_positions=64,
            activation_function="gelu_new", tied_embedding=True)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", [LLAMA, GPT2], ids=["llama", "gpt2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_params_round_trip_bit_exact(arch, dtype):
    cfg = JConfig(**arch, param_dtype=dtype)
    jparams = jax.device_get(JT.init_params(cfg, jax.random.PRNGKey(0)))
    tparams = params_from_numpy(jparams)
    back = params_numpy(tparams)
    fj, ft, fb = _flat(jparams), _flat(tparams), _flat(back)
    assert fj.keys() == ft.keys() == fb.keys()
    for path, a in fj.items():
        assert tuple(ft[path].shape) == a.shape, path
        b = np.asarray(fb[path])
        assert b.shape == a.shape, path
        np.testing.assert_array_equal(
            np.asarray(a, np.float32), b.astype(np.float32), err_msg=path)
        # bit patterns, not just values
        assert np.asarray(a).tobytes() == np.asarray(b, a.dtype).tobytes()


def test_engine_holds_carried_weights_in_param_dtype():
    jcfg = JConfig(**LLAMA)
    jparams = jax.device_get(JT.init_params(jcfg, jax.random.PRNGKey(1)))
    cfg = TransformerConfig(**LLAMA, param_dtype="float32",
                            compute_dtype="float32")
    eng = Engine(cfg, jparams, device="cpu")
    leaf = eng.params["blocks"]["attn"]["wq"]
    assert leaf.dtype == torch.float32 and leaf.device.type == "cpu"
    out = _flat(eng.params_numpy())
    for path, a in _flat(jparams).items():
        np.testing.assert_array_equal(out[path], a, err_msg=path)


def test_engine_defaults_to_the_card():
    cfg = TransformerConfig(**LLAMA)
    jparams = jax.device_get(JT.init_params(JConfig(**LLAMA),
                                            jax.random.PRNGKey(2)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Engine(cfg, jparams)  # device=None means the card
