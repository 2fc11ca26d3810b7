"""The port's HF family converters (``models/hf``: llama, qwen2, mistral,
gemma, gpt2, mixtral) against the JAX package's, actor and critic:
``config_from_hf`` / ``config_to_hf`` on one HF config dict, then
``params_to_hf`` on one random numpy tree and ``params_from_hf`` on the
state dict that gives. The converters only move bits (transposes, stacks,
splits), so the results must be equal: no tolerance.
"""

import dataclasses

import numpy as np
import pytest

from realhf_tpu.models import hf as jhf
from realhf_tpu_torch.models import hf

LLAMA = dict(hidden_size=32, num_attention_heads=4, num_key_value_heads=2,
             intermediate_size=48, num_hidden_layers=2, vocab_size=61,
             max_position_embeddings=128, rms_norm_eps=1e-6,
             rope_theta=10000.0)
HF_CONFIGS = {
    "llama": dict(LLAMA, model_type="llama", attention_bias=True),
    "llama_tied_hd": dict(LLAMA, model_type="llama", head_dim=16,
                          tie_word_embeddings=True),
    "qwen2": dict(LLAMA, model_type="qwen2", sliding_window=16),
    "mistral": dict(LLAMA, model_type="mistral", sliding_window=8,
                    rope_theta=1e6),
    "gemma": dict(LLAMA, model_type="gemma", head_dim=16,
                  num_key_value_heads=1),
    "gpt2": dict(model_type="gpt2", n_layer=2, n_head=4, n_embd=32,
                 n_inner=64, n_positions=40, vocab_size=61,
                 layer_norm_epsilon=1e-5, activation_function="gelu_new",
                 scale_attn_by_inverse_layer_idx=True),
    "mixtral": dict(LLAMA, model_type="mixtral", num_local_experts=3,
                    num_experts_per_tok=2, router_aux_loss_coef=0.02),
}
FAMILY = {"llama_tied_hd": "llama"}


def _shapes(cfg):
    """The stacked tree's shapes for a config (the JAX layout)."""
    nl, h, f, v = (cfg.n_layers, cfg.hidden_dim, cfg.intermediate_dim,
                   cfg.vocab_size)
    q, kv = cfg.n_q_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    attn = {"wq": (nl, h, q), "wk": (nl, h, kv), "wv": (nl, h, kv),
            "wo": (nl, q, h)}
    if cfg.use_attention_bias:
        attn.update(bq=(nl, q), bk=(nl, kv), bv=(nl, kv))
    if cfg.use_attn_proj_bias:
        attn["bo"] = (nl, h)
    if cfg.mlp_type == "moe":
        e = cfg.moe.num_experts
        mlp = {"router": (nl, h, e), "wg": (nl, e, h, f),
               "wu": (nl, e, h, f), "wd": (nl, e, f, h)}
    elif cfg.mlp_type == "llama":
        mlp = {"wg": (nl, h, f), "wu": (nl, h, f), "wd": (nl, f, h)}
    else:
        mlp = {"wu": (nl, h, f), "bu": (nl, f), "wd": (nl, f, h),
               "bd": (nl, h)}
    ln = {"scale": (nl, h)}
    lnf = {"scale": (h,)}
    if cfg.layer_norm_type is None:
        ln["bias"], lnf["bias"] = (nl, h), (h,)
    tree = {"embed": {"wte": (v, h)}, "ln_f": lnf,
            "blocks": {"ln1": ln, "ln2": dict(ln), "attn": attn, "mlp": mlp}}
    if cfg.uses_absolute_position:
        tree["embed"]["wpe"] = (cfg.n_positions, h)
    if cfg.is_critic:
        tree["head"] = {"w": (h, 1)}
    elif not cfg.tied_embedding:
        tree["head"] = {"w": (h, v)}
    return tree


def _draw(rng, shapes):
    return {k: _draw(rng, v) if isinstance(v, dict)
            else rng.standard_normal(v).astype(np.float32)
            for k, v in shapes.items()}


def _assert_trees_equal(got, want, path=""):
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}{k}.")
        else:
            assert got[k].shape == want[k].shape, path + k
            np.testing.assert_array_equal(got[k], want[k], err_msg=path + k)


@pytest.mark.parametrize("critic", [False, True], ids=["actor", "critic"])
@pytest.mark.parametrize("name", list(HF_CONFIGS))
def test_converters_match_jax(name, critic):
    family = FAMILY.get(name, name)
    d = HF_CONFIGS[name]
    jcfg = jhf.config_from_hf(family, dict(d), is_critic=critic)
    cfg = hf.config_from_hf(family, dict(d), is_critic=critic)
    want_cfg = dataclasses.asdict(jcfg)
    got_cfg = dataclasses.asdict(cfg)
    assert {k: got_cfg[k] for k in want_cfg} == want_cfg
    assert hf.config_to_hf(family, cfg) == jhf.config_to_hf(family, jcfg)
    assert hf.HF_FAMILIES[family].hf_model_type == d["model_type"]

    tree = _draw(np.random.default_rng(len(name) + critic), _shapes(jcfg))
    want_state = jhf.params_to_hf(family, tree, jcfg)
    got_state = hf.params_to_hf(family, tree, cfg)
    assert sorted(got_state) == sorted(want_state)
    for k in want_state:
        np.testing.assert_array_equal(got_state[k], want_state[k], err_msg=k)
    want_tree = jhf.params_from_hf(family, want_state, jcfg)
    got_tree = hf.params_from_hf(family, want_state, cfg)
    _assert_trees_equal(got_tree, want_tree)
    # the round trip returns the tree (less the critic head, which lives
    # in value_head.safetensors)
    tree.pop("head") if critic else None
    _assert_trees_equal(got_tree, tree)


def test_detect_family_and_registry(tmp_path):
    import json
    for name, d in HF_CONFIGS.items():
        (tmp_path / "config.json").write_text(json.dumps(d))
        assert hf.detect_family(str(tmp_path)) == FAMILY.get(name, name)
    assert sorted(hf.HF_FAMILIES) == sorted(jhf.HF_FAMILIES)
    with pytest.raises(ValueError, match="already registered"):
        hf.register_hf_family(hf.HF_FAMILIES["llama"])


def test_bare_gpt2_export_reads_through_the_prefix_view():
    """A headless GPT2Model export (keys without ``transformer.``)."""
    d = HF_CONFIGS["gpt2"]
    cfg = hf.config_from_hf("gpt2", dict(d))
    tree = _draw(np.random.default_rng(5), _shapes(cfg))
    state = hf.params_to_hf("gpt2", tree, cfg)
    bare = {k[len("transformer."):] if k.startswith("transformer.") else k:
            v for k, v in state.items()}
    _assert_trees_equal(hf.params_from_hf("gpt2", bare, cfg),
                        jhf.params_from_hf(
                            "gpt2", bare, jhf.config_from_hf("gpt2", dict(d))))
