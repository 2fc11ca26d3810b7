"""GPT-2 HF conversion.

Parity with reference ``realhf/api/from_hf/gpt2.py``. GPT-2 uses
absolute positions, fused QKV stored as Conv1D (weights already in
(in, out) orientation -- no transpose), LayerNorm with bias, gelu_new,
and tied embeddings.
"""

from typing import Any, Dict

import numpy as np

from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.models.hf.registry import (
    HFFamily,
    StateDict,
    register_hf_family,
    stack_layers,
    unstack_layers,
)


def _config_from_hf(d: Dict[str, Any], is_critic: bool) -> TransformerConfig:
    return TransformerConfig(
        n_layers=d["n_layer"],
        n_kv_heads=d["n_head"],
        n_q_heads=d["n_head"],
        hidden_dim=d["n_embd"],
        intermediate_dim=d.get("n_inner") or 4 * d["n_embd"],
        vocab_size=d["vocab_size"],
        n_positions=d["n_positions"],
        layer_norm_epsilon=d.get("layer_norm_epsilon", 1e-5),
        activation_function={"gelu_new": "gelu_new", "gelu": "gelu",
                             "gelu_pytorch_tanh": "gelu_new"}[
            d.get("activation_function", "gelu_new")],
        scale_attn_by_inverse_layer_idx=d.get(
            "scale_attn_by_inverse_layer_idx", False),
        use_attention_bias=True,
        use_attn_proj_bias=True,
        use_mlp_bias=True,
        layer_norm_type=None,
        mlp_type=None,
        apply_rotary=False,
        tied_embedding=True,
        is_critic=is_critic,
        embd_pdrop=d.get("embd_pdrop", 0.0),
        resid_pdrop=d.get("resid_pdrop", 0.0),
        attn_pdrop=d.get("attn_pdrop", 0.0),
    )


def _config_to_hf(cfg: TransformerConfig) -> Dict[str, Any]:
    return {
        "model_type": "gpt2",
        "architectures": ["GPT2LMHeadModel"],
        "n_layer": cfg.n_layers,
        "n_head": cfg.n_q_heads,
        "n_embd": cfg.hidden_dim,
        "n_inner": cfg.intermediate_dim,
        "n_positions": cfg.n_positions,
        "n_ctx": cfg.n_positions,
        "vocab_size": cfg.vocab_size,
        "layer_norm_epsilon": cfg.layer_norm_epsilon,
        "activation_function": cfg.activation_function,
        "scale_attn_by_inverse_layer_idx": cfg.scale_attn_by_inverse_layer_idx,
        "embd_pdrop": cfg.embd_pdrop,
        "resid_pdrop": cfg.resid_pdrop,
        "attn_pdrop": cfg.attn_pdrop,
        "tie_word_embeddings": True,
        "torch_dtype": "float32",
    }


def _params_from_hf(state: StateDict, cfg: TransformerConfig) -> Dict[str, Any]:
    nl, h = cfg.n_layers, cfg.hidden_dim
    pre = "transformer.h.{}."
    if "transformer.wte.weight" not in state:  # bare GPT2Model naming
        from realhf_tpu_torch.models.hf.registry import PrefixedStateView
        state = PrefixedStateView(state, "transformer.")
    # Fused QKV (Conv1D, (in, 3h)) -> separate (in, out) mats.
    c_attn_w = stack_layers(state, pre + "attn.c_attn.weight", nl)  # [nl, h, 3h]
    c_attn_b = stack_layers(state, pre + "attn.c_attn.bias", nl)    # [nl, 3h]
    wq, wk, wv = np.split(c_attn_w, 3, axis=2)
    bq, bk, bv = np.split(c_attn_b, 3, axis=1)
    params: Dict[str, Any] = {
        "embed": {
            "wte": state["transformer.wte.weight"],
            "wpe": state["transformer.wpe.weight"],
        },
        "blocks": {
            "ln1": {
                "scale": stack_layers(state, pre + "ln_1.weight", nl),
                "bias": stack_layers(state, pre + "ln_1.bias", nl),
            },
            "attn": {
                "wq": wq, "wk": wk, "wv": wv,
                "bq": bq, "bk": bk, "bv": bv,
                "wo": stack_layers(state, pre + "attn.c_proj.weight", nl),
                "bo": stack_layers(state, pre + "attn.c_proj.bias", nl),
            },
            "ln2": {
                "scale": stack_layers(state, pre + "ln_2.weight", nl),
                "bias": stack_layers(state, pre + "ln_2.bias", nl),
            },
            "mlp": {
                "wu": stack_layers(state, pre + "mlp.c_fc.weight", nl),
                "bu": stack_layers(state, pre + "mlp.c_fc.bias", nl),
                "wd": stack_layers(state, pre + "mlp.c_proj.weight", nl),
                "bd": stack_layers(state, pre + "mlp.c_proj.bias", nl),
            },
        },
        "ln_f": {
            "scale": state["transformer.ln_f.weight"],
            "bias": state["transformer.ln_f.bias"],
        },
    }
    return params


def _params_to_hf(params: Dict[str, Any], cfg: TransformerConfig) -> StateDict:
    out: StateDict = {}
    pre = "transformer.h.{}."
    out["transformer.wte.weight"] = np.ascontiguousarray(params["embed"]["wte"])
    out["transformer.wpe.weight"] = np.ascontiguousarray(params["embed"]["wpe"])
    b = params["blocks"]
    unstack_layers(b["ln1"]["scale"], pre + "ln_1.weight", out)
    unstack_layers(b["ln1"]["bias"], pre + "ln_1.bias", out)
    c_attn_w = np.concatenate(
        [b["attn"]["wq"], b["attn"]["wk"], b["attn"]["wv"]], axis=2)
    c_attn_b = np.concatenate(
        [b["attn"]["bq"], b["attn"]["bk"], b["attn"]["bv"]], axis=1)
    unstack_layers(c_attn_w, pre + "attn.c_attn.weight", out)
    unstack_layers(c_attn_b, pre + "attn.c_attn.bias", out)
    unstack_layers(b["attn"]["wo"], pre + "attn.c_proj.weight", out)
    unstack_layers(b["attn"]["bo"], pre + "attn.c_proj.bias", out)
    unstack_layers(b["ln2"]["scale"], pre + "ln_2.weight", out)
    unstack_layers(b["ln2"]["bias"], pre + "ln_2.bias", out)
    unstack_layers(b["mlp"]["wu"], pre + "mlp.c_fc.weight", out)
    unstack_layers(b["mlp"]["bu"], pre + "mlp.c_fc.bias", out)
    unstack_layers(b["mlp"]["wd"], pre + "mlp.c_proj.weight", out)
    unstack_layers(b["mlp"]["bd"], pre + "mlp.c_proj.bias", out)
    out["transformer.ln_f.weight"] = np.ascontiguousarray(
        params["ln_f"]["scale"])
    out["transformer.ln_f.bias"] = np.ascontiguousarray(params["ln_f"]["bias"])
    out["lm_head.weight"] = out["transformer.wte.weight"]
    return out


register_hf_family(HFFamily(
    name="gpt2", hf_model_type="gpt2",
    config_from_hf=_config_from_hf,
    config_to_hf=_config_to_hf,
    params_from_hf=_params_from_hf,
    params_to_hf=_params_to_hf,
))
