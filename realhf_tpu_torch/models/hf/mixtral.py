"""Mixtral (MoE llama) HF conversion.

Parity with reference ``realhf/api/from_hf/mixtral.py``: llama
attention + block-sparse MoE FFN. HF per-expert w1 (gate), w3 (up),
w2 (down) stack into [E, H, F] / [E, F, H]; the router gate becomes
[H, E].
"""

from typing import Any, Dict

import numpy as np

from realhf_tpu_torch.models.config import MoEConfig, TransformerConfig
from realhf_tpu_torch.models.hf.llama import (
    _config_to_hf_llama,
    llama_backbone_from_hf,
    llama_backbone_to_hf,
)
from realhf_tpu_torch.models.hf.registry import (
    HFFamily,
    StateDict,
    register_hf_family,
    stack_layers,
    unstack_layers,
)


def _config_from_hf(d: Dict[str, Any], is_critic: bool) -> TransformerConfig:
    nq = d["num_attention_heads"]
    return TransformerConfig(
        n_layers=d["num_hidden_layers"],
        n_kv_heads=d.get("num_key_value_heads", nq),
        n_q_heads=nq,
        hidden_dim=d["hidden_size"],
        head_dim=d.get("head_dim") or d["hidden_size"] // nq,
        intermediate_dim=d["intermediate_size"],
        vocab_size=d["vocab_size"],
        n_positions=d.get("max_position_embeddings"),
        layer_norm_epsilon=d.get("rms_norm_eps", 1e-5),
        activation_function="silu",
        use_attention_bias=False,
        use_attn_proj_bias=False,
        use_mlp_bias=False,
        layer_norm_type="rms",
        mlp_type="moe",
        apply_rotary=True,
        rotary_base=d.get("rope_theta", 1e6),
        scale_attn_by_inverse_layer_idx=False,
        tied_embedding=d.get("tie_word_embeddings", False),
        sliding_window=d.get("sliding_window"),
        moe=MoEConfig(
            num_experts=d.get("num_local_experts", 8),
            top_k=d.get("num_experts_per_tok", 2),
            routing_type="aux_loss",
            aux_loss_coeff=d.get("router_aux_loss_coef", 1e-2)),
        is_critic=is_critic,
    )


def _config_to_hf(cfg: TransformerConfig) -> Dict[str, Any]:
    d = _config_to_hf_llama(cfg, "llama")
    d.update({
        "model_type": "mixtral",
        "architectures": ["MixtralForCausalLM"],
        "num_local_experts": cfg.moe.num_experts,
        "num_experts_per_tok": cfg.moe.top_k,
        "router_aux_loss_coef": cfg.moe.aux_loss_coeff,
    })
    d.pop("attention_bias", None)
    return d


def _params_from_hf(state: StateDict, cfg: TransformerConfig) -> Dict[str, Any]:
    nl = cfg.n_layers
    ne = cfg.moe.num_experts
    pre = "model.layers.{}."
    # Attention/norm/embedding/head layout equals llama.
    params = llama_backbone_from_hf(state, cfg)
    mlp = params["blocks"]["mlp"]
    mlp["router"] = stack_layers(
        state, pre + "block_sparse_moe.gate.weight", nl, transpose=True)
    for name, hf_w, transpose in (("wg", "w1", True), ("wu", "w3", True),
                                  ("wd", "w2", True)):
        per_layer = []
        for i in range(nl):
            per_expert = [
                state[f"model.layers.{i}.block_sparse_moe.experts."
                      f"{e}.{hf_w}.weight"].T
                for e in range(ne)
            ]
            per_layer.append(np.stack(per_expert, axis=0))
        mlp[name] = np.stack(per_layer, axis=0)  # [nl, E, in, out]
    return params


def _params_to_hf(params: Dict[str, Any], cfg: TransformerConfig) -> StateDict:
    out: StateDict = {}
    pre = "model.layers.{}."
    llama_backbone_to_hf(params, cfg, out)
    b = params["blocks"]
    unstack_layers(b["mlp"]["router"], pre + "block_sparse_moe.gate.weight",
                   out, transpose=True)
    nl, ne = cfg.n_layers, cfg.moe.num_experts
    for name, hf_w in (("wg", "w1"), ("wu", "w3"), ("wd", "w2")):
        arr = b["mlp"][name]  # [nl, E, in, out]
        for i in range(nl):
            for e in range(ne):
                out[f"model.layers.{i}.block_sparse_moe.experts."
                    f"{e}.{hf_w}.weight"] = np.ascontiguousarray(arr[i, e].T)
    return out


register_hf_family(HFFamily(
    name="mixtral", hf_model_type="mixtral",
    config_from_hf=_config_from_hf,
    config_to_hf=_config_to_hf,
    params_from_hf=_params_from_hf,
    params_to_hf=_params_to_hf,
))
