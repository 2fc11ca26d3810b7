"""Gemma HF conversion (reference ``realhf/api/from_hf/gemma.py``):
gemma-style RMSNorm (1 + scale), normalized embeddings, tied LM head,
gelu_tanh activation, head_dim decoupled from hidden/nq.
"""

from typing import Any, Dict

from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.models.hf.llama import (
    _params_from_hf_llama,
    _params_to_hf_llama,
)
from realhf_tpu_torch.models.hf.registry import HFFamily, register_hf_family


def _config_from_hf(d: Dict[str, Any], is_critic: bool) -> TransformerConfig:
    nq = d["num_attention_heads"]
    return TransformerConfig(
        n_layers=d["num_hidden_layers"],
        n_kv_heads=d.get("num_key_value_heads", nq),
        n_q_heads=nq,
        hidden_dim=d["hidden_size"],
        head_dim=d.get("head_dim", 256),
        intermediate_dim=d["intermediate_size"],
        vocab_size=d["vocab_size"],
        n_positions=d.get("max_position_embeddings"),
        layer_norm_epsilon=d.get("rms_norm_eps", 1e-6),
        activation_function="gelu_new",
        use_attention_bias=d.get("attention_bias", False),
        use_attn_proj_bias=False,
        use_mlp_bias=False,
        layer_norm_type="gemma",
        mlp_type="llama",
        apply_rotary=True,
        rotary_base=d.get("rope_theta", 10000.0),
        scale_attn_by_inverse_layer_idx=False,
        normalize_embed=True,
        tied_embedding=True,
        is_critic=is_critic,
    )


def _config_to_hf(cfg: TransformerConfig) -> Dict[str, Any]:
    return {
        "model_type": "gemma",
        "architectures": ["GemmaForCausalLM"],
        "hidden_size": cfg.hidden_dim,
        "head_dim": cfg.head_dim,
        "intermediate_size": cfg.intermediate_dim,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_q_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "vocab_size": cfg.vocab_size,
        "max_position_embeddings": cfg.n_positions or 8192,
        "rms_norm_eps": cfg.layer_norm_epsilon,
        "rope_theta": cfg.rotary_base,
        "hidden_act": "gelu_pytorch_tanh",
        "hidden_activation": "gelu_pytorch_tanh",
        "tie_word_embeddings": True,
        "attention_bias": cfg.use_attention_bias,
        "torch_dtype": "float32",
    }


register_hf_family(HFFamily(
    name="gemma", hf_model_type="gemma",
    config_from_hf=_config_from_hf,
    config_to_hf=_config_to_hf,
    params_from_hf=_params_from_hf_llama,
    params_to_hf=_params_to_hf_llama,
))
