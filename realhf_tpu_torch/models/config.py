"""Transformer architecture configuration.

Field-level parity with reference ``realhf/api/core/model_api.py:144``
(ReaLModelConfig): one config class describes every supported family
(llama/qwen2/mistral/gpt2/gemma/mixtral, actor or critic). The critic
variant replaces the LM head with a scalar value head (`is_critic`).
"""

import dataclasses
from typing import Optional


@dataclasses.dataclass
class MoEConfig:
    """Mixture-of-experts settings (reference ``ReaLMoEConfig``)."""
    num_experts: int = 8
    top_k: int = 2
    routing_type: str = "aux_loss"  # aux_loss | sinkhorn | none
    aux_loss_coeff: float = 1e-3
    z_loss_coeff: float = 0.0
    input_jitter_eps: Optional[float] = None
    capacity_factor: Optional[float] = None
    use_grouped_gemm: bool = True
    # Real expert parallelism (exceeds the reference, whose dispatcher
    # says "Currently does not support expert parallel",
    # token_dispatcher.py:26-27): shard the expert (E) dim of the
    # stacked expert weights over the "data" mesh axis. The GShard
    # dispatch einsums then become all-to-alls inserted by GSPMD:
    # tokens sharded by data are exchanged for experts sharded by
    # data. Requires num_experts % data_parallel_size == 0 and the
    # capacity or dense dispatch mode (ragged grouped GEMMs cannot
    # shard the group dim).
    expert_parallel: bool = False


@dataclasses.dataclass
class TransformerConfig:
    """Architecture of one decoder-only transformer.

    Mirrors `ReaLModelConfig` (reference model_api.py:144-294) field by
    field; the fields at the bottom control dtypes and
    rematerialization. The field set is the JAX package's, so a config
    dict builds the same model in either package.
    """

    n_layers: int
    n_kv_heads: int
    n_q_heads: int
    hidden_dim: int
    intermediate_dim: int
    vocab_size: int
    head_dim: Optional[int] = None
    n_positions: Optional[int] = None
    embd_pdrop: float = 0.0
    resid_pdrop: float = 0.0
    attn_pdrop: float = 0.0
    layer_norm_epsilon: float = 1e-5
    activation_function: str = "gelu"  # gelu | gelu_new | silu
    scale_attn_by_inverse_layer_idx: bool = False
    scale_attn_weights: bool = True
    use_attention_bias: bool = True
    use_attn_proj_bias: bool = True
    use_mlp_bias: bool = True
    layer_norm_type: Optional[str] = None  # None (LayerNorm) | "rms" | "gemma"
    mlp_type: Optional[str] = None  # None (plain 2-mat MLP) | "llama" | "moe"
    # rotary embedding
    apply_rotary: bool = False
    rotary_base: float = 10000.0
    rotary_interleaved: bool = False
    rotary_scaling: Optional[float] = None
    rotary_scaling_type: Optional[str] = None  # "linear" | "dynamic"
    # gemma
    normalize_embed: bool = False
    # opt-style absolute position embedding offset
    abs_position_embedding_offset: int = 0
    do_layernorm_before: bool = True
    tied_embedding: bool = False
    sliding_window: Optional[int] = None
    moe: Optional[MoEConfig] = None
    is_critic: bool = False

    # --- numerics and memory -------------------------------------------
    # Params are kept in param_dtype; matmuls run in compute_dtype;
    # softmax and normalization accumulate in fp32.
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # Under autograd, recompute each block in the backward instead of
    # keeping its activations (models/transformer.py forward). The two
    # knobs below are carried for config compatibility: the port's
    # recompute always saves nothing inside a block, and has no pipeline.
    gradient_checkpointing: bool = False
    remat_policy: str = "nothing_saveable"
    pipeline_remat: str = "tick"

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_dim // self.n_q_heads
        assert self.n_q_heads % self.n_kv_heads == 0, \
            (self.n_q_heads, self.n_kv_heads)
        if self.mlp_type == "moe":
            assert self.moe is not None
        if self.rotary_scaling_type is not None:
            if self.rotary_scaling is None:
                raise ValueError(
                    "rotary_scaling must be set when rotary_scaling_type is.")
            if self.rotary_scaling_type == "dynamic" and self.n_positions is None:
                raise ValueError(
                    "dynamic NTK rotary scaling requires n_positions.")

    @property
    def uses_absolute_position(self) -> bool:
        return not self.apply_rotary

    @property
    def gated_mlp(self) -> bool:
        return self.mlp_type in ("llama", "moe")

    def n_params(self) -> int:
        """Approximate dense parameter count (for FLOPs/memory estimates)."""
        h, f, v = self.hidden_dim, self.intermediate_dim, self.vocab_size
        attn = h * (self.n_q_heads + 2 * self.n_kv_heads) * self.head_dim \
            + self.n_q_heads * self.head_dim * h
        mlp = (3 if self.gated_mlp else 2) * h * f
        if self.mlp_type == "moe":
            mlp *= self.moe.num_experts
        embed = v * h if self.tied_embedding else 2 * v * h
        if self.is_critic:
            embed = v * h + h
        return self.n_layers * (attn + mlp) + embed


#: named LLaMA-lineage model sizes ("tiny" for tests); the same table as
#: the JAX package's profile experiment
MODEL_SIZES = {
    "tiny": dict(n_layers=2, n_kv_heads=2, n_q_heads=4, hidden_dim=32,
                 intermediate_dim=64, vocab_size=1000),
    "125m": dict(n_layers=12, n_kv_heads=12, n_q_heads=12,
                 hidden_dim=768, intermediate_dim=3072, vocab_size=32000),
    "1b": dict(n_layers=22, n_kv_heads=4, n_q_heads=32,
               hidden_dim=2048, intermediate_dim=5632, vocab_size=32000),
    "7b": dict(n_layers=32, n_kv_heads=32, n_q_heads=32,
               hidden_dim=4096, intermediate_dim=11008, vocab_size=32000),
}

#: the LLaMA architecture: RMSNorm, gated SiLU MLP, rotary, no biases
LLAMA_ARCH = dict(apply_rotary=True, layer_norm_type="rms", mlp_type="llama",
                  use_attention_bias=False, use_attn_proj_bias=False,
                  use_mlp_bias=False, activation_function="silu")


def llama_config(size: str, **overrides) -> dict:
    """``random_init_config`` dict of a named LLaMA size."""
    return dict(MODEL_SIZES[size], **LLAMA_ARCH, **overrides)
