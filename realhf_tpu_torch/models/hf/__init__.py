"""HuggingFace-layout checkpoints; importing registers the families
(llama, qwen2, mistral, gemma, gpt2, mixtral)."""

import realhf_tpu_torch.models.hf.llama  # noqa: F401
import realhf_tpu_torch.models.hf.gpt2  # noqa: F401
import realhf_tpu_torch.models.hf.mixtral  # noqa: F401
import realhf_tpu_torch.models.hf.gemma  # noqa: F401

from realhf_tpu_torch.models.hf.registry import (  # noqa: F401
    HF_FAMILIES,
    config_from_hf,
    config_to_hf,
    detect_family,
    load_hf_checkpoint,
    load_hf_checkpoint_streamed,
    params_from_hf,
    params_to_hf,
    register_hf_family,
    save_hf_checkpoint,
    save_hf_checkpoint_streamed,
)
