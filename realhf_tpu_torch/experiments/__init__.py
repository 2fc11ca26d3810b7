"""Experiment registrations."""

from realhf_tpu_torch.experiments import (  # noqa: F401
    agentic_exp,
    dpo_exp,
    gen_exp,
    grpo_exp,
    ppo_exp,
    profile_exp,
    rw_exp,
    serve_exp,
    sft_exp,
)
from realhf_tpu_torch.experiments.common import ALL_EXPERIMENT_CLASSES  # noqa: F401
