"""Dataset registrations."""

from realhf_tpu_torch.datasets import (  # noqa: F401
    agentic,
    prompt,
    prompt_answer,
    random_prompt,
    rw_paired,
)
