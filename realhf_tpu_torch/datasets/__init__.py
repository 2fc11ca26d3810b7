"""Dataset registrations."""

from realhf_tpu_torch.datasets import (  # noqa: F401
    prompt,
    prompt_answer,
    random_prompt,
)
