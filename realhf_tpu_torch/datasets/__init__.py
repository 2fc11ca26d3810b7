"""Dataset registrations."""

from realhf_tpu_torch.datasets import prompt, random_prompt  # noqa: F401
