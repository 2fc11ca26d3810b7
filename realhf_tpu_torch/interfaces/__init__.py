"""Interface registrations."""

from realhf_tpu_torch.interfaces import gen, sft  # noqa: F401
