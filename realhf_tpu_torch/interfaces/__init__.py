"""Interface registrations."""

from realhf_tpu_torch.interfaces import gen, ppo, rw, sft  # noqa: F401
