"""Interface registrations."""

from realhf_tpu_torch.interfaces import gen  # noqa: F401
