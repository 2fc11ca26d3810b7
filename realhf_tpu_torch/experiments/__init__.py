"""Experiment registrations."""

from realhf_tpu_torch.experiments import gen_exp, sft_exp  # noqa: F401
from realhf_tpu_torch.experiments.common import ALL_EXPERIMENT_CLASSES  # noqa: F401
