"""Profile experiment: the PPO dataflow graph on synthetic data.

The six PPO MFCs with random-weight models of a named LLaMA size
(``models/config.py`` ``MODEL_SIZES``) on random prompts, through the
inline runner: a system test that needs nothing real, and the rig for
per-MFC timing::

    python -m realhf_tpu_torch.apps.quickstart profile \\
        model_size=7b n_prompts=64 ppo.max_new_tokens=128 \\
        ppo.min_new_tokens=32 benchmark_steps=1

Per-MFC timing from the runtime's own spans (the JAX package's
``mfc_timing_summary``) waits for the observability slice of the port.
"""

import dataclasses

from realhf_tpu_torch.api.config import DatasetAbstraction
from realhf_tpu_torch.api.experiment import ExperimentSpec, ModelSpec
from realhf_tpu_torch.base.testing import IntegerTokenizer
from realhf_tpu_torch.engine.optim import OptimizerConfig
from realhf_tpu_torch.experiments.common import register_experiment
from realhf_tpu_torch.experiments.ppo_exp import PPOConfig
from realhf_tpu_torch.models.config import llama_config


@dataclasses.dataclass
class ProfileConfig(PPOConfig):
    """The PPO graph on synthetic data (its six MFCs and per-MFC knobs
    from ``PPOConfig``)."""
    model_size: str = "tiny"
    n_prompts: int = 64
    prompt_len_min: int = 16
    prompt_len_max: int = 64
    bf16: bool = True
    lr: float = 1e-5

    def build(self) -> ExperimentSpec:
        if not self.benchmark_steps:
            self.benchmark_steps = 3
        spec = super().build()
        size = llama_config(self.model_size)
        vocab = size["vocab_size"]
        for role, mspec in spec.models.items():
            spec.models[role] = ModelSpec(
                path=None,
                random_init_config=dict(size),
                is_critic=mspec.is_critic or role in ("critic", "reward"),
                optimizer=(OptimizerConfig(
                    lr=self.lr, warmup_steps_proportion=0.0,
                    lr_scheduler_type="constant")
                    if mspec.optimizer is not None else None),
                parallel=mspec.parallel,
                bf16=self.bf16)
        spec.dataset = DatasetAbstraction(
            "random_prompt",
            args=dict(n_prompts=self.n_prompts,
                      prompt_len_min=self.prompt_len_min,
                      prompt_len_max=self.prompt_len_max,
                      vocab_size=vocab,
                      max_length=self.dataset.max_seqlen))
        # synthetic ids need no tokenizer beyond the pad/eos conventions
        spec.tokenizer = IntegerTokenizer(vocab_size=vocab - 2)
        return spec


register_experiment("profile", ProfileConfig)
