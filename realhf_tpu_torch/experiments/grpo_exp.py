"""GRPO experiment: group-relative RLHF without a critic.

Four MFCs, actor_gen (group sampling) -> {rew_inf, ref_inf} ->
actor_train, over three roles (actor, ref, reward); no value model in
the graph.
"""

import dataclasses
from typing import Optional

from realhf_tpu_torch.api.config import (
    DatasetAbstraction,
    ModelInterfaceAbstraction,
    ModelInterfaceType,
)
from realhf_tpu_torch.api.dfg import MFCDef
from realhf_tpu_torch.api.experiment import ExperimentSpec
from realhf_tpu_torch.experiments.common import (
    CommonExperimentConfig,
    DatasetConfigCLI,
    ModelConfigCLI,
    register_experiment,
)


@dataclasses.dataclass
class GRPOHyperparameters:
    group_size: int = 4
    kl_coef: float = 0.05
    max_new_tokens: int = 256
    min_new_tokens: int = 1
    greedy: bool = False
    top_p: float = 1.0
    top_k: int = 0
    temperature: float = 1.0
    # GRPO replays no logits mask; sampling stays unwarped by default
    force_no_logits_mask: bool = True
    ppo_n_minibatches: int = 4
    eps_clip: float = 0.2
    discount: float = 1.0
    max_reward_clip: float = 20.0
    reward_output_scaling: float = 1.0
    reward_output_bias: float = 0.0
    adv_norm: bool = False


@dataclasses.dataclass
class GRPOConfig(CommonExperimentConfig):
    actor: ModelConfigCLI = dataclasses.field(default_factory=ModelConfigCLI)
    ref: ModelConfigCLI = dataclasses.field(default_factory=ModelConfigCLI)
    rew: ModelConfigCLI = dataclasses.field(
        default_factory=lambda: ModelConfigCLI(is_critic=True))
    dataset: DatasetConfigCLI = dataclasses.field(
        default_factory=DatasetConfigCLI)
    grpo: GRPOHyperparameters = dataclasses.field(
        default_factory=GRPOHyperparameters)
    actor_gen_n_mbs: int = 1
    actor_train_n_mbs: int = 1
    rew_inf_n_mbs: int = 1
    ref_inf_n_mbs: int = 1
    # per-MFC layouts of their own, as in PPOConfig
    actor_gen_alloc: Optional[str] = None
    rew_inf_alloc: Optional[str] = None
    ref_inf_alloc: Optional[str] = None

    def build(self) -> ExperimentSpec:
        allocations = self.mfc_allocations(dict(
            actor_gen="actor_gen_alloc", rew_inf="rew_inf_alloc",
            ref_inf="ref_inf_alloc"))
        g = self.grpo
        gconfig = dict(
            max_new_tokens=g.max_new_tokens,
            min_new_tokens=g.min_new_tokens,
            greedy=g.greedy, top_p=g.top_p, top_k=g.top_k,
            temperature=g.temperature,
            force_no_logits_mask=g.force_no_logits_mask)
        itf = ModelInterfaceAbstraction("grpo", dict(
            group_size=g.group_size, kl_coef=g.kl_coef,
            gconfig=gconfig, n_minibatches=g.ppo_n_minibatches,
            eps_clip=g.eps_clip, discount=g.discount,
            max_reward_clip=g.max_reward_clip, adv_norm=g.adv_norm))
        rw_itf = ModelInterfaceAbstraction(
            "paired_rw", dict(output_scaling=g.reward_output_scaling,
                              output_bias=g.reward_output_bias,
                              enable_save=False))
        n = self.dataset.train_bs_n_seqs
        mfcs = [
            MFCDef(name="actor_gen", n_seqs=n,
                   interface_type=ModelInterfaceType.GENERATE,
                   interface_impl=itf, model_name="actor",
                   input_keys=("packed_prompts",),
                   output_keys=("seq_no_eos_mask", "packed_input_ids",
                                "packed_logprobs", "prompt_mask"),
                   n_mbs=self.actor_gen_n_mbs),
            MFCDef(name="rew_inf", n_seqs=n,
                   interface_type=ModelInterfaceType.INFERENCE,
                   interface_impl=rw_itf, model_name="reward",
                   input_keys=("packed_input_ids",),
                   output_keys=("rewards",),
                   n_mbs=self.rew_inf_n_mbs),
            MFCDef(name="ref_inf", n_seqs=n,
                   interface_type=ModelInterfaceType.INFERENCE,
                   interface_impl=itf, model_name="ref",
                   input_keys=("packed_input_ids",),
                   output_keys=("packed_ref_logprobs",),
                   n_mbs=self.ref_inf_n_mbs),
            MFCDef(name="actor_train", n_seqs=n,
                   interface_type=ModelInterfaceType.TRAIN_STEP,
                   interface_impl=itf, model_name="actor",
                   input_keys=("packed_input_ids", "packed_logprobs",
                               "packed_ref_logprobs", "rewards",
                               "prompt_mask"),
                   log_return_value=True,
                   n_mbs=self.actor_train_n_mbs),
        ]
        dataset = DatasetAbstraction(
            "prompt", args=dict(max_length=self.dataset.max_seqlen,
                                dataset_path=self.dataset.path))
        return ExperimentSpec(
            allocations=allocations,
            experiment_name=self.experiment_name,
            trial_name=self.trial_name,
            models={
                "actor": self.actor.to_spec(train=True),
                "ref": self.ref.to_spec(train=False),
                "reward": dataclasses.replace(
                    self.rew.to_spec(train=False), is_critic=True),
            },
            mfcs=mfcs,
            dataset=dataset,
            tokenizer_path=self.tokenizer_path,
            total_train_epochs=self.total_train_epochs,
            seed=self.seed,
            ctl=self.ctl())


register_experiment("grpo", GRPOConfig)
