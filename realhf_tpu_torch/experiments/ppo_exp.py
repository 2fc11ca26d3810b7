"""PPO experiment: the 6-MFC RLHF dataflow graph.

actor_gen -> {rew_inf, ref_inf, critic_inf} -> {actor_train,
critic_train} over four model roles (actor, critic, ref, reward).
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
class PPOHyperparameters:
    max_new_tokens: int = 256
    min_new_tokens: int = 256
    greedy: bool = False
    top_p: float = 0.9
    top_k: int = 200
    temperature: float = 1.0
    force_no_logits_mask: bool = False
    ppo_n_minibatches: int = 4
    kl_ctl: float = 0.1
    discount: float = 1.0
    gae_lambda: float = 1.0
    eps_clip: float = 0.2
    value_eps_clip: float = 0.2
    max_reward_clip: float = 20.0
    reward_output_scaling: float = 1.0
    reward_output_bias: float = 0.0
    early_stop_imp_ratio: float = 5.0
    use_adaptive_kl_ctl: bool = False
    # consumption of asynchronously generated samples: drop sequences
    # staler than this many trainer versions; bound the clipped-IS
    # correction of the stale remainder (None disables either)
    max_staleness: Optional[int] = None
    staleness_is_clip: Optional[float] = 2.0
    adv_norm: bool = True
    value_norm: bool = True
    value_norm_type: str = "exp"
    value_norm_beta: float = 0.99995
    value_norm_eps: float = 1e-5


@dataclasses.dataclass
class PPOConfig(CommonExperimentConfig):
    actor: ModelConfigCLI = dataclasses.field(default_factory=ModelConfigCLI)
    critic: ModelConfigCLI = dataclasses.field(
        default_factory=lambda: ModelConfigCLI(is_critic=True))
    ref: ModelConfigCLI = dataclasses.field(default_factory=ModelConfigCLI)
    rew: ModelConfigCLI = dataclasses.field(
        default_factory=lambda: ModelConfigCLI(is_critic=True))
    dataset: DatasetConfigCLI = dataclasses.field(
        default_factory=DatasetConfigCLI)
    ppo: PPOHyperparameters = dataclasses.field(
        default_factory=PPOHyperparameters)
    actor_gen_n_mbs: int = 1
    actor_train_n_mbs: int = 1
    critic_inf_n_mbs: int = 1
    critic_train_n_mbs: int = 1
    rew_inf_n_mbs: int = 1
    ref_inf_n_mbs: int = 1
    #: batch size of actor_gen, the source MFC, when it differs from
    #: the train batch: the dataset loader batches at the source's size
    actor_gen_n_seqs: Optional[int] = None
    # Per-MFC layouts of their own ("d2t1", ...): the MFC runs on a
    # replica of its role's weights, kept fresh by parameter
    # reallocation (system/model_host.py)
    actor_gen_alloc: Optional[str] = None
    rew_inf_alloc: Optional[str] = None
    ref_inf_alloc: Optional[str] = None
    critic_inf_alloc: Optional[str] = None

    def build(self) -> ExperimentSpec:
        allocations = self.mfc_allocations(dict(
            actor_gen="actor_gen_alloc", rew_inf="rew_inf_alloc",
            ref_inf="ref_inf_alloc", critic_inf="critic_inf_alloc"))
        p = self.ppo
        gconfig = dict(
            max_new_tokens=p.max_new_tokens,
            min_new_tokens=p.min_new_tokens,
            greedy=p.greedy, top_p=p.top_p, top_k=p.top_k,
            temperature=p.temperature,
            force_no_logits_mask=p.force_no_logits_mask)
        actor_args = dict(
            n_minibatches=p.ppo_n_minibatches, gconfig=gconfig,
            kl_ctl=p.kl_ctl, discount=p.discount, gae_lambda=p.gae_lambda,
            eps_clip=p.eps_clip, max_reward_clip=p.max_reward_clip,
            early_stop_imp_ratio=p.early_stop_imp_ratio,
            max_staleness=p.max_staleness,
            staleness_is_clip=p.staleness_is_clip,
            adv_norm=p.adv_norm,
            use_adaptive_kl_ctl=p.use_adaptive_kl_ctl,
            value_norm=p.value_norm, value_norm_type=p.value_norm_type,
            value_norm_beta=p.value_norm_beta,
            value_norm_eps=p.value_norm_eps)
        critic_args = dict(
            n_minibatches=p.ppo_n_minibatches, kl_ctl=p.kl_ctl,
            discount=p.discount, gae_lambda=p.gae_lambda,
            value_eps_clip=p.value_eps_clip,
            max_reward_clip=p.max_reward_clip,
            use_adaptive_kl_ctl=p.use_adaptive_kl_ctl,
            value_norm=p.value_norm, value_norm_type=p.value_norm_type,
            value_norm_beta=p.value_norm_beta,
            value_norm_eps=p.value_norm_eps)
        actor_itf = ModelInterfaceAbstraction("ppo_actor", actor_args)
        critic_itf = ModelInterfaceAbstraction("ppo_critic", critic_args)
        rw_itf = ModelInterfaceAbstraction(
            "paired_rw", dict(output_scaling=p.reward_output_scaling,
                              output_bias=p.reward_output_bias,
                              enable_save=False))
        n = self.dataset.train_bs_n_seqs
        gen_outputs = ["seq_no_eos_mask", "packed_input_ids",
                       "packed_logprobs", "prompt_mask"]
        ref_inputs = ["packed_input_ids"]
        if not p.force_no_logits_mask:
            gen_outputs.append("packed_logits_mask")
            ref_inputs.append("packed_logits_mask")
        train_inputs = ("packed_input_ids", "packed_logprobs",
                        "packed_ref_logprobs", "rewards", "values",
                        "prompt_mask", "seq_no_eos_mask")
        mfcs = [
            MFCDef(name="actor_gen", n_seqs=self.actor_gen_n_seqs or n,
                   interface_type=ModelInterfaceType.GENERATE,
                   interface_impl=actor_itf, model_name="actor",
                   input_keys=("packed_prompts",),
                   output_keys=tuple(gen_outputs),
                   n_mbs=self.actor_gen_n_mbs),
            MFCDef(name="rew_inf", n_seqs=n,
                   interface_type=ModelInterfaceType.INFERENCE,
                   interface_impl=rw_itf, model_name="reward",
                   input_keys=("packed_input_ids",),
                   output_keys=("rewards",),
                   n_mbs=self.rew_inf_n_mbs),
            MFCDef(name="ref_inf", n_seqs=n,
                   interface_type=ModelInterfaceType.INFERENCE,
                   interface_impl=actor_itf, model_name="ref",
                   input_keys=tuple(ref_inputs),
                   output_keys=("packed_ref_logprobs",),
                   n_mbs=self.ref_inf_n_mbs),
            MFCDef(name="critic_inf", n_seqs=n,
                   interface_type=ModelInterfaceType.INFERENCE,
                   interface_impl=critic_itf, model_name="critic",
                   input_keys=("packed_input_ids", "seq_no_eos_mask"),
                   output_keys=("values",),
                   n_mbs=self.critic_inf_n_mbs),
            MFCDef(name="actor_train", n_seqs=n,
                   interface_type=ModelInterfaceType.TRAIN_STEP,
                   interface_impl=actor_itf, model_name="actor",
                   input_keys=train_inputs + (
                       ("packed_logits_mask",)
                       if not p.force_no_logits_mask else ()),
                   log_return_value=True,
                   n_mbs=self.actor_train_n_mbs),
            MFCDef(name="critic_train", n_seqs=n,
                   interface_type=ModelInterfaceType.TRAIN_STEP,
                   interface_impl=critic_itf, model_name="critic",
                   input_keys=train_inputs,
                   log_return_value=True,
                   n_mbs=self.critic_train_n_mbs),
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
                "critic": dataclasses.replace(
                    self.critic.to_spec(train=True), is_critic=True),
                "ref": self.ref.to_spec(train=False),
                "reward": dataclasses.replace(
                    self.rew.to_spec(train=False), is_critic=True),
            },
            mfcs=mfcs,
            dataset=dataset,
            tokenizer_path=self.tokenizer_path or self.actor.path,
            total_train_epochs=self.total_train_epochs,
            seed=self.seed,
            ctl=self.ctl())


register_experiment("ppo", PPOConfig)
