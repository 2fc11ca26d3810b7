"""Agentic PPO experiment: the environment-in-the-loop dataflow graph.

Five MFCs for env-rewarded multi-turn RL:

    actor_gen (agentic_actor: episodes through the env, turn rewards)
        -> {ref_inf, critic_inf} -> {actor_train, critic_train}

A PPO graph without the reward-model MFC: the environment's checker is
the reward model, so ``rewards`` (episode total) and ``dense_rewards``
(per-turn placement) come out of ``actor_gen`` itself. Three roles:
actor, critic, ref. With ``agentic.turn_level_credit`` (default on) the
PPO interfaces place credit at each turn's last action token and GAE
bridges the masked observation gaps; off, the same trajectories are
credited at the sequence's end.

The JAX package's distributed-runtime keys (``max_concurrent_batches``,
``max_head_offpolicyness``) are not fields here: they wait for that
runtime's slice of the port.
"""

import dataclasses
from typing import Dict, Optional

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
from realhf_tpu_torch.experiments.ppo_exp import PPOHyperparameters


@dataclasses.dataclass
class AgenticHyperparameters:
    """The env-in-the-loop knobs beside the PPO block."""
    #: registered env name (``agentic/env.py``)
    env: str = "checker_task"
    #: env constructor kwargs (vocab_size defaults to the model's)
    env_args: Dict = dataclasses.field(default_factory=dict)
    #: per-episode turn cap (multi-turn envs may finish earlier)
    max_turns: int = 4
    #: per-episode context cap in tokens (None = auto)
    max_context_len: Optional[int] = None
    #: concurrent episodes inside one generate MFC (0 = whole batch)
    max_concurrent: int = 0
    #: reward at each turn's last action token and GAE across masked
    #: gaps; False = the episode total at the end of the sequence
    turn_level_credit: bool = True
    #: dataset type feeding the episodes (checker_task | tool_game)
    dataset_type: str = "checker_task"
    #: synthetic dataset size (ignored when dataset.path is set)
    n_prompts: int = 128


@dataclasses.dataclass
class AgenticPPOConfig(CommonExperimentConfig):
    actor: ModelConfigCLI = dataclasses.field(default_factory=ModelConfigCLI)
    critic: ModelConfigCLI = dataclasses.field(
        default_factory=lambda: ModelConfigCLI(is_critic=True))
    ref: ModelConfigCLI = dataclasses.field(default_factory=ModelConfigCLI)
    dataset: DatasetConfigCLI = dataclasses.field(
        default_factory=DatasetConfigCLI)
    ppo: PPOHyperparameters = dataclasses.field(
        default_factory=PPOHyperparameters)
    agentic: AgenticHyperparameters = dataclasses.field(
        default_factory=AgenticHyperparameters)
    actor_gen_n_mbs: int = 1
    actor_train_n_mbs: int = 1
    critic_inf_n_mbs: int = 1
    critic_train_n_mbs: int = 1
    ref_inf_n_mbs: int = 1
    #: episodes per actor_gen MFC; None = the train batch size
    actor_gen_n_seqs: Optional[int] = None

    def build(self) -> ExperimentSpec:
        p, a = self.ppo, self.agentic
        gconfig = dict(
            max_new_tokens=p.max_new_tokens,
            min_new_tokens=p.min_new_tokens,
            greedy=p.greedy, top_p=p.top_p, top_k=p.top_k,
            temperature=p.temperature,
            # the episode path never replays sampling logits masks
            force_no_logits_mask=True)
        actor_args = dict(
            n_minibatches=p.ppo_n_minibatches, gconfig=gconfig,
            kl_ctl=p.kl_ctl, discount=p.discount,
            gae_lambda=p.gae_lambda,
            eps_clip=p.eps_clip, max_reward_clip=p.max_reward_clip,
            early_stop_imp_ratio=p.early_stop_imp_ratio,
            max_staleness=p.max_staleness,
            staleness_is_clip=p.staleness_is_clip,
            adv_norm=p.adv_norm,
            use_adaptive_kl_ctl=p.use_adaptive_kl_ctl,
            value_norm=p.value_norm, value_norm_type=p.value_norm_type,
            value_norm_beta=p.value_norm_beta,
            value_norm_eps=p.value_norm_eps,
            turn_level_credit=a.turn_level_credit)
        gen_args = dict(actor_args, env=a.env, env_args=dict(a.env_args),
                        max_turns=a.max_turns,
                        max_context_len=a.max_context_len,
                        max_concurrent=a.max_concurrent)
        critic_args = dict(
            n_minibatches=p.ppo_n_minibatches, kl_ctl=p.kl_ctl,
            discount=p.discount, gae_lambda=p.gae_lambda,
            value_eps_clip=p.value_eps_clip,
            max_reward_clip=p.max_reward_clip,
            use_adaptive_kl_ctl=p.use_adaptive_kl_ctl,
            value_norm=p.value_norm, value_norm_type=p.value_norm_type,
            value_norm_beta=p.value_norm_beta,
            value_norm_eps=p.value_norm_eps,
            turn_level_credit=a.turn_level_credit)
        gen_itf = ModelInterfaceAbstraction("agentic_actor", gen_args)
        actor_itf = ModelInterfaceAbstraction("ppo_actor", actor_args)
        critic_itf = ModelInterfaceAbstraction("ppo_critic", critic_args)
        n = self.dataset.train_bs_n_seqs
        gen_outputs = ("seq_no_eos_mask", "packed_input_ids",
                       "packed_logprobs", "prompt_mask", "rewards",
                       "dense_rewards")
        train_inputs = ("packed_input_ids", "packed_logprobs",
                        "packed_ref_logprobs", "rewards",
                        "dense_rewards", "values", "prompt_mask",
                        "seq_no_eos_mask")
        mfcs = [
            MFCDef(name="actor_gen", n_seqs=self.actor_gen_n_seqs or n,
                   interface_type=ModelInterfaceType.GENERATE,
                   interface_impl=gen_itf, model_name="actor",
                   input_keys=("packed_prompts",),
                   output_keys=gen_outputs,
                   n_mbs=self.actor_gen_n_mbs),
            MFCDef(name="ref_inf", n_seqs=n,
                   interface_type=ModelInterfaceType.INFERENCE,
                   interface_impl=actor_itf, model_name="ref",
                   input_keys=("packed_input_ids",),
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
                   interface_impl=gen_itf, model_name="actor",
                   input_keys=train_inputs,
                   log_return_value=True,
                   n_mbs=self.actor_train_n_mbs),
            MFCDef(name="critic_train", n_seqs=n,
                   interface_type=ModelInterfaceType.TRAIN_STEP,
                   interface_impl=critic_itf, model_name="critic",
                   input_keys=train_inputs,
                   log_return_value=True,
                   n_mbs=self.critic_train_n_mbs),
        ]
        ds_args = dict(n_prompts=a.n_prompts)
        if self.dataset.path:
            ds_args = dict(dataset_path=self.dataset.path)
        return ExperimentSpec(
            experiment_name=self.experiment_name,
            trial_name=self.trial_name,
            models={
                "actor": self.actor.to_spec(train=True),
                "critic": dataclasses.replace(
                    self.critic.to_spec(train=True), is_critic=True),
                "ref": self.ref.to_spec(train=False),
            },
            mfcs=mfcs,
            dataset=DatasetAbstraction(a.dataset_type, args=ds_args),
            tokenizer_path=self.tokenizer_path or self.actor.path,
            total_train_epochs=self.total_train_epochs,
            seed=self.seed,
            ctl=self.ctl())


register_experiment("agentic", AgenticPPOConfig)
