"""DPO experiment: the reference model's inference MFC (per-sequence
answer log-prob sums) feeding the policy's train MFC."""

import dataclasses

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
class DPOConfig(CommonExperimentConfig):
    actor: ModelConfigCLI = dataclasses.field(default_factory=ModelConfigCLI)
    ref: ModelConfigCLI = dataclasses.field(default_factory=ModelConfigCLI)
    dataset: DatasetConfigCLI = dataclasses.field(
        default_factory=DatasetConfigCLI)
    beta: float = 0.1
    max_pairs_per_prompt: int = 2
    n_mbs: int = 1

    def build(self) -> ExperimentSpec:
        itf = ModelInterfaceAbstraction("dpo", dict(beta=self.beta))
        ref_inf = MFCDef(
            name="ref_inf",
            n_seqs=self.dataset.train_bs_n_seqs,
            interface_type=ModelInterfaceType.INFERENCE,
            interface_impl=itf,
            model_name="ref",
            input_keys=("packed_input_ids", "prompt_lens"),
            output_keys=("seqlogp",))
        train = MFCDef(
            name="actor_train",
            n_seqs=self.dataset.train_bs_n_seqs,
            interface_type=ModelInterfaceType.TRAIN_STEP,
            interface_impl=itf,
            model_name="actor",
            input_keys=("packed_input_ids", "prompt_lens", "seqlogp"),
            log_return_value=True,
            n_mbs=self.n_mbs)
        dataset = DatasetAbstraction(
            "rw_pair",
            args=dict(max_length=self.dataset.max_seqlen,
                      max_pairs_per_prompt=self.max_pairs_per_prompt,
                      dataset_path=self.dataset.path))
        return ExperimentSpec(
            experiment_name=self.experiment_name,
            trial_name=self.trial_name,
            models={"actor": self.actor.to_spec(train=True),
                    "ref": self.ref.to_spec(train=False)},
            mfcs=[ref_inf, train],
            dataset=dataset,
            tokenizer_path=self.tokenizer_path or self.actor.path,
            total_train_epochs=self.total_train_epochs,
            seed=self.seed,
            ctl=self.ctl())


register_experiment("dpo", DPOConfig)
