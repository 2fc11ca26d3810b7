"""Reward-model experiment: one critic-mode model and one train MFC
over paired (pos, neg) data."""

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
class RWConfig(CommonExperimentConfig):
    model: ModelConfigCLI = dataclasses.field(default_factory=ModelConfigCLI)
    dataset: DatasetConfigCLI = dataclasses.field(
        default_factory=DatasetConfigCLI)
    max_pairs_per_prompt: int = 2
    n_mbs: int = 1

    def build(self) -> ExperimentSpec:
        self.model.is_critic = True
        mfc = MFCDef(
            name="trainDefault",
            n_seqs=self.dataset.train_bs_n_seqs,
            interface_type=ModelInterfaceType.TRAIN_STEP,
            interface_impl=ModelInterfaceAbstraction("paired_rw"),
            model_name="default",
            input_keys=("packed_input_ids", "prompt_lens"),
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
            models={"default": self.model.to_spec(train=True)},
            mfcs=[mfc],
            dataset=dataset,
            tokenizer_path=self.tokenizer_path or self.model.path,
            total_train_epochs=self.total_train_epochs,
            seed=self.seed,
            ctl=self.ctl())


register_experiment("rw", RWConfig)
