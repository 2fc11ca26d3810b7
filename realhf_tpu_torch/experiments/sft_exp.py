"""SFT experiment: one model, one train_step MFC over prompt-answer
data, evaluated on ``dataset.valid_path`` when it is given."""

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
class SFTConfig(CommonExperimentConfig):
    model: ModelConfigCLI = dataclasses.field(default_factory=ModelConfigCLI)
    dataset: DatasetConfigCLI = dataclasses.field(
        default_factory=DatasetConfigCLI)
    n_mbs: int = 1

    def build(self) -> ExperimentSpec:
        mfc = MFCDef(
            name="trainDefault",
            n_seqs=self.dataset.train_bs_n_seqs,
            interface_type=ModelInterfaceType.TRAIN_STEP,
            interface_impl=ModelInterfaceAbstraction("sft"),
            model_name="default",
            input_keys=("packed_input_ids", "prompt_mask"),
            log_return_value=True,
            n_mbs=self.n_mbs)
        dataset = DatasetAbstraction(
            "prompt_answer",
            args=dict(max_length=self.dataset.max_seqlen,
                      dataset_path=self.dataset.path,
                      pad_to_max_length=self.dataset.pad_to_max_length))
        eval_dataset = None
        if self.dataset.valid_path:
            eval_dataset = DatasetAbstraction(
                "prompt_answer",
                args=dict(max_length=self.dataset.max_seqlen,
                          dataset_path=self.dataset.valid_path))
        return ExperimentSpec(
            experiment_name=self.experiment_name,
            trial_name=self.trial_name,
            models={"default": self.model.to_spec(train=True)},
            mfcs=[mfc],
            dataset=dataset,
            eval_dataset=eval_dataset,
            tokenizer_path=self.tokenizer_path or self.model.path,
            total_train_epochs=self.total_train_epochs,
            seed=self.seed,
            ctl=self.ctl())


register_experiment("sft", SFTConfig)
