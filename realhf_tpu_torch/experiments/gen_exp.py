"""Generation experiment: batch generation over a prompt dataset,
optionally dumped to JSONL."""

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
class GenerationConfig(CommonExperimentConfig):
    model: ModelConfigCLI = dataclasses.field(default_factory=ModelConfigCLI)
    dataset: DatasetConfigCLI = dataclasses.field(
        default_factory=DatasetConfigCLI)
    max_new_tokens: int = 256
    min_new_tokens: int = 0
    greedy: bool = False
    top_p: float = 1.0
    top_k: int = 0
    temperature: float = 1.0
    output_file: Optional[str] = None
    n_mbs: int = 1

    def build(self) -> ExperimentSpec:
        gconfig = dict(
            max_new_tokens=self.max_new_tokens,
            min_new_tokens=self.min_new_tokens,
            greedy=self.greedy, top_p=self.top_p, top_k=self.top_k,
            temperature=self.temperature, force_no_logits_mask=True)
        mfc = MFCDef(
            name="gen",
            n_seqs=self.dataset.train_bs_n_seqs,
            interface_type=ModelInterfaceType.GENERATE,
            interface_impl=ModelInterfaceAbstraction(
                "generation", dict(gconfig=gconfig,
                                   output_file=self.output_file)),
            model_name="default",
            input_keys=("packed_prompts",),
            n_mbs=self.n_mbs)
        dataset = DatasetAbstraction(
            "prompt", args=dict(max_length=self.dataset.max_seqlen,
                                dataset_path=self.dataset.path))
        return ExperimentSpec(
            experiment_name=self.experiment_name,
            trial_name=self.trial_name,
            models={"default": self.model.to_spec(train=False)},
            mfcs=[mfc],
            dataset=dataset,
            tokenizer_path=self.tokenizer_path or self.model.path,
            total_train_epochs=self.total_train_epochs,
            seed=self.seed,
            ctl=self.ctl())


register_experiment("gen", GenerationConfig)
