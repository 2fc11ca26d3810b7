"""Experiment specification: the models (role -> spec), the dataflow
graph of MFCs, the dataset and run control."""

import dataclasses
from typing import Dict, List, Optional

from realhf_tpu_torch.api.config import DatasetAbstraction
from realhf_tpu_torch.api.dfg import MFCDef
from realhf_tpu_torch.engine.optim import OptimizerConfig


@dataclasses.dataclass(frozen=True)
class ParallelismConfig:
    """Layout of one model. This slice runs every model on one device;
    a layout of more than one device raises when the model is built."""
    data_parallel_size: int = 1
    tensor_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    context_parallel_size: int = 1

    @property
    def world_size(self) -> int:
        return (self.data_parallel_size * self.tensor_parallel_size
                * self.pipeline_parallel_size * self.context_parallel_size)


@dataclasses.dataclass
class ModelSpec:
    """One model role."""
    path: Optional[str] = None  # checkpoint dir; None = random init
    # used when path is None (tests, benchmarks, smoke runs)
    random_init_config: Optional[dict] = None
    is_critic: bool = False
    #: the optimizer of a trained role; None = inference only
    optimizer: Optional[OptimizerConfig] = None
    parallel: ParallelismConfig = dataclasses.field(
        default_factory=ParallelismConfig)
    gradient_checkpointing: bool = True
    bf16: bool = True


@dataclasses.dataclass
class SaveEvalControl:
    """When the runner saves and evaluates trained roles (None = never)
    and when it stops early. Saving raises until the checkpoint-IO
    slice of the port."""
    save_freq_epochs: Optional[int] = None
    save_freq_steps: Optional[int] = None
    save_freq_secs: Optional[float] = None
    eval_freq_epochs: Optional[int] = None
    eval_freq_steps: Optional[int] = None
    benchmark_steps: Optional[int] = None  # stop early after N steps


@dataclasses.dataclass
class ExperimentSpec:
    experiment_name: str
    trial_name: str
    models: Dict[str, ModelSpec]
    mfcs: List[MFCDef]
    dataset: DatasetAbstraction
    eval_dataset: Optional[DatasetAbstraction] = None
    tokenizer_path: Optional[str] = None
    tokenizer: Optional[object] = None  # direct object (tests, smoke runs)
    total_train_epochs: int = 1
    seed: int = 1
    ctl: SaveEvalControl = dataclasses.field(default_factory=SaveEvalControl)
