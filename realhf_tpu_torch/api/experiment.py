"""Experiment specification: the models (role -> spec), the dataflow
graph of MFCs, the dataset and run control."""

import dataclasses
from typing import Dict, List, Optional

from realhf_tpu_torch.api.config import DatasetAbstraction
from realhf_tpu_torch.api.dfg import MFCDef
from realhf_tpu_torch.engine.optim import OptimizerConfig
from realhf_tpu_torch.parallel.mesh import ParallelismConfig

__all__ = ["ExperimentSpec", "ModelSpec", "ParallelismConfig",
           "SaveEvalControl"]


@dataclasses.dataclass
class ModelSpec:
    """One model role."""
    #: the HF family of the checkpoint at ``path`` and of saves
    hf_family: str = "llama"
    path: Optional[str] = None  # HF checkpoint dir; None = random init
    # used when path is None (tests, benchmarks, smoke runs)
    random_init_config: Optional[dict] = None
    is_critic: bool = False
    #: a critic from an actor's checkpoint: the LM head dropped, a fresh
    #: value head drawn as the JAX package draws it
    init_critic_from_actor: bool = False
    #: the optimizer of a trained role; None = inference only
    optimizer: Optional[OptimizerConfig] = None
    parallel: ParallelismConfig = dataclasses.field(
        default_factory=ParallelismConfig)
    gradient_checkpointing: bool = True
    bf16: bool = True
    #: restore the optimizer state saved beside ``path``; the resume path
    #: sets it, a new run from a checkpoint starts with a fresh one
    restore_optimizer_state: bool = False


@dataclasses.dataclass
class SaveEvalControl:
    """When the runner saves and evaluates trained roles (None = never)
    and when it stops early. The runner also saves once at the end."""
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
    #: roles that no MFC trains (ref, reward) move their weights to the
    #: host after their last MFC of a step, freeing device memory for
    #: the train MFCs, and reload before their next use
    auto_offload: bool = False
