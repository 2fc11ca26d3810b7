"""Common experiment config: the CLI surface shared by all algorithms.

The quickstart CLI builds one of these dataclasses from dotted
``a.b.c=value`` overrides.
"""

import dataclasses
import typing
from typing import Any, Callable, Dict, Optional, get_args, get_origin

from realhf_tpu_torch.api.experiment import (
    ModelSpec,
    ParallelismConfig,
    SaveEvalControl,
)
from realhf_tpu_torch.engine.optim import OptimizerConfig
from realhf_tpu_torch.models.config import llama_config


@dataclasses.dataclass
class ModelConfigCLI:
    """CLI view of one model."""
    path: Optional[str] = None
    #: named LLaMA size ("tiny", "125m", "1b", "7b") of random weights,
    #: used when ``path`` is None
    random_init_size: Optional[str] = None
    bf16: bool = True
    gradient_checkpointing: bool = True
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    parallel: ParallelismConfig = dataclasses.field(
        default_factory=ParallelismConfig)

    def to_spec(self, train: bool = True) -> ModelSpec:
        """The spec of this model; ``train`` gives it its optimizer."""
        return ModelSpec(
            path=self.path,
            random_init_config=(llama_config(self.random_init_size)
                                if self.random_init_size else None),
            optimizer=self.optimizer if train else None,
            parallel=self.parallel,
            gradient_checkpointing=self.gradient_checkpointing,
            bf16=self.bf16)


@dataclasses.dataclass
class DatasetConfigCLI:
    path: str = ""
    max_seqlen: int = 1024
    train_bs_n_seqs: int = 256
    pad_to_max_length: bool = False
    valid_path: Optional[str] = None


@dataclasses.dataclass
class CommonExperimentConfig:
    experiment_name: str = "exp"
    trial_name: str = "trial"
    seed: int = 1
    total_train_epochs: int = 1
    tokenizer_path: Optional[str] = None
    save_freq_epochs: Optional[int] = None
    save_freq_steps: Optional[int] = None
    save_freq_secs: Optional[float] = None
    eval_freq_epochs: Optional[int] = None
    eval_freq_steps: Optional[int] = None
    benchmark_steps: Optional[int] = None
    #: "cuda" (None) or "cpu"
    device: Optional[str] = None

    def ctl(self) -> SaveEvalControl:
        return SaveEvalControl(
            save_freq_epochs=self.save_freq_epochs,
            save_freq_steps=self.save_freq_steps,
            save_freq_secs=self.save_freq_secs,
            eval_freq_epochs=self.eval_freq_epochs,
            eval_freq_steps=self.eval_freq_steps,
            benchmark_steps=self.benchmark_steps)

    def build(self):
        raise NotImplementedError()


ALL_EXPERIMENT_CLASSES: Dict[str, Callable[[], CommonExperimentConfig]] = {}


def register_experiment(name: str, cls):
    if name in ALL_EXPERIMENT_CLASSES:
        raise ValueError(f"Experiment {name} already registered.")
    ALL_EXPERIMENT_CLASSES[name] = cls


# ----------------------------------------------------------------------
# Dotted key=value overrides onto nested dataclasses.
# ----------------------------------------------------------------------
def _convert(value: str, typ) -> Any:
    origin = get_origin(typ)
    if origin is not None:  # Optional[...] and friends
        args = [a for a in get_args(typ) if a is not type(None)]
        if value.lower() in ("none", "null"):
            return None
        return _convert(value, args[0]) if args else value
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    return value


def apply_overrides(cfg: Any, overrides: Dict[str, str]) -> Any:
    """Apply {'a.b.c': 'v'} onto a nested dataclass in place (frozen
    dataclasses on the path are replaced)."""
    for dotted, raw in overrides.items():
        parts = dotted.split(".")
        obj = cfg
        for p in parts[:-1]:
            if not hasattr(obj, p):
                raise AttributeError(
                    f"Unknown config path `{dotted}` (no field `{p}` on "
                    f"{type(obj).__name__}).")
            obj = getattr(obj, p)
        leaf = parts[-1]
        fields = {f.name: f for f in dataclasses.fields(obj)}
        if leaf not in fields:
            raise AttributeError(
                f"Unknown config field `{dotted}` on {type(obj).__name__}; "
                f"valid fields: {sorted(fields)}")
        typ = typing.get_type_hints(type(obj)).get(leaf, str)
        val = _convert(raw, typ)
        if getattr(type(obj), "__dataclass_params__").frozen:
            parent = cfg
            for p in parts[:-2]:
                parent = getattr(parent, p)
            setattr(parent, parts[-2],
                    dataclasses.replace(obj, **{leaf: val}))
        else:
            setattr(obj, leaf, val)
    return cfg
