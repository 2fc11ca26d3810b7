"""Model API: the Model wrapper, the ModelInterface base class, and the
interface registry that MFC nodes name their handlers by."""

import abc
import dataclasses
from typing import Any, Callable, Dict, Optional

from realhf_tpu_torch.api.config import ModelInterfaceAbstraction, ModelName
from realhf_tpu_torch.api.data import SequenceSample


@dataclasses.dataclass
class ModelVersion:
    """Train steps an interface has taken on a model (one per
    ``train_step`` call, however many optimizer steps it makes)."""
    epoch: int = 0
    epoch_step: int = 0
    global_step: int = 0

    def inc(self):
        self.epoch_step += 1
        self.global_step += 1


@dataclasses.dataclass
class Model:
    """One model instance on one device."""
    name: ModelName
    engine: Any  # realhf_tpu_torch.engine.engine.Engine
    tokenizer: Any
    #: the HF family its checkpoints are saved as (``models/hf``)
    hf_family: str = "llama"
    version: ModelVersion = dataclasses.field(default_factory=ModelVersion)

    @property
    def config(self):
        return self.engine.cfg

    def inc_version(self):
        self.version.inc()


class ModelInterface(abc.ABC):
    """Algorithm handlers; each defaults to unimplemented (evaluation
    to no stats)."""

    def evaluate(self, model: Model, eval_dataloader) -> Dict:
        return {}

    def save(self, model: Model, save_dir: str, host_params=None):
        """Write the model's HF-layout checkpoint to ``save_dir``;
        ``host_params``, when given, is a host numpy copy of the weights
        (``Engine.params_numpy()``), else the save streams one layer at a
        time from the device. The base interface saves nothing."""
        pass

    def inference(self, model: Model, input_: SequenceSample,
                  n_mbs: Optional[int] = None) -> SequenceSample:
        raise NotImplementedError()

    def generate(self, model: Model, input_: SequenceSample,
                 n_mbs: Optional[int] = None) -> SequenceSample:
        raise NotImplementedError()

    def train_step(self, model: Model, input_: SequenceSample,
                   n_mbs: Optional[int] = None) -> Dict:
        raise NotImplementedError()


ALL_INTERFACE_CLASSES: Dict[str, Callable[..., ModelInterface]] = {}


def register_interface(name: str, cls):
    if name in ALL_INTERFACE_CLASSES:
        raise ValueError(f"Interface {name} already registered.")
    ALL_INTERFACE_CLASSES[name] = cls


def make_interface(cfg: ModelInterfaceAbstraction) -> ModelInterface:
    return ALL_INTERFACE_CLASSES[cfg.type_](**cfg.args)
