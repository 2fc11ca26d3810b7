"""Core configuration data model: model identities, interface types,
and the registry-resolved "abstraction" configs (``type_`` + ``args``)
that instantiate datasets and interfaces at run time."""

import dataclasses
import enum
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class ModelName:
    """Unique identity of one model instance in the dataflow graph.
    Several MFCs may refer to the same *role* (e.g. "actor")."""
    role: str
    replica_id: int = 0

    def __repr__(self):
        return f"{self.role}@{self.replica_id}"


class ModelInterfaceType(enum.Enum):
    GENERATE = "generate"
    TRAIN_STEP = "train_step"
    EVALUATE = "evaluate"
    INFERENCE = "inference"


@dataclasses.dataclass
class ModelInterfaceAbstraction:
    """Registry-resolved interface config."""
    type_: str
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DatasetAbstraction:
    type_: str
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)
