"""Recover info: what a resumed run needs besides the checkpoint.

The runner dumps a ``RecoverInfo`` with each save when its
``recover_mode`` is not "disabled": the step counters and the data ids
consumed in the interrupted epoch. The fields and schema versions are
the JAX package's (``base/recover.py``). Dumps are atomic (tmp + fsync +
rename); ``load_safe`` turns a missing, truncated, corrupt or
future-schema file into None, a fresh start.

A file the JAX package wrote pickles
``realhf_tpu.base.recover.{StepInfo,RecoverInfo}``. It loads here
without importing that package: the unpickler maps those two names, and
this module's own, to the classes below and refuses every other class.
"""

import dataclasses
import io
import os
import pickle
from typing import Any, Dict, Hashable, List, Optional

from realhf_tpu_torch.base import constants, logging

logger = logging.getLogger("recover")

#: Schema history (the JAX package's):
#:   1: recover_start/last_step_info/hash_vals_to_ignore (implicit,
#:      pre-versioning pickles)
#:   2: + version, buffer_state, dataloader_state
#:   3: + ckpt_manifests (role -> committed durable-checkpoint manifest)
#:   4: buffer_state holds the per-sample SequenceBuffer snapshot; no
#:      field changed. The inline runner writes no buffer_state.
RECOVER_INFO_VERSION = 4


@dataclasses.dataclass
class StepInfo:
    epoch: int = 0
    epoch_step: int = 0
    global_step: int = 0


@dataclasses.dataclass
class RecoverInfo:
    version: int = RECOVER_INFO_VERSION
    recover_start: StepInfo = dataclasses.field(default_factory=StepInfo)
    last_step_info: StepInfo = dataclasses.field(default_factory=StepInfo)
    hash_vals_to_ignore: List[Hashable] = dataclasses.field(
        default_factory=list)
    #: the distributed runtime's buffer snapshot (unused by the port)
    buffer_state: Optional[Dict[str, Any]] = None
    #: dataloader epoch accounting: {"epoch", "epoch_step", ...}
    dataloader_state: Optional[Dict[str, Any]] = None
    #: role -> manifest path of the last committed durable checkpoint
    #: (the JAX package's ``system/ckpt_manager.py``; unused by the port)
    ckpt_manifests: Optional[Dict[str, str]] = None


_CLASSES = {(mod, cls.__name__): cls
            for mod in ("realhf_tpu.base.recover", __name__)
            for cls in (StepInfo, RecoverInfo)}


class _Unpickler(pickle.Unpickler):

    def find_class(self, module, name):
        cls = _CLASSES.get((module, name))
        if cls is None:
            raise pickle.UnpicklingError(
                f"recover info may hold only StepInfo and RecoverInfo, "
                f"not {module}.{name}")
        return cls


def dump_path(experiment: Optional[str] = None,
              trial: Optional[str] = None) -> str:
    return os.path.join(constants.recover_root(experiment, trial),
                        "recover_info.pkl")


def dump(info: RecoverInfo, experiment: Optional[str] = None,
         trial: Optional[str] = None):
    """Atomic dump: a crash mid-write never leaves a torn file where the
    previous one stood."""
    path = dump_path(experiment, trial)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(info, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _upgrade(info: RecoverInfo) -> RecoverInfo:
    """Fill the fields an older-schema pickle lacks (pickle restores
    ``__dict__`` as it was)."""
    had_version = "version" in info.__dict__
    for f in dataclasses.fields(RecoverInfo):
        if f.name not in info.__dict__:
            default = (f.default_factory() if f.default_factory
                       is not dataclasses.MISSING else f.default)
            setattr(info, f.name, default)
    if not had_version:
        info.version = 1
    return info


def load(experiment: Optional[str] = None,
         trial: Optional[str] = None) -> RecoverInfo:
    """Strict load: raises on a missing or corrupt file."""
    with open(dump_path(experiment, trial), "rb") as f:
        info = _Unpickler(io.BytesIO(f.read())).load()
    if not isinstance(info, RecoverInfo):
        raise ValueError(f"recover_info.pkl holds {type(info)!r}, "
                         "not RecoverInfo")
    return _upgrade(info)


def load_safe(experiment: Optional[str] = None,
              trial: Optional[str] = None) -> Optional[RecoverInfo]:
    """Load for resume: None (a fresh start) when the file is absent,
    truncated, corrupt, of a future schema, or not a RecoverInfo."""
    path = dump_path(experiment, trial)
    if not os.path.isfile(path):
        return None
    try:
        info = load(experiment, trial)
    except Exception as e:  # noqa: BLE001 - any corruption -> fresh
        logger.warning("Ignoring unreadable recover info at %s (%s); "
                       "starting fresh.", path, e)
        return None
    if info.version > RECOVER_INFO_VERSION:
        logger.warning(
            "Recover info at %s has schema v%d > supported v%d "
            "(written by newer code); starting fresh.", path,
            info.version, RECOVER_INFO_VERSION)
        return None
    return info


def exists(experiment: Optional[str] = None,
           trial: Optional[str] = None) -> bool:
    return os.path.isfile(dump_path(experiment, trial))
