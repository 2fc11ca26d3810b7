"""Experiment and trial names, and the directories a run writes under.

The same layout and the same ``REALHF_TPU_ROOT`` variable as the JAX
package's ``base/constants.py``, so that both packages find each other's
checkpoints and recover info under one root:

- ``<root>/checkpoints/<user>/<experiment>/<trial>/<role>``: the weights
  and optimizer state a run saves (``run_save_path``);
- ``<root>/recover/<user>/<experiment>/<trial>/recover_info.pkl``.
"""

import getpass
import os
from pathlib import Path
from typing import Optional

#: read at each call, so a test may point it at a temporary directory
ROOT_DIR = os.environ.get(
    "REALHF_TPU_ROOT",
    os.path.join(os.path.expanduser("~"), ".cache", "realhf_tpu"))

_experiment_name: Optional[str] = None
_trial_name: Optional[str] = None


def set_experiment_trial_names(experiment_name: str, trial_name: str):
    global _experiment_name, _trial_name
    if "_" in experiment_name or "/" in experiment_name:
        raise ValueError(f"Invalid experiment name: {experiment_name}")
    if "_" in trial_name or "/" in trial_name:
        raise ValueError(f"Invalid trial name: {trial_name}")
    _experiment_name = experiment_name
    _trial_name = trial_name


def experiment_name() -> str:
    if _experiment_name is None:
        raise RuntimeError("Experiment name is not set.")
    return _experiment_name


def trial_name() -> str:
    if _trial_name is None:
        raise RuntimeError("Trial name is not set.")
    return _trial_name


def get_user() -> str:
    try:
        return getpass.getuser()
    except Exception:  # some containers lack a passwd entry
        return os.environ.get("USER", "unknown")


def model_save_root() -> str:
    return os.path.join(ROOT_DIR, "checkpoints", get_user())


def run_save_path(experiment: Optional[str] = None,
                  trial: Optional[str] = None) -> str:
    p = os.path.join(model_save_root(), experiment or experiment_name(),
                     trial or trial_name())
    Path(p).mkdir(parents=True, exist_ok=True)
    return p


def recover_root(experiment: Optional[str] = None,
                 trial: Optional[str] = None) -> str:
    p = os.path.join(ROOT_DIR, "recover", get_user(),
                     experiment or experiment_name(), trial or trial_name())
    Path(p).mkdir(parents=True, exist_ok=True)
    return p
