"""Optimizer-state checkpoints, in the JAX package's file format.

One ``optimizer_state.npz`` beside the weights: members ``l{i}.npy``,
the leaves of the JAX package's optimizer state in its tree order
(``Engine.iter_opt_state_numpy`` writes the port's AdamW state in that
order), plus ``__meta__`` (leaf count and dtypes). bfloat16 leaves
travel as ``uint16`` views; 0-d leaves (the step counts) stay 0-d. A
structure fingerprint (leaf count, shapes, dtypes) guards the restore:
a state saved for another model or optimizer setup is skipped with a
warning, and the engine starts fresh.
"""

import json
import os
import zipfile
from typing import Iterable, List, Optional, Tuple

import numpy as np
from numpy.lib import format as npformat

from realhf_tpu_torch.base import logging
from realhf_tpu_torch.base.safetensors_io import BF16, is_bf16

logger = logging.getLogger("opt_checkpoint")

FILENAME = "optimizer_state.npz"


def _to_savable(a: np.ndarray):
    if is_bf16(a):
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def save_opt_state(path: str, host_leaves: List[np.ndarray]) -> str:
    """Write host leaves (``Engine.opt_state_numpy()``) to
    ``path/optimizer_state.npz``."""
    return save_opt_state_iter(path, iter(host_leaves))


def save_opt_state_iter(path: str, leaves: Iterable[np.ndarray]) -> str:
    """Write the leaves of an iterator into the npz one at a time (the
    zip of ``.npy`` members ``np.savez`` makes), so one leaf is on the
    host at a time."""
    out = os.path.join(path, FILENAME)
    dtypes = []
    n = 0
    with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for a in leaves:
            arr, dt = _to_savable(np.asarray(a))
            dtypes.append(dt)
            with zf.open(f"l{n}.npy", "w", force_zip64=True) as fh:
                # not ascontiguousarray: it makes 0-d leaves 1-d
                npformat.write_array(fh, np.asarray(arr, order="C"))
            n += 1
        meta = np.frombuffer(
            json.dumps({"n": n, "dtypes": dtypes}).encode(), dtype=np.uint8)
        with zf.open("__meta__.npy", "w", force_zip64=True) as fh:
            npformat.write_array(fh, meta)
    return out


def load_opt_state_checked(path: str) -> Tuple[
        Optional[List[np.ndarray]], Optional[str]]:
    """Read ``path/optimizer_state.npz`` -> (host leaves, None), or
    (None, the reason: no file, a short file, a corrupt member)."""
    f = os.path.join(path, FILENAME)
    if not os.path.exists(f):
        return None, f"no optimizer state at {f}"
    try:
        with np.load(f) as z:
            if "__meta__" not in z:
                raise ValueError("missing __meta__ member")
            meta = json.loads(bytes(z["__meta__"]).decode())
            expected = int(meta["n"])
            leaves = []
            for i in range(expected):
                if f"l{i}" not in z:
                    raise ValueError(
                        f"short file: {len(leaves)} of {expected} "
                        "leaves present")
                a = z[f"l{i}"]
                if meta["dtypes"][i] == "bfloat16":
                    a = a.view(BF16)
                leaves.append(a)
    except Exception as e:  # noqa: BLE001 - reason surfaces to caller
        reason = (f"unreadable optimizer state shard {f}: "
                  f"{type(e).__name__}: {e}")
        logger.warning("%s", reason)
        return None, reason
    return leaves, None


def restore_engine_opt_state(engine, path: str) -> bool:
    """Install a saved state into an engine if its structure matches;
    True when restored."""
    if engine.optimizer is None:
        return False
    leaves, reason = load_opt_state_checked(path)
    if leaves is None:
        if reason is not None and "no optimizer state" not in reason:
            logger.warning("Optimizer state NOT restored: %s", reason)
        return False
    cur = engine.opt_state_spec()
    ok = len(cur) == len(leaves) and all(
        shape == tuple(l.shape) and dtype == l.dtype
        for (shape, dtype), l in zip(cur, leaves))
    if not ok:
        logger.warning(
            "Saved optimizer state at %s does not match the engine's "
            "structure (%d vs %d leaves); starting fresh.", path,
            len(leaves), len(cur))
        return False
    engine.load_opt_state(leaves)
    logger.info("Restored optimizer state from %s (%d leaves).", path,
                len(leaves))
    return True
