"""Weight hot-swap handle for long-running generation services.

A trainer (or a worker command handler) pushes fresh parameters with a
monotonically increasing version from any thread; the serving
scheduler installs them between decode iterations -- never mid-chunk,
so every decode step runs under exactly one weight version and every
sequence can be stamped with the versions it was generated under
(AReaL-style bounded-staleness rollouts).
"""

import threading
from typing import Callable, Optional

from realhf_tpu_torch.base import logging

logger = logging.getLogger("serving.weight_sync")


def _snapshot_tree(params):
    """A copy of a param tree: every tensor leaf cloned on its own
    device, numpy leaves copied, each member's tree of a ``MemberParams``
    copied so (members sharing a tree share its copy), anything else
    kept. The caller may then update its own tree in place (a training
    step does) without changing the pending swap."""
    import dataclasses

    import numpy as np
    import torch

    from realhf_tpu_torch.models.sharding import MemberParams

    def snap(x):
        if isinstance(x, MemberParams):
            copies = {}
            for tr in x.trees:
                if id(tr) not in copies:
                    copies[id(tr)] = snap(tr)
            return dataclasses.replace(
                x, trees=[copies[id(tr)] for tr in x.trees])
        if isinstance(x, dict):
            return {k: snap(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor):
            return x.detach().clone()
        if isinstance(x, np.ndarray):
            return np.array(x, copy=True)
        return x  # scalars / static aux data

    return snap(params)


class WeightSync:
    """Thread-safe pending-weights mailbox. At most one pending swap is
    held: a newer push overwrites an older one that was never
    installed (the scheduler only ever wants the freshest weights)."""

    def __init__(self, version: int = 0):
        self._lock = threading.Lock()
        self._version = version
        self._pending: Optional[tuple] = None  # (version, params)
        self.swaps_installed = 0

    @property
    def version(self) -> int:
        """Version of the weights currently INSTALLED in the backend
        (pending pushes don't count until the scheduler swaps them)."""
        with self._lock:
            return self._version

    @property
    def pending_version(self) -> Optional[int]:
        with self._lock:
            return self._pending[0] if self._pending else None

    def push(self, params, version: int, copy: bool = True):
        """Offer new weights. ``version`` must exceed both the
        installed and any pending version (monotonic -- a stale push
        indicates a reordered delivery and is refused loudly).

        Ownership contract: with ``copy=True`` (the default) the
        mailbox snapshots every leaf, so the caller remains free to
        update its own tree in place right after ``push`` returns; the
        pending swap cannot be corrupted underneath the scheduler. Pass
        ``copy=False`` ONLY when the caller hands over freshly made
        tensors it will never touch again."""
        if copy:
            params = _snapshot_tree(params)
        with self._lock:
            floor = max(self._version,
                        self._pending[0] if self._pending else -1)
            if version <= floor:
                raise ValueError(
                    f"WeightSync.push: version {version} is not newer "
                    f"than {floor} (pushes must be monotonic).")
            self._pending = (version, params)

    def poll(self, install: Callable[[object], None]) -> Optional[int]:
        """Install pending weights, if any, via ``install(params)``
        (e.g. ``backend.swap_params``). Returns the new version or
        None. Called by the scheduler between decode iterations."""
        with self._lock:
            if self._pending is None:
                return None
            version, params = self._pending
            self._pending = None
        # install OUTSIDE the lock: it may move a large tree and must
        # not block concurrent pushes
        install(params)
        with self._lock:
            self._version = version
            self.swaps_installed += 1
        logger.info("Installed weights v%d.", version)
        return version
