"""Admission-controlled request queue for the rollout service.

The front door of the serving subsystem: every
incoming generation request passes through :class:`RequestQueue`,
which enforces a bounded queue depth (backpressure: reject with a
``retry_after`` hint instead of growing until host OOM), per-request
deadlines (expired entries never reach a decode slot), and priority
classes (interactive traffic overtakes batch rollouts at admission,
Orca/vLLM-style). The queue itself is policy-free about WHAT runs --
the :class:`~realhf_tpu_torch.serving.scheduler.ContinuousScheduler` pops
from it whenever a decode slot frees up.

Thread-safe: the server's socket pump and a worker's command thread
may submit/cancel while the scheduler thread pops.
"""

import dataclasses
import enum
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from realhf_tpu_torch.base import logging
from realhf_tpu_torch.obs import metrics as obs_metrics
from realhf_tpu_torch.serving import protocol

logger = logging.getLogger("serving.request_queue")


def count_expired(req: "GenRequest", n: int = 1):
    """Bump the per-class deadline-expiry counter
    (``serving_expired_total{class}``): every path that turns a
    request into the declared ``expired`` terminal -- queue shunt
    here, parked/active eviction in the scheduler -- attributes the
    loss to its admission class, so an SLO dashboard can tell
    interactive misses from batch absorption."""
    obs_metrics.inc("serving_expired_total", n,
                    **{"class": Priority(req.priority).name})


class Priority(enum.IntEnum):
    """Admission classes, served strictly in ascending order (FIFO
    within a class). ROLLOUT is the async-RLHF producer traffic that
    must never starve INTERACTIVE users."""
    INTERACTIVE = 0
    BATCH = 1
    ROLLOUT = 2


@dataclasses.dataclass
class GenRequest:
    """One queued generation request."""
    rid: str
    prompt: np.ndarray                    # [len] int32 token ids
    priority: Priority = Priority.BATCH
    #: absolute deadline on the queue's clock; None = no deadline.
    deadline: Optional[float] = None
    submitted_at: float = 0.0
    #: reject at admission unless the server's weights are at least
    #: this fresh (a trainer-side client can insist on post-update
    #: rollouts).
    min_weight_version: int = 0
    #: filled by the scheduler when the request enters a slot
    started_at: Optional[float] = None


@dataclasses.dataclass
class AdmissionVerdict:
    accepted: bool
    reason: str = ""
    #: backpressure hint (seconds) for rejected requests; the client
    #: should resubmit no sooner than this.
    retry_after: Optional[float] = None


class RequestQueue:
    """Bounded, deadline- and priority-aware admission queue.

    ``n_slots`` sizes the ``retry_after`` estimate: with a service-time
    EMA of ``s`` seconds per sequence and ``d`` requests queued, a new
    arrival would wait roughly ``s * (d + 1) / n_slots``.
    """

    def __init__(self, max_depth: int = 256, n_slots: int = 1,
                 max_prompt_len: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.max_depth = max_depth
        self.n_slots = max(1, n_slots)
        #: longest admissible prompt (tokens); None = unchecked. The
        #: server fills this from the backend so oversized prompts are
        #: rejected at admission instead of tripping a fill_slot error
        #: deep inside the scheduler.
        self.max_prompt_len = max_prompt_len
        self._clock = clock
        self._lock = threading.Lock()
        self._by_class: Dict[Priority, List[GenRequest]] = {
            p: [] for p in Priority}
        self._expired: List[GenRequest] = []
        self._draining = False
        # EMA of observed per-sequence service seconds (queue->done);
        # seeds at 1s so the very first backpressure hint is sane.
        self._service_ema = 1.0
        self.stats = dict(submitted=0, rejected=0, expired=0,
                          cancelled=0, popped=0)

    # -- admission -----------------------------------------------------
    def submit(self, req: GenRequest,
               current_weight_version: int = 0) -> AdmissionVerdict:
        now = self._clock()
        req.submitted_at = req.submitted_at or now
        with self._lock:
            if self._draining:
                self.stats["rejected"] += 1
                return AdmissionVerdict(
                    False, reason=protocol.REASON_DRAINING)
            if req.deadline is not None and req.deadline <= now:
                self.stats["rejected"] += 1
                return AdmissionVerdict(
                    False, reason=protocol.REASON_EXPIRED)
            if (self.max_prompt_len is not None
                    and len(req.prompt) > self.max_prompt_len):
                self.stats["rejected"] += 1
                return AdmissionVerdict(
                    False, reason=protocol.REASON_PROMPT_TOO_LONG)
            if req.min_weight_version > current_weight_version:
                self.stats["rejected"] += 1
                return AdmissionVerdict(
                    False, reason=protocol.REASON_WEIGHTS_BEHIND,
                    retry_after=self._service_ema)
            depth = sum(len(q) for q in self._by_class.values())
            if depth >= self.max_depth:
                self.stats["rejected"] += 1
                return AdmissionVerdict(
                    False, reason=protocol.REASON_BACKPRESSURE,
                    retry_after=self._retry_after(depth))
            self._by_class[Priority(req.priority)].append(req)
            self.stats["submitted"] += 1
            return AdmissionVerdict(True)

    def _retry_after(self, depth: int) -> float:
        return max(0.05, self._service_ema * (depth + 1) / self.n_slots)

    def note_service_time(self, secs: float):
        """Feed one completed request's queue->done wall span into the
        backpressure estimator."""
        with self._lock:
            self._service_ema = 0.8 * self._service_ema + 0.2 * max(
                1e-3, secs)

    # -- consumption ---------------------------------------------------
    def pop(self) -> Optional[GenRequest]:
        """Highest-priority non-expired request (FIFO within class);
        entries whose deadline passed are shunted to the expired list
        (``take_expired``) instead of wasting a prefill."""
        now = self._clock()
        with self._lock:
            for p in Priority:
                q = self._by_class[p]
                while q:
                    req = q.pop(0)
                    if req.deadline is not None and req.deadline <= now:
                        self._expired.append(req)
                        self.stats["expired"] += 1
                        count_expired(req)
                        continue
                    self.stats["popped"] += 1
                    return req
            return None

    def take_expired(self) -> List[GenRequest]:
        """Requests that expired while queued since the last call (the
        server turns these into client notifications)."""
        with self._lock:
            out, self._expired = self._expired, []
            return out

    def cancel(self, rid: str) -> bool:
        with self._lock:
            for q in self._by_class.values():
                for i, req in enumerate(q):
                    if req.rid == rid:
                        del q[i]
                        self.stats["cancelled"] += 1
                        return True
            return False

    # -- shutdown ------------------------------------------------------
    def start_drain(self) -> List[GenRequest]:
        """Refuse all future admissions and return (removing) every
        still-queued request so the server can bounce them to their
        clients -- graceful shutdown leaves no orphaned entries."""
        with self._lock:
            self._draining = True
            out: List[GenRequest] = []
            for p in Priority:
                out.extend(self._by_class[p])
                self._by_class[p] = []
            return out

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def __len__(self):
        with self._lock:
            return sum(len(q) for q in self._by_class.values())

    def __bool__(self):
        # an EMPTY queue is still a queue: without this, __len__ makes
        # `queue or default` silently replace a caller-provided empty
        # queue
        return True

    def depth_by_class(self) -> Dict[str, int]:
        with self._lock:
            return {p.name: len(q) for p, q in self._by_class.items()}
