"""Flight recorder: a bounded ring of a process's recent events.

``record(event_kind, **detail)`` appends one event (a deque append
under a lock, cheap enough for hot paths); ``events()`` reads the
ring. The crash-time dump to disk comes with the observability slice
of the port.
"""

import collections
import threading
import time
from typing import Deque, Dict, List

DEFAULT_CAPACITY = 512


class FlightRecorder:

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self._events: Deque[Dict] = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def record(self, event_kind: str, **detail):
        """Append one event; the event kind owns the ``"kind"`` key (a
        ``kind=`` detail lands under ``kind_detail``)."""
        if "kind" in detail:
            detail["kind_detail"] = detail.pop("kind")
        ev = dict(ts=time.time(), kind=event_kind, **detail)
        with self._lock:
            self._events.append(ev)

    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)


_default = FlightRecorder()


def default_recorder() -> FlightRecorder:
    return _default


def reset_default():
    """A fresh default recorder (test isolation)."""
    global _default
    _default = FlightRecorder()


def record(event_kind: str, **detail):
    _default.record(event_kind, **detail)
