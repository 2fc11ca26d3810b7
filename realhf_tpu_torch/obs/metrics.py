"""Process-wide counters.

Monotone totals by name and label set, in one default registry, so an
instrumentation site is one line (``metrics.inc(name, **labels)``).
Only counters for now: gauges, summaries, histograms, exporters and the
JSONL sink come with the observability slice of the port.
"""

import threading
from typing import Any, Dict, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels):
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)


class MetricsRegistry:
    """Get-or-create counter store for one process."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name)
            return self._counters[name]

    def inc(self, name: str, amount: float = 1.0, **labels):
        self.counter(name).inc(amount, **labels)


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default


def reset_default():
    """A fresh default registry (test isolation)."""
    global _default
    _default = MetricsRegistry()


def inc(name: str, amount: float = 1.0, **labels):
    _default.inc(name, amount, **labels)
