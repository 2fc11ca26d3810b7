"""Scoped host-clock spans.

``span(name, **attributes)`` is a context manager around a piece of
host work (a prefill, a decode chunk, a verify round). The tracer is
off by default and then every span is free; ``configure(enabled=True)``
makes finished spans collect in memory, where ``drain()`` takes them.
Times are host-clock seconds: on the card they include the host's
enqueue, not the device's work, unless the spanned code synchronises.
Cross-process propagation and the trace-file exporter come with the
observability slice of the port.
"""

import contextlib
import dataclasses
import threading
import time
from typing import Any, Dict, Iterator, List, Optional


@dataclasses.dataclass
class Span:
    name: str
    start: float
    attributes: Dict[str, Any]
    end: Optional[float] = None

    def set_attribute(self, key: str, value):
        self.attributes[key] = value

    @property
    def secs(self) -> float:
        return (self.end or self.start) - self.start


class Tracer:

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._spans: List[Span] = []

    @contextlib.contextmanager
    def span(self, name: str, **attributes) -> Iterator[Optional[Span]]:
        """Scoped span; an exception is recorded as its ``error``
        attribute and re-raised."""
        if not self.enabled:
            yield None
            return
        sp = Span(name, time.monotonic(), dict(attributes))
        try:
            yield sp
        except BaseException as e:
            sp.set_attribute("error", repr(e))
            raise
        finally:
            sp.end = time.monotonic()
            with self._lock:
                self._spans.append(sp)

    def drain(self) -> List[Span]:
        """Remove and return every finished span."""
        with self._lock:
            out, self._spans = self._spans, []
        return out


_default = Tracer()


def configure(enabled: Optional[bool] = None):
    if enabled is not None:
        _default.enabled = enabled


def span(name: str, **attributes):
    return _default.span(name, **attributes)


def drain() -> List[Span]:
    return _default.drain()
