"""Nested trace spans with a pure-Python fallback timeline.

The port's copy of ``repro.obs.trace``.  ``span("fwd")`` is a context
manager that (a) records a :class:`SpanRecord` into an in-process timeline
— name, start/end, depth, parent — and (b) enters a
``torch.profiler.record_function(name)``, so the same span shows up by
name in a ``torch.profiler`` trace when one is being captured.  On hosts
without torch the annotation is a no-op and the Python timeline is the
whole story.

Spans nest per-thread: the active-span stack is thread-local, so the
checkpoint writer's thread and serving worker threads each get a coherent
parent chain.  A span opens and closes on the host: never enter one inside
a function that ``runtime.compiled.compile_step`` captures.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Iterator, Optional


def _annotation(name: str):
    """``torch.profiler.record_function(name)``, or a nullcontext.

    Imported lazily so ``repro_torch.obs`` stays importable without torch
    (``scripts/render_run.py`` reads the port's logs with the stdlib
    alone)."""
    try:
        from torch.profiler import record_function
    except Exception:
        return contextlib.nullcontext()
    return record_function(name)


@dataclasses.dataclass
class SpanRecord:
    """One closed (or still-open) span in the fallback timeline."""

    name: str
    t0: float
    t1: Optional[float] = None
    depth: int = 0
    parent: Optional[str] = None

    @property
    def duration_s(self) -> float:
        if self.t1 is None:
            raise ValueError(f"span {self.name!r} is still open")
        return self.t1 - self.t0

    def as_dict(self) -> dict:
        return {"name": self.name, "t0": self.t0, "t1": self.t1,
                "depth": self.depth, "parent": self.parent}


class Tracer:
    """Collects a timeline of nested spans.

    Records are appended at span *start*, so the timeline reads in
    chronological-open order (parents before children) and an open span
    left behind by a crash is still visible with ``t1=None``."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._local = threading.local()
        self._lock = threading.Lock()
        self.records: list[SpanRecord] = []

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[SpanRecord]:
        stack = self._stack()
        parent = stack[-1].name if stack else None
        rec = SpanRecord(name=name, t0=self._clock(),
                         depth=len(stack), parent=parent)
        with self._lock:
            self.records.append(rec)
        stack.append(rec)
        try:
            with _annotation(name):
                yield rec
        finally:
            stack.pop()
            rec.t1 = self._clock()

    def timeline(self) -> list[dict]:
        """JSON-serializable chronological timeline of all recorded spans."""
        with self._lock:
            return [r.as_dict() for r in self.records]

    def total(self, name: str) -> float:
        """Summed duration of every *closed* span with this name."""
        with self._lock:
            return sum(r.duration_s for r in self.records
                       if r.name == name and r.t1 is not None)

    def clear(self) -> None:
        with self._lock:
            self.records.clear()


# Module-level default tracer: instrumentation call sites use
# ``obs.span("...")`` without threading a Tracer handle everywhere; tests
# and the launchers that want an isolated timeline construct their own.
_DEFAULT = Tracer()


def default_tracer() -> Tracer:
    return _DEFAULT


def span(name: str):
    """``with obs.span("ckpt_host_copy"): ...`` on the default tracer."""
    return _DEFAULT.span(name)
