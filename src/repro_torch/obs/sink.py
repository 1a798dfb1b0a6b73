"""JSONL run sink: the durable, machine-readable record of a run.

The port's copy of ``repro.obs.sink``: for the same events under the same
clock it writes the same bytes, so ``scripts/render_run.py`` renders the
port's logs and either package's :func:`read_run` reads the other's.

* **Versioned schema.** The first record of every log is a ``run_start``
  event carrying ``schema``; :func:`read_run` refuses logs written under a
  different schema with :class:`StaleRunLogError` rather than guessing.
* **Atomic appends.** Each event is serialized to one ``\\n``-terminated
  line (``json.dumps(..., sort_keys=True)``) and written with a single
  ``write()`` + ``flush()`` on an append-mode handle, under a lock: the
  checkpoint writer's thread emits ``ckpt`` events while the step loop
  emits ``step`` events, and a crash can only truncate the *final* line.
* **Crash tolerance on read.** A truncated last line is skipped with a
  warning (the run died mid-write — expected); garbage *mid*-file means the
  log was corrupted some other way and raises :class:`CorruptRunLogError`
  with path and reason.

Layout: ``results/runs/<run_id>/run.jsonl`` via :func:`RunSink.create`.
Every event gets ``ts`` (wall-clock seconds, injectable clock) and
``event`` (its type).  Event types are open-ended; the port emits
``run_start``, ``plan``, ``search_rejections``, ``memory``, ``step``,
``ckpt``, ``drift``, ``replan_signal``, ``run_end``, and the serving
scheduler's per-request set — ``request_start``, ``first_token``,
``request_end``, ``request_evicted``.
"""
from __future__ import annotations

import json
import pathlib
import threading
import time
import warnings
from typing import Callable, Optional

SCHEMA_VERSION = 1

RUNS_DIR = pathlib.Path("results") / "runs"


class RunLogError(RuntimeError):
    pass


class CorruptRunLogError(RunLogError):
    """A run log line that is neither valid JSON nor a truncated tail."""

    def __init__(self, path, reason: str):
        self.path = pathlib.Path(path)
        self.reason = reason
        super().__init__(f"corrupt run log {self.path}: {reason}")


class StaleRunLogError(RunLogError):
    """A run log written under a different schema version."""

    def __init__(self, path, found):
        self.path = pathlib.Path(path)
        self.found = found
        super().__init__(
            f"stale run log {self.path}: schema {found!r}, "
            f"expected {SCHEMA_VERSION}")


class RunSink:
    """Append-only JSONL event sink for one run; reopening a log that holds
    events appends to it without a second ``run_start``."""

    def __init__(self, path, *, run_id: str = "",
                 clock: Callable[[], float] = time.time,
                 meta: Optional[dict] = None):
        self.path = pathlib.Path(path)
        self.run_id = run_id or self.path.parent.name
        self._clock = clock
        self._lock = threading.Lock()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fresh = not self.path.exists() or self.path.stat().st_size == 0
        self._fh = open(self.path, "a", encoding="utf-8")
        if fresh:
            self.emit("run_start", schema=SCHEMA_VERSION,
                      run_id=self.run_id, **(meta or {}))

    @classmethod
    def create(cls, run_dir, *, run_id: str = "",
               clock: Callable[[], float] = time.time,
               meta: Optional[dict] = None) -> "RunSink":
        """Open ``<run_dir>/run.jsonl`` (creating directories)."""
        run_dir = pathlib.Path(run_dir)
        return cls(run_dir / "run.jsonl", run_id=run_id or run_dir.name,
                   clock=clock, meta=meta)

    def emit(self, event: str, **fields) -> dict:
        """Append one event atomically; returns the record as written."""
        with self._lock:
            rec = {"event": event, "ts": self._clock(), **fields}
            line = json.dumps(rec, sort_keys=True, default=_json_default)
            if "\n" in line:  # pragma: no cover - json never emits raw newlines
                raise ValueError("event serialized with embedded newline")
            self._fh.write(line + "\n")
            self._fh.flush()
        return rec

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

    def __enter__(self) -> "RunSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NullSink:
    """Sink-shaped no-op for uninstrumented runs (no --run-dir)."""

    run_id = ""
    path = None

    def emit(self, event: str, **fields) -> dict:
        return {"event": event, **fields}

    def close(self) -> None:
        pass

    def __enter__(self) -> "NullSink":
        return self

    def __exit__(self, *exc) -> None:
        pass


def _json_default(obj):
    # numpy scalars and 0-d tensors leak into metrics dicts; .item() gives
    # the python number
    fn = getattr(obj, "item", None)
    if callable(fn):
        return fn()
    raise TypeError(f"not JSON-serializable: {type(obj).__name__}")


def read_run(path) -> list[dict]:
    """Parse a run log, enforcing schema and tolerating a truncated tail.

    Returns the event records in file order.  A final line with no
    trailing newline that fails to parse is treated as a mid-write crash:
    skipped with a warning.  Any other unparseable line raises
    :class:`CorruptRunLogError`; a ``run_start`` schema mismatch raises
    :class:`StaleRunLogError`.
    """
    path = pathlib.Path(path)
    raw = path.read_text(encoding="utf-8")
    records: list[dict] = []
    lines = raw.split("\n")
    # split() leaves a trailing "" when the file ends in \n; a non-empty
    # final element means the last write was cut short.
    complete, tail = lines[:-1], lines[-1]
    for i, line in enumerate(complete):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            raise CorruptRunLogError(path, f"line {i + 1}: {e}") from e
        if not isinstance(rec, dict) or "event" not in rec:
            raise CorruptRunLogError(path, f"line {i + 1}: not an event record")
        records.append(rec)
    if tail.strip():
        try:
            rec = json.loads(tail)
            if not isinstance(rec, dict) or "event" not in rec:
                raise ValueError("not an event record")
            records.append(rec)
        except Exception:
            warnings.warn(
                f"run log {path}: truncated final line skipped "
                f"(run likely died mid-write)", stacklevel=2)
    if records:
        head = records[0]
        if head.get("event") != "run_start":
            raise CorruptRunLogError(path, "first record is not run_start")
        if head.get("schema") != SCHEMA_VERSION:
            raise StaleRunLogError(path, head.get("schema"))
    return records


def format_live_line(rec: dict) -> str:
    """Human one-liner for a ``step`` event, fed from the same record the
    sink writes."""
    parts = [f"step {rec.get('step', 0):5d}"]
    if "loss" in rec:
        parts.append(f"loss {rec['loss']:.4f}")
    if "grad_norm" in rec:
        parts.append(f"gnorm {rec['grad_norm']:.2f}")
    if rec.get("tokens_per_sec"):
        parts.append(f"tok/s {rec['tokens_per_sec']:,.0f}")
    if rec.get("mfu"):
        parts.append(f"mfu {rec['mfu'] * 100:.1f}%")
    if rec.get("step_time_s"):
        parts.append(f"dt {rec['step_time_s'] * 1e3:.1f}ms")
    return "  ".join(parts)
