"""repro_torch.obs — runtime telemetry: metrics, trace spans, run sink, drift.

The port's copy of ``repro.obs``, with the same ``__all__``.  Stdlib-only at
import time (torch is reached lazily, only to fence timers and enter
profiler annotations), so ``scripts/render_run.py`` and any reader of a run
log import it where neither torch nor numpy exists.
"""
from repro_torch.obs.drift import (DEFAULT_SUSTAIN_STEPS, DEFAULT_WARMUP_STEPS,
                                   DRIFT_RATIO_THRESHOLD, DriftMonitor,
                                   DriftVerdict)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                                     StepRecord, StepTimer, fence)
from repro_torch.obs.sink import (SCHEMA_VERSION, CorruptRunLogError, NullSink,
                                  RunSink, StaleRunLogError, format_live_line,
                                  read_run)
from repro_torch.obs.trace import SpanRecord, Tracer, default_tracer, span

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "StepRecord",
    "StepTimer", "fence",
    "SpanRecord", "Tracer", "default_tracer", "span",
    "SCHEMA_VERSION", "RunSink", "NullSink", "read_run",
    "format_live_line", "CorruptRunLogError", "StaleRunLogError",
    "DriftMonitor", "DriftVerdict", "DRIFT_RATIO_THRESHOLD",
    "DEFAULT_SUSTAIN_STEPS", "DEFAULT_WARMUP_STEPS",
]
