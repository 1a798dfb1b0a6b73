"""Structured runtime metrics: counters, gauges, histograms, step timing.

The port's copy of ``repro.obs.metrics``, with JAX's names, fields and
snapshot dicts.  Stdlib-only at import (the offline report renderer imports
without torch or numpy): torch is touched lazily, and only to fence
(``torch.cuda.synchronize``) before a wall-time reading, so the same
primitives instrument the training loop, the serving loop and plain host
code.

The unit of account is the :class:`MetricsRegistry` — a flat namespace of
named instruments that snapshots to a JSON-serializable dict (what the
:class:`~repro_torch.obs.sink.RunSink` appends per step).
:class:`StepTimer` is the step-loop instrument: it fences on the step's
outputs, records wall time / tokens-per-second / MFU, and hands back the
record for logging.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional


def _cuda_devices(tree: Any, tensor_type, found: set) -> None:
    """Add the CUDA device of every tensor in ``tree`` (dicts, lists and
    tuples, named tuples included) to ``found``."""
    if isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, tensor_type, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, tensor_type, found)
    elif isinstance(tree, tensor_type) and tree.is_cuda:
        found.add(tree.device)


def fence(outputs: Any) -> None:
    """Block until the device work behind ``outputs`` (any pytree of torch
    tensors) is done, so a following wall-clock reading measures finished
    work, not dispatch: ``torch.cuda.synchronize(device)`` once for each
    CUDA device holding a tensor of the tree.  A no-op for ``None``, for
    CPU tensors and on hosts without torch; it never initialises CUDA on a
    host whose tensors all live on the CPU."""
    if outputs is None:
        return
    try:
        import torch
    except Exception:  # no torch, so no tensor to wait for
        return
    found: set = set()
    _cuda_devices(outputs, torch.Tensor, found)
    for device in found:
        torch.cuda.synchronize(device)


class Counter:
    """Monotonic event count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Last-written value (queue depth, MFU, EMA step time, ...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self):
        return self.value


class Histogram:
    """Value distribution with exact percentiles.

    Keeps every observation (runs here are 10²-10⁴ steps — exact beats
    bucketed at this scale, and the run report wants true p50/p99).
    ``max_samples`` caps memory for long services: beyond it the reservoir
    keeps a uniformly-strided subsample while count/sum stay exact."""

    __slots__ = ("name", "count", "total", "min", "max", "_values",
                 "max_samples", "_stride", "_skip")

    def __init__(self, name: str, max_samples: int = 100_000):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.max_samples = max_samples
        self._values: list[float] = []
        self._stride = 1
        self._skip = 0

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        if self._skip:
            self._skip -= 1
            return
        self._values.append(value)
        self._skip = self._stride - 1
        if len(self._values) >= self.max_samples:
            # decimate: keep every other retained sample, double the stride
            self._values = self._values[::2]
            self._stride *= 2

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def percentile(self, p: float) -> float:
        """Exact (up to reservoir decimation) percentile, p in [0, 100]."""
        if not self._values:
            return float("nan")
        xs = sorted(self._values)
        if len(xs) == 1:
            return xs[0]
        rank = (p / 100.0) * (len(xs) - 1)
        lo = int(rank)
        hi = min(lo + 1, len(xs) - 1)
        frac = rank - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def snapshot(self):
        if not self.count:
            return {"count": 0}
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Flat get-or-create namespace of instruments.

    Re-requesting a name returns the same instrument; re-requesting it as a
    different kind is a programming error and raises."""

    def __init__(self):
        self._instruments: dict[str, Any] = {}

    def _get(self, name: str, cls):
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = cls(name)
        elif not isinstance(inst, cls):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{type(inst).__name__}, requested {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict:
        """JSON-serializable {name: value | histogram-stats} of everything."""
        return {name: inst.snapshot()
                for name, inst in sorted(self._instruments.items())}


@dataclasses.dataclass
class StepRecord:
    """One timed step, as handed to the sink / live formatter."""

    step: int
    step_time_s: float
    tokens_per_sec: float = 0.0
    mfu: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class StepTimer:
    """Per-step wall-time instrument for the training loop.

    ``start()`` stamps the clock; ``stop(outputs)`` fences on the step's
    outputs (:func:`fence` — without it the host would credit the step with
    the time to queue its kernels only), records the step into the
    registry's ``step_time_s`` histogram and ``tokens_per_sec``/``mfu``
    gauges, and returns the :class:`StepRecord`.

    * ``tokens_per_step`` enables tokens/sec.
    * ``flops_per_step`` (e.g. ``ModelProfile.model_flops_per_token()`` ×
      tokens — the 6N fwd+bwd basis) together with ``peak_flops`` (the
      cluster's per-card peak × device count) enables MFU.
    * ``clock`` is injectable for tests (fake clock); ``fence_fn`` replaces
      the fence (under ``torchrun``: synchronize, then a barrier, so a
      step's time is the slowest rank's).
    """

    def __init__(self, registry: MetricsRegistry, *,
                 tokens_per_step: int = 0,
                 flops_per_step: float = 0.0,
                 peak_flops: float = 0.0,
                 clock: Callable[[], float] = time.perf_counter,
                 fence_fn: Callable[[Any], None] = fence):
        self.registry = registry
        self.tokens_per_step = tokens_per_step
        self.flops_per_step = flops_per_step
        self.peak_flops = peak_flops
        self._clock = clock
        self._fence = fence_fn
        self._t0: Optional[float] = None
        self.steps = registry.counter("steps")
        self.hist = registry.histogram("step_time_s")
        self.tok_gauge = registry.gauge("tokens_per_sec")
        self.mfu_gauge = registry.gauge("mfu")

    def start(self) -> None:
        self._t0 = self._clock()

    def stop(self, step: int, outputs: Any = None) -> StepRecord:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() without start()")
        self._fence(outputs)
        dt = max(self._clock() - self._t0, 1e-12)
        self._t0 = None
        rec = StepRecord(step=step, step_time_s=dt)
        if self.tokens_per_step:
            rec.tokens_per_sec = self.tokens_per_step / dt
            self.tok_gauge.set(rec.tokens_per_sec)
        if self.flops_per_step and self.peak_flops:
            rec.mfu = self.flops_per_step / dt / self.peak_flops
            self.mfu_gauge.set(rec.mfu)
        self.steps.inc()
        self.hist.observe(dt)
        return rec
