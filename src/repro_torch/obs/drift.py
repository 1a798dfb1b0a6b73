"""Cost-model drift detection: measured step time vs the plan's prediction.

The search engine commits to a plan because ``CostEnv`` predicts it is the
fastest; ``core/calibrate.py`` fits those predictions to measured profiles.  This
module closes the loop at runtime: an exponential moving average of the
measured step time is compared against ``ExecutionPlan.predicted_step_time``
each step, and when the ratio leaves ``[1/threshold, threshold]`` for
``sustain_steps`` consecutive checks the monitor reports *sustained* drift
— the structured signal that the profile cache is stale and a
re-profile/recalibration (or replan) is warranted.  The same threshold
backs the static-analysis side: ``plan_check`` emits **GALV070** when
handed a measured step time that diverges from the plan's prediction.

Stdlib-only; the clock is injectable so tests pin behavior deterministically.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

# Ratio (either direction) beyond which measured step time counts as
# diverged from the prediction.  2.0 is deliberately loose: the analytic
# cost model is a ranking device, not a stopwatch — only being *twice*
# wrong says the calibration no longer describes this hardware/plan.
DRIFT_RATIO_THRESHOLD = 2.0

# Steps the EMA must stay diverged before drift is called sustained.
DEFAULT_SUSTAIN_STEPS = 20

# Steps ignored at the start (compilation, cache warmup pollute the EMA).
DEFAULT_WARMUP_STEPS = 5

DEFAULT_EMA_ALPHA = 0.1


@dataclasses.dataclass
class DriftVerdict:
    """Outcome of one ``observe()`` — serializable into a ``drift`` event."""

    step: int
    measured_ema: float
    predicted: float
    ratio: float
    drifting: bool
    sustained: bool

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class DriftMonitor:
    """EMA-based step-time drift detector for one active plan.

    ``observe(step, step_time_s)`` folds the measurement into the EMA and
    returns a :class:`DriftVerdict` (or ``None`` during warmup / when the
    plan carries no prediction).  Re-plan events must ``reset()`` with the
    new prediction — the EMA of the old plan says nothing about the new one.
    """

    def __init__(self, predicted_step_time: float, *,
                 threshold: float = DRIFT_RATIO_THRESHOLD,
                 ema_alpha: float = DEFAULT_EMA_ALPHA,
                 warmup_steps: int = DEFAULT_WARMUP_STEPS,
                 sustain_steps: int = DEFAULT_SUSTAIN_STEPS,
                 clock: Callable[[], float] = time.time):
        if threshold <= 1.0:
            raise ValueError("threshold must exceed 1.0")
        self.threshold = threshold
        self.ema_alpha = ema_alpha
        self.warmup_steps = warmup_steps
        self.sustain_steps = sustain_steps
        self._clock = clock
        self.reset(predicted_step_time)

    def reset(self, predicted_step_time: float) -> None:
        self.predicted = float(predicted_step_time)
        self.ema: Optional[float] = None
        self._seen = 0
        self._diverged_streak = 0
        self.sustained_since: Optional[float] = None

    def observe(self, step: int, step_time_s: float) -> Optional[DriftVerdict]:
        self._seen += 1
        if self._seen <= self.warmup_steps:
            return None
        if self.ema is None:
            self.ema = float(step_time_s)
        else:
            a = self.ema_alpha
            self.ema = a * float(step_time_s) + (1.0 - a) * self.ema
        if self.predicted <= 0.0:
            return None  # plan carries no prediction — nothing to drift from
        ratio = self.ema / self.predicted
        drifting = ratio > self.threshold or ratio < 1.0 / self.threshold
        if drifting:
            self._diverged_streak += 1
            if (self._diverged_streak >= self.sustain_steps
                    and self.sustained_since is None):
                self.sustained_since = self._clock()
        else:
            self._diverged_streak = 0
            self.sustained_since = None
        return DriftVerdict(
            step=step, measured_ema=self.ema, predicted=self.predicted,
            ratio=ratio, drifting=drifting,
            sustained=self.sustained_since is not None)
