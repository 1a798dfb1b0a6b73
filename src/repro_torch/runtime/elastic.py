"""Elastic scaling: the drift advisory signal (the port's part of
``repro.runtime.elastic``).

``DriftReplanAdvisor`` turns sustained cost-model drift into one
``replan_signal`` event (code GALV070) in the run sink; the train launcher
feeds it every drift verdict.  ``ElasticEvent`` names a membership change.
``surviving_mesh``, ``replan`` and ``replan_and_diff`` — the re-search for
the surviving device count and the migration spec — wait for the port of
elastic resize (``runtime/resize.py``, ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class ElasticEvent:
    old_devices: int
    new_devices: int
    reason: str = "node-failure"


class DriftReplanAdvisor:
    """Turns sustained cost-model drift into a logged replan-worthy signal.

    The ``repro_torch.obs`` drift monitor flags each step whose measured-EMA
    / predicted ratio leaves the threshold band; this advisor watches those
    verdicts and, when the drift is *sustained*, emits one structured
    ``replan_signal`` event (code GALV070) to the run sink.  It is advisory
    only — no replan is triggered; the operator decides whether to
    re-profile/re-search.  ``cooldown_s`` rate-limits re-notification while
    the drift persists, and a verdict that is back in the band re-arms it;
    the clock is injectable so tests pin the cadence deterministically.
    """

    def __init__(self, sink, *, cooldown_s: float = 300.0, clock=None):
        self._sink = sink
        self.cooldown_s = cooldown_s
        self._clock = clock if clock is not None else time.time
        self._last_signal: Optional[float] = None
        self.signals_emitted = 0

    def observe(self, verdict) -> bool:
        """Feed one :class:`repro_torch.obs.DriftVerdict`; returns True when a
        ``replan_signal`` event was emitted for it."""
        if verdict is None or not verdict.sustained:
            if verdict is not None and not verdict.drifting:
                self._last_signal = None   # drift cleared: re-arm immediately
            return False
        now = self._clock()
        if (self._last_signal is not None
                and now - self._last_signal < self.cooldown_s):
            return False
        self._last_signal = now
        self.signals_emitted += 1
        self._sink.emit(
            "replan_signal", code="GALV070", step=verdict.step,
            measured_ema=verdict.measured_ema, predicted=verdict.predicted,
            ratio=verdict.ratio,
            action="advisory: re-profile and re-search recommended "
                   "(no auto-replan)")
        return True
