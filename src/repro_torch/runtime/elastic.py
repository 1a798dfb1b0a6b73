"""Elastic scaling: node failure -> re-search -> migrate -> resume (the port
of ``repro.runtime.elastic``).

When the world changes size, re-running the search engine for the surviving
device count yields a new plan, and ``runtime/resize.py`` moves the live
state onto it.  ``surviving_mesh``, ``replan_pp_candidates``,
``replan_cp_candidates``, ``replan`` and ``replan_and_diff`` are JAX's,
copied; they are pure (no process group, no tensor), and the train
launcher calls them between steps when a membership change fires.
``replan``'s default cluster is the port's ``H100_NODE8`` (the port has no
TPU preset); its ``chips`` is replaced per candidate mesh, as JAX does, and
the launcher passes the cluster it searched on.

``replan`` searches cp without pinning ``cp_options``, as JAX's does, so it
may return a plan that mixes cp degrees over its layer groups; the runtime
refuses such a plan when the new trainer is built (``check_layout``), and
nothing falls back to the old plan.

``DriftReplanAdvisor`` turns sustained cost-model drift into one
``replan_signal`` event (code GALV070) in the run sink; the train launcher
feeds it every drift verdict.  ``ElasticEvent`` names a membership change.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

from repro_torch.analysis import invariants as inv
from repro_torch.analysis import plan_check as pc
from repro_torch.configs.registry import ModelConfig
from repro_torch.core import calibrate as cal
from repro_torch.core.cluster import H100_NODE8, ClusterSpec
from repro_torch.core.search import SearchEngine, SearchResult, getattr_supports
from repro_torch.core.strategy import ExecutionPlan


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


def surviving_mesh(devices: int, *, model_axis: int = 16,
                   pp: int = 1, cp: int = 1,
                   global_batch: Optional[int] = None) -> tuple[tuple, tuple]:
    """Largest mesh using <= devices with (at most) the given model axis,
    pipeline degree (pp > 1 adds a leading "pod" axis carrying the stages)
    and context-parallel degree (cp > 1 adds a "cp" axis for ring attention).

    Every exact data dimension is accepted; the only shrink applied is
    making data divide ``global_batch`` (the search requires microbatches to
    shard evenly over DP).  When the requested model axis cannot tile the
    survivors, halving it is also considered — whichever (data, model) pair
    uses the most devices wins (larger model axis breaks ties, staying
    closest to the pre-failure TP domain)."""
    avail = max(devices // (pp * cp), 1)
    best: Optional[tuple[int, int, int]] = None   # (used, model, data)
    m = min(model_axis, avail)
    while m >= 1:
        data = avail // m
        if global_batch is not None:
            while data > 1 and not inv.batch_shardable(global_batch, data):
                data -= 1
        cand = (data * m, m, data)
        if best is None or cand > best:
            best = cand
        m //= 2
    _, m, data = best
    shape: tuple = (data, m)
    axes: tuple = ("data", "model")
    if cp > 1:
        shape, axes = (cp,) + shape, ("cp",) + axes
    if pp > 1:
        shape, axes = (pp,) + shape, ("pod",) + axes
    return shape, axes


def replan_pp_candidates(cfg: ModelConfig, devices: int, *,
                         max_pp: int = 8) -> list[int]:
    """Pipeline degrees a replan may retain: power-of-two stage counts the
    runtime can realize on the surviving devices (stacked-block family, no
    experts, layers split evenly, at least one full (data, model) plane per
    stage)."""
    out = [1]
    if cfg.num_experts or not getattr_supports(cfg):
        return out
    pp = 2
    while (pp <= max_pp and devices // pp >= 1
           and inv.pp_layers_divisible(cfg.num_layers, pp)):
        out.append(pp)
        pp *= 2
    return out


def replan_cp_candidates(cfg: ModelConfig, seq_len: int, devices: int, *,
                         max_cp: int = 4) -> list[int]:
    """Context-parallel degrees a replan may retain: ring attention is
    implemented for dense attention stacks, needs the zig-zag split to
    divide the sequence, and cannot pay for itself below a few thousand
    tokens — short-context replans skip the extra searches entirely."""
    out = [1]
    if cfg.family != "dense" or seq_len < 4096:
        return out
    cp = 2
    while (cp <= max_cp and devices // cp >= 1
           and inv.cp_seq_divisible(seq_len, cp)):
        out.append(cp)
        cp *= 2
    return out


def replan(
    cfg: ModelConfig,
    event: ElasticEvent,
    seq_len: int,
    global_batch: int,
    *,
    cluster: ClusterSpec = H100_NODE8,
    arch: str = "",
    shape_name: str = "",
    calibration: Optional[cal.Calibration] = None,
    profile_cache: Optional[str] = None,
) -> ExecutionPlan:
    """Re-search the full (pp × cp × schedule × strategy) space for the
    surviving device count and return the fastest feasible plan that passes
    ``check_plan`` (else the pp = 1, cp = 1 search's plan, as JAX's).  Each
    candidate (pp, cp) gets its own pod/cp-axis mesh; schedules are
    enumerated by the engine, cp degrees by the mesh's cp axis.

    ``calibration`` (or ``profile_cache``, a path the calibration is loaded
    from) grounds the replan's cost model in measured timings — the same
    knob as the launcher's ``--profile-cache``."""
    if calibration is None:
        calibration = (cal.load_calibration(profile_cache)
                       if profile_cache else cal.DEFAULT_CALIBRATION)
    best: Optional[SearchResult] = None
    best_pp1: Optional[SearchResult] = None
    for pp in replan_pp_candidates(cfg, event.new_devices):
        for cp in replan_cp_candidates(cfg, seq_len, event.new_devices // pp):
            mesh_shape, mesh_axes = surviving_mesh(event.new_devices, pp=pp, cp=cp,
                                                   global_batch=global_batch)
            sub = dataclasses.replace(cluster, chips=int(math.prod(mesh_shape)))
            engine = SearchEngine(cfg, sub, calibration=calibration)
            res = engine.search(seq_len, global_batch, mesh_shape=mesh_shape,
                                mesh_axes=mesh_axes, pp_options=[pp],
                                arch=arch, shape_name=shape_name)
            if pp == 1 and cp == 1:
                best_pp1 = res
            if not res.feasible:
                continue
            # verifier veto: never swap live state onto a plan that fails a
            # structural invariant (the replan is the last line before a
            # live migration)
            if not pc.check_plan(res.plan, sub, cfg, seq_len=seq_len,
                                 global_batch=global_batch,
                                 calibration=calibration).ok():
                continue
            if best is None or res.plan.predicted_step_time < best.plan.predicted_step_time:
                best = res
    res = best if best is not None else best_pp1
    plan = res.plan
    plan.notes += f" | elastic replan: {event.old_devices}->{event.new_devices} ({event.reason})"
    return plan


def replan_and_diff(
    cfg: ModelConfig,
    event: ElasticEvent,
    seq_len: int,
    global_batch: int,
    old_plan: ExecutionPlan,
    **kwargs,
) -> tuple[ExecutionPlan, "resize.MigrationSpec"]:
    """Replan for the surviving devices AND diff the result against the plan
    currently running — the first half of a live resize
    (``runtime/resize.py``).  The returned ``MigrationSpec`` tells the
    caller what the swap involves (axis resharding only, or a pipeline
    restage / group regroup) before any state moves."""
    from repro_torch.runtime import resize

    new_plan = replan(cfg, event, seq_len, global_batch, **kwargs)
    return new_plan, resize.diff_plans(old_plan, new_plan)
