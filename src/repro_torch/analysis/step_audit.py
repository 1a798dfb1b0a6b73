"""The step auditor — prove the traced step matches the plan: the
counterpart of ``repro.analysis.hlo_audit``.

The search ranks plans by what the cost and memory models say the step will
do.  ``audit_step`` checks a traced step (``analysis/step_trace.py``: one
step run on tensors that hold no data, nothing executed) against that:

* the step's per-mesh-axis collective census (``analysis/comm_census.py``)
  against the cost model's prediction
  (``core.cost_model.predicted_comm_census``) — **GALV090**: deviations
  beyond a tolerance band are warnings; all-gather traffic on an axis where
  the plan predicts none is an unplanned gather and always an error;
* its aten ops (``analysis/op_audit.py``) — **GALV091** (f32 matmuls in a
  bf16 plan), **GALV092** (remat declared but no checkpointed matmul),
  **GALV093** (host reads in the step, with their ``file:line``).

An eager step counts every collective each time it runs, so the census has
no unresolved loop and the port never emits GALV094.  ``AuditTolerance``,
``AuditReport`` (``to_event()``, ``format_table()``) and the GALV090 rule
are JAX's.
"""
from __future__ import annotations

import dataclasses

from repro_torch.analysis.comm_census import AxisCensus
from repro_torch.analysis.op_audit import audit_ops
from repro_torch.analysis.plan_check import ERROR, WARNING, Diagnostic
from repro_torch.core.cost_model import CommCensusEntry, predicted_comm_census
from repro_torch.core.profiler_model import profile_model


@dataclasses.dataclass(frozen=True)
class AuditTolerance:
    """Band for the GALV090 predicted-vs-measured comparison (JAX's
    defaults): ``ratio`` bounds measured/predicted per axis label both ways;
    an axis is judged only when either side exceeds ``max(floor_bytes,
    floor_frac × total predicted bytes)``; ``gather_floor`` (same form) is
    the threshold above which all-gather bytes on a no-gather-predicted
    axis count as an unplanned gather."""

    ratio: float = 8.0
    floor_bytes: float = 512.0 * 1024
    floor_frac: float = 0.10
    gather_floor_bytes: float = 256.0 * 1024
    gather_floor_frac: float = 0.05

    def floor(self, total_predicted: float) -> float:
        return max(self.floor_bytes, self.floor_frac * total_predicted)

    def gather_floor(self, total_predicted: float) -> float:
        return max(self.gather_floor_bytes, self.gather_floor_frac * total_predicted)


@dataclasses.dataclass
class AuditReport:
    """Outcome of one step audit: diagnostics plus both censuses."""

    diagnostics: list
    predicted: list = dataclasses.field(default_factory=list)
    measured: AxisCensus | None = None

    @property
    def errors(self) -> list:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> list:
        return [d for d in self.diagnostics if d.severity == WARNING]

    def ok(self) -> bool:
        return not self.errors

    def codes(self) -> list:
        return [d.code for d in self.diagnostics]

    def error_codes(self) -> list:
        return [d.code for d in self.errors]

    def census_rows(self) -> list:
        """(axis_label, predicted_bytes, measured_bytes) per axis label."""
        pred: dict = {}
        for e in self.predicted:
            pred[e.axis] = pred.get(e.axis, 0.0) + e.bytes
        meas: dict = {}
        if self.measured is not None:
            for (ax, _k), (b, _c) in self.measured.entries.items():
                meas[ax] = meas.get(ax, 0.0) + b
        return [(ax, pred.get(ax, 0.0), meas.get(ax, 0.0))
                for ax in sorted(set(pred) | set(meas))]

    def to_event(self) -> dict:
        """JSON-serializable summary for the run sink's ``audit`` event
        (JAX's keys)."""
        return {
            "ok": self.ok(),
            "codes": self.codes(),
            "error_codes": self.error_codes(),
            "predicted_bytes": float(sum(e.bytes for e in self.predicted)),
            "measured_bytes": (float(self.measured.total_bytes)
                               if self.measured is not None else None),
            "unresolved_loops": (self.measured.unresolved_loops
                                 if self.measured is not None else None),
            "axes": [{"axis": ax, "predicted": p, "measured": m}
                     for ax, p, m in self.census_rows()],
        }

    def format_table(self) -> str:
        lines = []
        rows = self.census_rows()
        if rows:
            lines.append(f"{'AXIS':14s} {'PREDICTED':>12s} {'MEASURED':>12s}")
            for ax, p, m in rows:
                lines.append(f"{ax:14s} {p:12,.0f} {m:12,.0f}")
        for d in self.diagnostics:
            lines.append(str(d))
        status = "FAIL" if self.errors else "OK"
        lines.append(f"step audit: {status} ({len(self.errors)} error(s), "
                     f"{len(self.warnings)} warning(s))")
        return "\n".join(lines)


def _audit_census(measured: AxisCensus, predicted: list[CommCensusEntry],
                  tol: AuditTolerance) -> list[Diagnostic]:
    """GALV090: per-axis-label byte comparison, gather rule first."""
    pred_total: dict = {}
    pred_gather: dict = {}
    for e in predicted:
        pred_total[e.axis] = pred_total.get(e.axis, 0.0) + e.bytes
        if e.kind == "all-gather":
            pred_gather[e.axis] = pred_gather.get(e.axis, 0.0) + e.bytes
    total_p = sum(pred_total.values())
    floor = tol.floor(total_p)
    g_floor = tol.gather_floor(total_p)

    meas_total: dict = {}
    for (ax, _k), (b, _c) in measured.entries.items():
        if ax == "none":
            continue
        meas_total[ax] = meas_total.get(ax, 0.0) + b

    diags: list[Diagnostic] = []
    for ax in sorted(set(pred_total) | set(meas_total)):
        p = pred_total.get(ax, 0.0)
        m = meas_total.get(ax, 0.0)
        m_gather = measured.bytes_on(ax, "all-gather")
        if pred_gather.get(ax, 0.0) == 0.0 and m_gather > g_floor:
            diags.append(Diagnostic(
                "GALV090",
                f"{m_gather:,.0f} B of all-gather traffic on axis '{ax}' where the plan "
                "predicts none — an unplanned gather (a layout the runtime repaired by "
                "gathering its operand)",
                where=f"census:{ax}"))
            continue
        if max(p, m) < floor:
            continue
        if p == 0.0:
            diags.append(Diagnostic(
                "GALV090",
                f"{m:,.0f} B of collective traffic on axis '{ax}' where the plan predicts "
                "none",
                where=f"census:{ax}", severity=WARNING))
        elif m > p * tol.ratio or m < p / tol.ratio:
            diags.append(Diagnostic(
                "GALV090",
                f"axis '{ax}' collective volume {m:,.0f} B is outside the ±{tol.ratio:g}× "
                f"band around the predicted {p:,.0f} B",
                where=f"census:{ax}", severity=WARNING))
    return diags


def audit_step(plan, cfg, *, seq_len: int, global_batch: int, trace=None,
               dtype: str = "bf16", tolerance: AuditTolerance | None = None) -> AuditReport:
    """Audit one traced train step (a ``step_trace.StepTrace``) against its
    plan: GALV091-093 from its ops, GALV090 from its census.  Without a
    trace there is nothing to audit and the report is empty."""
    tol = tolerance or AuditTolerance()
    if trace is None:
        return AuditReport([])
    diags = audit_ops(trace.ops.summary(), plan, dtype=dtype)
    predicted = predicted_comm_census(
        profile_model(cfg, seq_len), list(plan.layer_strategies),
        devices=max(plan.num_devices // max(plan.pp, 1), 1),
        micro_batch=global_batch / max(plan.grad_accum, 1), grad_accum=plan.grad_accum,
        pp=plan.pp, mesh_axes=plan.mesh_axes)
    measured = trace.census.axis_census()
    diags.extend(_audit_census(measured, predicted, tol))
    return AuditReport(diags, predicted, measured)
