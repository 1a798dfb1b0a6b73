"""Static plan verifier — every plan invariant checked before anything compiles.

``check_plan(plan, cluster, cfg, seq_len=...)`` verifies an
:class:`~repro_torch.core.strategy.ExecutionPlan` with **zero compilation** and
returns a :class:`PlanReport` of structured diagnostics, each carrying a
stable ``GALV***`` code, a severity and a fix hint.  The search engine runs
it on every winning candidate, and ``launch/train.py`` exposes it as
``--validate-only``.  The port's copy of ``repro.analysis.plan_check``.

The catalog of the codes the port emits (the JAX package's, less GALV094:
an eager step has no loop whose trip count could go unread):

====  ========================  ========================================
code  slug                      invariant
====  ========================  ========================================
001   mesh-overcommit           mesh devices <= cluster chips; dp·tp·cp
                                exactly tiles each pipeline stage
002   mesh-malformed            rank match, positive dims, unique axes
003   pp-axis-mismatch          pp>1 needs a "pod" axis of width pp
004   layer-count-mismatch      one strategy per model layer
005   tp-axis-mismatch          tp realizable on the mesh's model axis
006   ep-experts-indivisible    ep | num_experts and ep <= dp
010   cp-seq-indivisible        seq % (2·cp) == 0 (zig-zag split)
011   tp-heads-indivisible      tp | heads (warning: ceil-padding waste)
012   batch-dp-indivisible      microbatch % dp == 0
013   ga-batch-indivisible      grad_accum | global_batch
014   pp-layers-indivisible     pp | num_layers (equal stages)
015   pp-schedule-unrealizable  1f1b windowable / interleave divides
020   inflight-hbm-overcommit   schedule-aware peak memory <= HBM
030   cp-ring-inconsistent      one uniform cp degree across layers
031   cp-family-unsupported     ring attention is dense-family only
032   cp-axis-mismatch          cp>1 needs a "cp" axis of width cp
040   pp-boundary-dtype-mismatch cost-model bytes/elem == runtime dtype
050   ckpt-plan-incompatible    checkpoint arch/layout matches new plan
060   profile-cache-stale       calibration fitted from a current-schema
                                profile cache
070   cost-model-drift          measured step time within a ratio band of
                                the plan's predicted step time (warning)
080   serve-page-indivisible    page_size divides the serving max_context
081   serve-pool-hbm-overcommit kv page pool + tp-sharded weights <= HBM
082   serve-slots-pages-insufficient
                                every decode slot can hold >= 1 page
                                beyond the reserved null page
090   comm-mismatch             the traced step's per-axis collective
                                bytes within a band of the cost model's
                                census; no unplanned all-gather
091   dtype-drift               no f32 x f32 matmul in a bf16 plan
092   remat-missing             remat != none implies a checkpointed
                                forward that runs a matmul
093   host-callback-in-step     the step reads nothing on the host
====  ========================  ========================================

The GALV09x codes are emitted by the step auditor
(``repro_torch.analysis.step_audit`` / ``op_audit``) from a traced step
(``analysis/step_trace.py``): the same ``Diagnostic`` type, its evidence
the collectives and aten ops the step dispatched.

GALV040 compares the cost model's bytes per boundary element with
``repro_torch.parallel.pipeline.BOUNDARY_DTYPE``, the dtype the pipeline's
stage hop moves.  Every code keeps the JAX verifier's failing/passing pair (``tests/test_plan_verifier.py``),
held against the port in ``tests/test_torch_planner.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.analysis import invariants as inv
from repro_torch.configs.registry import ModelConfig
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.dynamic_programming import (interleave_realizable,
                                                  schedule_windowable)
from repro_torch.core.strategy import ExecutionPlan, LayerStrategy

ERROR = "error"
WARNING = "warning"

#: code -> (slug, severity, generic fix hint)
CATALOG: dict[str, tuple[str, str, str]] = {
    "GALV001": ("mesh-overcommit", ERROR,
                "shrink the mesh or pick tp·cp degrees that tile the stage"),
    "GALV002": ("mesh-malformed", ERROR,
                "mesh_shape and mesh_axes must be same-rank, positive, unique"),
    "GALV003": ("pp-axis-mismatch", ERROR,
                "pp>1 plans need a leading 'pod' mesh axis of width pp"),
    "GALV004": ("layer-count-mismatch", ERROR,
                "supply exactly one LayerStrategy per model layer"),
    "GALV005": ("tp-axis-mismatch", ERROR,
                "tp must be 1 or the mesh's model-axis width"),
    "GALV006": ("ep-experts-indivisible", ERROR,
                "pick ep dividing num_experts with ep <= dp"),
    "GALV010": ("cp-seq-indivisible", ERROR,
                "pick cp with seq_len % (2*cp) == 0 (zig-zag split)"),
    "GALV011": ("tp-heads-indivisible", WARNING,
                "tp not dividing heads pays ceil-padding FLOPs; prefer tp | heads"),
    "GALV012": ("batch-dp-indivisible", ERROR,
                "pick grad_accum so the microbatch shards evenly over dp"),
    "GALV013": ("ga-batch-indivisible", ERROR,
                "grad_accum must divide the global batch"),
    "GALV014": ("pp-layers-indivisible", ERROR,
                "pick pp dividing num_layers (equal stage_stack stages)"),
    "GALV015": ("pp-schedule-unrealizable", ERROR,
                "1f1b needs max(ga,pp) % pp == 0; interleaved needs "
                "num_layers % (pp*interleave) == 0"),
    "GALV020": ("inflight-hbm-overcommit", ERROR,
                "raise remat/zero, shrink microbatch, or switch schedule — "
                "the schedule's in-flight activations exceed per-device HBM"),
    "GALV030": ("cp-ring-inconsistent", ERROR,
                "use one uniform cp degree: mixed ring sizes give layers "
                "inconsistent ppermute orderings over the cp axis"),
    "GALV031": ("cp-family-unsupported", ERROR,
                "ring attention is implemented for dense-family models only"),
    "GALV032": ("cp-axis-mismatch", ERROR,
                "cp>1 plans need a 'cp' mesh axis of exactly that width"),
    "GALV040": ("pp-boundary-dtype-mismatch", ERROR,
                "cost_model.PIPELINE_BOUNDARY_BYTES_PER_ELEM must equal the "
                "runtime boundary dtype's itemsize (parallel/pipeline.py)"),
    "GALV050": ("ckpt-plan-incompatible", ERROR,
                "the checkpoint was written for a different model — resume "
                "with the matching arch/layer count (meshes may differ)"),
    "GALV060": ("profile-cache-stale", ERROR,
                "the calibration was fitted from a profile cache written "
                "under an older schema — re-run the `profile` subcommand "
                "to re-measure"),
    "GALV070": ("cost-model-drift", WARNING,
                "measured step time diverges from the plan's prediction "
                "beyond the drift threshold — re-run the `profile` "
                "subcommand to recalibrate, then re-search the plan"),
    "GALV080": ("serve-page-indivisible", ERROR,
                "pick page_size dividing max_context — a partial tail page "
                "would silently truncate the advertised context window"),
    "GALV081": ("serve-pool-hbm-overcommit", ERROR,
                "shrink num_pages/num_slots, raise tp, or lower max_context "
                "— the kv page pool plus the tp-sharded weights exceed HBM"),
    "GALV082": ("serve-slots-pages-insufficient", ERROR,
                "grow num_pages: each decode slot needs at least one real "
                "page (page 0 is the reserved null page)"),
}

#: The step auditor's codes (JAX's slugs and severities; the hints name the
#: port's evidence).  Kept apart from ``CATALOG``, which is the plan
#: verifier's alone, as JAX's verifier emits none of these.
AUDIT_CATALOG: dict[str, tuple[str, str, str]] = {
    "GALV090": ("comm-mismatch", ERROR,
                "the traced step's collective traffic deviates from the "
                "cost model's per-axis census — check the layout rules (an "
                "unplanned all-gather is a layout the runtime repaired by "
                "gathering) or recalibrate the comm model"),
    "GALV091": ("dtype-drift", ERROR,
                "f32 matmuls in a bf16 plan — pass the plan's compute dtype "
                "to forward_train; the searched memory/cost ranking assumed "
                "half-width activations"),
    "GALV092": ("remat-missing", ERROR,
                "plan declares remat but the step checkpoints no matmul — "
                "ensure the layer runner wraps block apply in "
                "parallel/remat.apply_remat with the plan's policy"),
    "GALV093": ("host-callback-in-step", ERROR,
                "remove host reads (.item(), .tolist(), .cpu(), nonzero) "
                "from the step — every step would synchronize with Python"),
}


def _entry(code: str) -> tuple:
    return CATALOG[code] if code in CATALOG else AUDIT_CATALOG[code]


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    code: str
    message: str
    where: str = ""              # e.g. "layer[3] tp16-z3", "mesh", "schedule"
    severity: str = ""           # filled from CATALOG when empty

    def __post_init__(self):
        if self.code not in CATALOG and self.code not in AUDIT_CATALOG:
            raise ValueError(f"unknown diagnostic code {self.code!r}")
        if not self.severity:
            object.__setattr__(self, "severity", _entry(self.code)[1])

    @property
    def slug(self) -> str:
        return _entry(self.code)[0]

    @property
    def hint(self) -> str:
        return _entry(self.code)[2]

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.code} {self.slug} ({self.severity}){loc}: {self.message}"


@dataclasses.dataclass
class PlanReport:
    diagnostics: list[Diagnostic] = dataclasses.field(default_factory=list)

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    def ok(self) -> bool:
        return not self.errors

    def codes(self) -> list[str]:
        return [d.code for d in self.diagnostics]

    def error_codes(self) -> list[str]:
        return [d.code for d in self.errors]

    def format_table(self) -> str:
        """Human-readable diagnostic table for --validate-only output."""
        if not self.diagnostics:
            return "plan verification: OK (0 diagnostics)"
        rows = [("CODE", "SEVERITY", "WHERE", "MESSAGE")]
        for d in self.diagnostics:
            rows.append((d.code, d.severity, d.where or "-", d.message))
        widths = [max(len(r[i]) for r in rows) for i in range(3)]
        lines = []
        for i, r in enumerate(rows):
            lines.append("  ".join(c.ljust(w) for c, w in zip(r[:3], widths))
                         + "  " + r[3])
            if i > 0:
                d = self.diagnostics[i - 1]
                lines.append(" " * (sum(widths) + 4) + f"  hint: {d.hint}")
        status = "FAIL" if self.errors else "OK"
        lines.append(f"plan verification: {status} "
                     f"({len(self.errors)} error(s), "
                     f"{len(self.warnings)} warning(s))")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# serving invariants (GALV08x)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Paged-cache geometry to verify alongside (or without) a plan.

    ``num_pages=None`` means full provisioning (``1 + num_slots * ceil(
    max_context / page_size)``, the :meth:`PagedCacheConfig.for_model`
    default) — GALV082 can then only fire through GALV081.  ``tp`` is the
    degree the serving weights are sharded over; ``bytes_per_elem`` is the
    kv/weight element width (bf16 by default).
    """

    num_slots: int
    page_size: int
    max_context: int
    num_pages: Optional[int] = None
    tp: int = 1
    bytes_per_elem: float = 2.0

    def resolved_num_pages(self) -> int:
        if self.num_pages is not None:
            return self.num_pages
        import math
        return 1 + self.num_slots * math.ceil(
            max(self.max_context, 1) / max(self.page_size, 1))


def check_serve(spec: ServeSpec, cluster: ClusterSpec,
                cfg: ModelConfig) -> PlanReport:
    """Statically verify a paged-cache serving geometry: page size divides
    the context window (GALV080), pool + tp-sharded weights fit HBM
    (GALV081), and the pool holds at least one real page per decode slot
    (GALV082).  Runs with zero compilation — ``ServeConfig.__post_init__``
    and ``SearchEngine.search_serve`` both gate on this report."""
    out = PlanReport()
    diag = out.diagnostics.append
    pages = spec.resolved_num_pages()

    if spec.page_size < 1 or spec.max_context % spec.page_size != 0:
        diag(Diagnostic("GALV080", f"page_size {spec.page_size} does not "
                        f"divide max_context {spec.max_context}",
                        where="cache"))

    if pages - 1 < spec.num_slots:
        diag(Diagnostic("GALV082", f"{pages} pages (incl. the null page) "
                        f"cannot give {spec.num_slots} slots one page each",
                        where="cache"))

    from repro_torch.core.profiler_model import profile_model
    tp = max(spec.tp, 1)
    weight_bytes = (spec.bytes_per_elem
                    * profile_model(cfg, spec.max_context).total_params()
                    / tp)
    # the pool shards over tp like the padded serving cache (sequence dim
    # over the model axis — flash-decode style), so both terms are per-device
    pool_bytes = (2.0 * spec.bytes_per_elem * cfg.num_layers * pages
                  * spec.page_size * cfg.num_kv_heads
                  * cfg.resolved_head_dim) / tp
    need = weight_bytes + pool_bytes
    if need > cluster.hbm_bytes:
        diag(Diagnostic(
            "GALV081",
            f"kv pool/tp {pool_bytes / 1e9:.2f} GB + weights/tp "
            f"{weight_bytes / 1e9:.2f} GB = {need / 1e9:.2f} GB exceeds "
            f"{cluster.hbm_bytes / 1e9:.2f} GB HBM", where="cache"))
    return out


# ---------------------------------------------------------------------------
# cheap per-candidate gate (used inside SearchEngine._evaluate hot loop)
# ---------------------------------------------------------------------------

def check_strategy(s: LayerStrategy, *, stage_devices: int, micro_batch: int,
                   cfg: ModelConfig, seq_len: int) -> Optional[str]:
    """First failing GALV code for one candidate strategy on one stage, or
    None.  This is the gate the search applies BEFORE costing a candidate —
    a strategy failing here is rejected with the code, never costed."""
    ok, dp = inv.mesh_factorizable(stage_devices, s.tp, s.cp)
    if not ok:
        return "GALV001"
    if s.ep > 1 and not inv.experts_shardable(cfg.num_experts, s.ep, dp):
        return "GALV006"
    if s.cp > 1 and cfg.family != "dense":
        return "GALV031"
    if not inv.cp_seq_divisible(seq_len, s.cp):
        return "GALV010"
    if not inv.batch_shardable(micro_batch, dp):
        return "GALV012"
    return None


# ---------------------------------------------------------------------------
# full plan verification
# ---------------------------------------------------------------------------

def _strategy_where(plan: ExecutionPlan, s: LayerStrategy) -> str:
    try:
        return f"layer[{plan.layer_strategies.index(s)}] {s.short()}"
    except ValueError:
        return s.short()


def check_plan(
    plan: ExecutionPlan,
    cluster: ClusterSpec,
    cfg: ModelConfig,
    *,
    seq_len: int,
    global_batch: Optional[int] = None,
    profile=None,                      # ModelProfile enables the memory check
    profile_strategies: Optional[list] = None,  # profile-aligned override
    opt_bytes: float = 8.0,
    saved_plan: Optional[ExecutionPlan] = None,
    mesh_constrained: bool = True,
    calibration=None,                  # calibrate.Calibration enables GALV060
    measured_step_time: Optional[float] = None,  # seconds; enables GALV070
    serve: Optional[ServeSpec] = None,           # enables GALV080-082
) -> PlanReport:
    """Statically verify ``plan`` against ``cluster`` and ``cfg``.

    ``global_batch`` enables the batch/ga divisibility checks;  ``profile``
    (a :class:`~repro_torch.core.profiler_model.ModelProfile`) enables the
    schedule-aware in-flight-memory check (GALV020);  ``profile_strategies``
    supplies the profile-layer-aligned strategy list when it differs from
    ``plan.layer_strategies`` (the search's pre-coalescing DP assignment);
    ``saved_plan`` enables the checkpoint-compatibility check (GALV050);
    ``calibration`` (a :class:`~repro_torch.core.calibrate.Calibration`) enables
    the stale-profile-cache check (GALV060);  ``measured_step_time`` (an
    observed per-step wall time in seconds, e.g. the ``repro_torch.obs`` drift
    monitor's EMA) enables the cost-model-drift check (GALV070) against
    ``plan.predicted_step_time``;  ``serve`` (a :class:`ServeSpec`) enables
    the paged-cache serving checks (GALV080-082).
    ``mesh_constrained=False`` (the search's free mode, which explores
    degrees on a notional flat mesh) skips the axis-width realizability
    checks GALV003/GALV005/GALV032 — the divisibility, capacity, schedule
    and memory invariants still apply.
    """
    out = PlanReport()
    diag = out.diagnostics.append

    # -- mesh shape sanity (GALV002) -------------------------------------
    shape, axes = tuple(plan.mesh_shape), tuple(plan.mesh_axes)
    mesh_ok = True
    if len(shape) != len(axes):
        diag(Diagnostic("GALV002", f"mesh_shape {shape} has rank {len(shape)} "
                        f"but mesh_axes {axes} has rank {len(axes)}",
                        where="mesh"))
        mesh_ok = False
    if any(d < 1 for d in shape):
        diag(Diagnostic("GALV002", f"mesh_shape {shape} has a non-positive "
                        "dimension", where="mesh"))
        mesh_ok = False
    if len(set(axes)) != len(axes):
        diag(Diagnostic("GALV002", f"mesh_axes {axes} repeats an axis name",
                        where="mesh"))
        mesh_ok = False
    if not mesh_ok:
        return out                      # nothing downstream is well-defined

    devices = plan.num_devices
    axis_width = dict(zip(axes, shape))

    # -- cluster capacity (GALV001) --------------------------------------
    if devices > cluster.chips:
        diag(Diagnostic("GALV001", f"mesh {shape} needs {devices} devices; "
                        f"cluster {cluster.name} has {cluster.chips}",
                        where="mesh"))

    # -- pipeline axis / layer split (GALV003/GALV014) --------------------
    pp = plan.pp
    if pp > 1:
        if mesh_constrained and axis_width.get("pod", 1) != pp:
            diag(Diagnostic("GALV003", f"pp={pp} but the mesh's pod axis is "
                            f"{axis_width.get('pod', 'absent')}",
                            where="mesh"))
        if not inv.pp_layers_divisible(cfg.num_layers, pp):
            diag(Diagnostic("GALV014", f"{cfg.num_layers} layers do not "
                            f"split into {pp} equal stages",
                            where="schedule"))

    # -- schedule realizability (GALV015) ---------------------------------
    if pp > 1:
        if plan.pp_schedule == "1f1b" and not schedule_windowable(
                pp, plan.grad_accum):
            diag(Diagnostic("GALV015", f"1f1b with ga={plan.grad_accum} does "
                            f"not window into rounds of pp={pp}",
                            where="schedule"))
        if plan.pp_schedule == "interleaved" and not interleave_realizable(
                cfg.num_layers, pp, plan.pp_interleave):
            diag(Diagnostic("GALV015", f"interleave v={plan.pp_interleave} "
                            f"needs num_layers % (pp*v) == 0; "
                            f"{cfg.num_layers} % {pp * plan.pp_interleave} != 0",
                            where="schedule"))

    # -- layer count (GALV004) -------------------------------------------
    if len(plan.layer_strategies) != cfg.num_layers:
        diag(Diagnostic("GALV004", f"{len(plan.layer_strategies)} strategies "
                        f"for {cfg.num_layers} layers", where="plan"))

    # -- per-strategy structural checks ----------------------------------
    stage_devices = devices // max(pp, 1)
    micro = None
    if global_batch is not None:
        if not inv.ga_divides_batch(global_batch, plan.grad_accum):
            diag(Diagnostic("GALV013", f"grad_accum {plan.grad_accum} does "
                            f"not divide global batch {global_batch}",
                            where="plan"))
        else:
            micro = global_batch // plan.grad_accum

    distinct = list(dict.fromkeys(
        list(plan.layer_strategies) + [plan.default_strategy]))
    model_w = axis_width.get("model", 1)
    cp_w = axis_width.get("cp", None)
    for s in distinct:
        where = _strategy_where(plan, s)
        ok, dp = inv.mesh_factorizable(stage_devices, s.tp, s.cp)
        if not ok:
            diag(Diagnostic("GALV001", f"tp={s.tp}·cp={s.cp} does not tile "
                            f"the stage's {stage_devices} devices",
                            where=where))
        if mesh_constrained and s.tp not in (1, model_w):
            diag(Diagnostic("GALV005", f"tp={s.tp} is not realizable on a "
                            f"model axis of width {model_w}", where=where))
        if s.ep > 1 and not inv.experts_shardable(cfg.num_experts, s.ep, dp):
            diag(Diagnostic("GALV006", f"ep={s.ep} vs num_experts="
                            f"{cfg.num_experts}, dp={dp}", where=where))
        if not inv.cp_seq_divisible(seq_len, s.cp):
            diag(Diagnostic("GALV010", f"seq_len {seq_len} is not divisible "
                            f"by 2*cp={2 * s.cp}", where=where))
        if s.tp > 1 and not inv.heads_shardable(cfg.num_heads, s.tp):
            diag(Diagnostic("GALV011", f"tp={s.tp} does not divide "
                            f"{cfg.num_heads} heads (ceil-padding waste)",
                            where=where))
        if micro is not None and ok and not inv.batch_shardable(micro, dp):
            diag(Diagnostic("GALV012", f"microbatch {micro} does not shard "
                            f"over dp={dp}", where=where))
        if s.cp > 1 and cfg.family != "dense":
            diag(Diagnostic("GALV031", f"cp={s.cp} on family "
                            f"{cfg.family!r}", where=where))
        if mesh_constrained and s.cp > 1 and cp_w != s.cp:
            diag(Diagnostic("GALV032", f"cp={s.cp} but the mesh's cp axis is "
                            f"{cp_w if cp_w is not None else 'absent'}",
                            where=where))

    # -- ring consistency across layers (GALV030) -------------------------
    ring_degrees = {s.cp for s in plan.layer_strategies if s.cp > 1}
    if len(ring_degrees) > 1:
        diag(Diagnostic("GALV030", f"mixed cp degrees {sorted(ring_degrees)} "
                        "— ppermute orderings over the cp axis would differ "
                        "between layers", where="plan"))

    # -- schedule-aware in-flight memory (GALV020) -------------------------
    if profile is not None and micro is not None and out.ok():
        mem = _plan_memory(plan, cluster, profile, profile_strategies,
                           micro, opt_bytes)
        if mem is not None and mem > cluster.hbm_bytes:
            diag(Diagnostic(
                "GALV020",
                f"predicted peak {mem / 1e9:.2f} GB/device exceeds "
                f"{cluster.hbm_bytes / 1e9:.2f} GB HBM "
                f"(schedule={plan.pp_schedule}, in-flight-aware)",
                where="memory"))

    # -- pipeline boundary dtype agreement (GALV040) -----------------------
    if pp > 1:
        d = _boundary_dtype_diag()
        if d is not None:
            diag(d)

    # -- calibration provenance (GALV060) ----------------------------------
    if calibration is not None:
        from repro_torch.core import profile_cache
        prov = getattr(calibration, "provenance", None) or {}
        sch = prov.get("cache_schema")
        if sch is not None and sch != profile_cache.SCHEMA_VERSION:
            diag(Diagnostic(
                "GALV060",
                f"calibration was fitted from profile cache "
                f"{prov.get('path', '<unknown>')} with schema {sch}; current "
                f"schema is {profile_cache.SCHEMA_VERSION}",
                where="calibration"))

    # -- cost-model drift (GALV070) ----------------------------------------
    if measured_step_time is not None and plan.predicted_step_time > 0:
        from repro_torch.obs.drift import DRIFT_RATIO_THRESHOLD
        ratio = float(measured_step_time) / plan.predicted_step_time
        if ratio > DRIFT_RATIO_THRESHOLD or ratio < 1.0 / DRIFT_RATIO_THRESHOLD:
            diag(Diagnostic(
                "GALV070",
                f"measured step time {float(measured_step_time) * 1e3:.1f} ms "
                f"is {ratio:.2f}x the predicted "
                f"{plan.predicted_step_time * 1e3:.1f} ms "
                f"(threshold {DRIFT_RATIO_THRESHOLD}x either way)",
                where="cost-model"))

    # -- checkpoint/plan compatibility (GALV050) ---------------------------
    if saved_plan is not None:
        out.diagnostics.extend(check_checkpoint_compat(saved_plan, plan))

    # -- serving cache geometry (GALV080-082) ------------------------------
    if serve is not None:
        out.diagnostics.extend(check_serve(serve, cluster, cfg).diagnostics)

    return out


def _plan_memory(plan, cluster, profile, profile_strategies, micro,
                 opt_bytes) -> Optional[float]:
    """Schedule-aware peak per-device bytes via the memory model, mapping the
    plan's runtime strategies onto the profile's layer list."""
    from repro_torch.core import cost_model as cm
    from repro_torch.core import memory_model as mm

    if profile_strategies is not None:
        strategies = profile_strategies
    elif len(plan.layer_strategies) == len(profile.layers):
        strategies = plan.layer_strategies
    else:
        # hybrid/audio profiles have more entries than runtime layers; the
        # runtime list is uniform there (to_runtime_strategies majority)
        strategies = [plan.default_strategy] * len(profile.layers)
    if len(strategies) != len(profile.layers):
        return None
    env = cm.CostEnv(cluster=cluster, devices=plan.num_devices // max(plan.pp, 1),
                     pp=plan.pp, micro_batch=micro, grad_accum=plan.grad_accum,
                     opt_bytes=opt_bytes, pp_schedule=plan.pp_schedule,
                     pp_interleave=plan.pp_interleave)
    return mm.plan_memory(profile, list(strategies), env,
                          fixed_strategy=plan.default_strategy)


def _boundary_dtype_diag() -> Optional[Diagnostic]:
    """GALV040: the cost model's bytes-per-element for pipeline boundary p2p
    must agree with the dtype the runtime actually permutes."""
    from repro_torch.core.cost_model import PIPELINE_BOUNDARY_BYTES_PER_ELEM
    from repro_torch.parallel.pipeline import BOUNDARY_DTYPE

    runtime_bytes = float(BOUNDARY_DTYPE.itemsize)
    if runtime_bytes != float(PIPELINE_BOUNDARY_BYTES_PER_ELEM):
        return Diagnostic(
            "GALV040",
            f"cost model charges {PIPELINE_BOUNDARY_BYTES_PER_ELEM} B/elem "
            f"but the runtime boundary dtype is {runtime_bytes:.0f} B/elem",
            where="pipeline")
    return None


def check_checkpoint_compat(saved_plan: ExecutionPlan,
                            new_plan: ExecutionPlan) -> list[Diagnostic]:
    """GALV050: a checkpoint reshards across meshes/strategies freely (the
    canonical pytree is layout-free), but arch and layer count must match —
    a mismatch means the shards describe a different model."""
    out: list[Diagnostic] = []
    if saved_plan.arch and new_plan.arch and saved_plan.arch != new_plan.arch:
        out.append(Diagnostic("GALV050", f"checkpoint written for arch "
                              f"{saved_plan.arch!r}; resuming as "
                              f"{new_plan.arch!r}", where="checkpoint"))
    if (saved_plan.layer_strategies and new_plan.layer_strategies
            and len(saved_plan.layer_strategies)
            != len(new_plan.layer_strategies)):
        out.append(Diagnostic("GALV050", f"checkpoint has "
                              f"{len(saved_plan.layer_strategies)} layers; "
                              f"new plan has "
                              f"{len(new_plan.layer_strategies)}",
                              where="checkpoint"))
    return out
