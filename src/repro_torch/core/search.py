"""SearchEngine — the paper's workflow step 3.

Profiles the model (analytically here; measured path available), builds the
decision-tree candidate set per layer kind, costs every candidate with the
time/memory models, Pareto-prunes, then runs the layer DP for every
(pipeline degree × gradient-accumulation) combination and returns the best
feasible :class:`ExecutionPlan`.  ``mesh_constrained=True`` restricts
realizable degrees to the fixed production mesh; the free mode reproduces
the paper's arbitrary power-of-two search (used by the Fig.-3 benchmark).

The port's defaults name one card: ``cluster=H100_1`` and a ``(1, 1)`` mesh
over ``("data", "model")``; every other default is the JAX package's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.analysis import plan_check as pc
from repro_torch.configs.registry import ModelConfig
from repro_torch.core import calibrate as cal
from repro_torch.core import cost_model as cm
from repro_torch.core import memory_model as mm
from repro_torch.core.cluster import H100_1, ClusterSpec
from repro_torch.core.decision_tree import candidate_strategies, prune_dominated
from repro_torch.core.dynamic_programming import (interleave_realizable, optimize,
                                            schedule_space, schedule_windowable)
from repro_torch.core.profiler_model import ModelProfile, profile_model
from repro_torch.core.strategy import ExecutionPlan, LayerStrategy

INF = float("inf")


@dataclasses.dataclass
class SearchResult:
    plan: ExecutionPlan
    search_seconds: float
    evaluated: int                     # (pp, ga) combos costed
    feasible: bool
    #: GALV code -> count of candidates/plans the static verifier rejected
    #: (repro_torch.analysis.plan_check) — rejected WITH the code, never costed
    rejections: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SearchEngine:
    cfg: ModelConfig
    cluster: ClusterSpec = H100_1      # one card (JAX's default is the TPU pod)
    causal_frac: float = 0.5           # flash kernel skips the upper triangle
    opt_bytes: float = 8.0             # Adam state bytes/param (4.0 = bf16 m,v)
    calibration: cal.Calibration = cal.DEFAULT_CALIBRATION

    # ------------------------------------------------------------ internals
    def _profile(self, seq_len: int) -> ModelProfile:
        return profile_model(self.cfg, seq_len, causal_frac=self.causal_frac)

    def _union_candidates(self, devices: int, mesh_tp: Optional[int],
                          mesh_data: Optional[int] = None,
                          mesh_cp: Optional[int] = None,
                          seq_len: Optional[int] = None,
                          mesh_constrained: bool = True) -> list[LayerStrategy]:
        kinds = {"attn_block"}
        if self.cfg.num_experts:
            kinds.add("moe_block")
        if self.cfg.family in ("ssm", "hybrid"):
            kinds.add("mamba_block")
        seen: dict = {}
        for kind in kinds:
            for s in candidate_strategies(
                    self.cfg, devices,
                    max_tp=min(self.cluster.intra_size, devices),
                    mesh_constrained_tp=mesh_tp, mesh_data_axis=mesh_data,
                    layer_kind=kind, seq_len=seq_len,
                    mesh_constrained_cp=mesh_cp if mesh_constrained else None,
                    max_cp=mesh_cp if not mesh_constrained else None):
                seen[s] = None
        return list(seen)

    # ------------------------------------------------------------ search
    def search(
        self,
        seq_len: int,
        global_batch: int,
        *,
        total_devices: Optional[int] = None,
        mesh_axes: tuple = ("data", "model"),
        mesh_shape: tuple = (1, 1),
        mesh_constrained: bool = True,
        pp_options: Optional[list] = None,
        pp_schedule_options: Optional[list] = None,   # [(schedule, interleave), ...]
        grad_accum_options: Optional[list] = None,
        cp_options: Optional[list] = None,   # pin cp degrees (None = full space)
        n_buckets: int = 1024,
        arch: str = "",
        shape_name: str = "",
    ) -> SearchResult:
        t0 = time.perf_counter()
        cfg = self.cfg
        profile = self._profile(seq_len)
        devices_total = total_devices or int(np.prod(mesh_shape))
        mesh_tp = mesh_shape[mesh_axes.index("model")] if mesh_constrained else None
        mesh_data = mesh_shape[mesh_axes.index("data")] if mesh_constrained else None
        pods = mesh_shape[mesh_axes.index("pod")] if "pod" in mesh_axes else 1
        # cp degrees come from the mesh's cp axis (absent => cp stays 1)
        mesh_cp = mesh_shape[mesh_axes.index("cp")] if "cp" in mesh_axes else None

        if pp_options is None:
            pp_options = [1] if pods == 1 else [1, pods]
            if not mesh_constrained:
                pp_options = [p for p in (1, 2, 4, 8)
                              if p <= min(devices_total, len(profile.layers))]
        if grad_accum_options is None:
            grad_accum_options = [g for g in (1, 2, 4, 8, 16, 32)
                                  if global_batch % g == 0]

        sp_ok = cfg.family not in ("ssm",)   # SSD scan is sequential in seq
        best: Optional[ExecutionPlan] = None
        best_time = INF
        evaluated = 0
        rejections: dict = {}

        for pp in pp_options:
            if pp > 1 and (cfg.num_experts or not getattr_supports(cfg)):
                continue                      # runtime gate (see train_pp)
            if pp > 1 and cfg.num_layers % pp != 0:
                continue                      # stage_stack needs equal stages
            devices = devices_total // pp
            cands = self._union_candidates(devices, mesh_tp, mesh_data,
                                           mesh_cp=mesh_cp, seq_len=seq_len,
                                           mesh_constrained=mesh_constrained)
            if not sp_ok:
                cands = [c for c in cands if not c.sp]
            if cp_options is not None:
                cands = [c for c in cands if c.cp in cp_options]
            for ga in grad_accum_options:
                micro = global_batch // ga
                for sched, virt in self._schedules_for(pp, ga, pp_schedule_options):
                    evaluated += 1
                    plan = self._evaluate(profile, cands, devices, pp, ga, micro,
                                          mesh_axes, mesh_shape, n_buckets,
                                          arch=arch, shape_name=shape_name,
                                          schedule=sched, interleave=virt,
                                          rejections=rejections,
                                          mesh_constrained=mesh_constrained)
                    if plan is not None and plan.predicted_step_time < best_time:
                        best, best_time = plan, plan.predicted_step_time

        dt = time.perf_counter() - t0
        if best is None and self.opt_bytes > 4.0:
            # fp32 Adam states do not fit anywhere: retry with bf16 m/v
            # (AdamWConfig(m_dtype=v_dtype=bf16) in the runtime) — how the
            # search "discovers" grok-314B needs a low-precision optimizer
            # on a single 256-chip pod.
            retry = dataclasses.replace(self, opt_bytes=4.0)
            res = retry.search(seq_len, global_batch,
                               total_devices=devices_total, mesh_axes=mesh_axes,
                               mesh_shape=mesh_shape, mesh_constrained=mesh_constrained,
                               pp_options=pp_options,
                               pp_schedule_options=pp_schedule_options,
                               grad_accum_options=grad_accum_options,
                               cp_options=cp_options,
                               n_buckets=n_buckets, arch=arch, shape_name=shape_name)
            if res.feasible:
                res.plan.notes += " | bf16-adam (fp32 states infeasible)"
            for code, n in rejections.items():
                res.rejections[code] = res.rejections.get(code, 0) + n
            return dataclasses.replace(res, search_seconds=res.search_seconds + dt)
        if best is None:
            # infeasible everywhere: return max-sharding fallback, flagged
            fallback = LayerStrategy(tp=mesh_tp or 1, zero=3, remat="full",
                                     ep=1 if not cfg.num_experts else
                                     max(e for e in (1, 2, 4, 8, 16) if
                                         cfg.num_experts % e == 0 and
                                         e <= devices_total // (mesh_tp or 1)))
            best = _mk_plan(arch, shape_name, mesh_shape, mesh_axes, profile, cfg,
                            [fallback] * len(profile.layers), 1,
                            max(grad_accum_options), INF, INF)
            return SearchResult(best, dt, evaluated, feasible=False,
                                rejections=rejections)
        return SearchResult(best, dt, evaluated, feasible=True,
                            rejections=rejections)

    # ------------------------------------------------------------ schedules
    def _schedules_for(self, pp: int, ga: int,
                       requested: Optional[list]) -> list:
        """Schedule pairs to cost for one (pp, ga) combo: the full realizable
        space by default, or the requested subset filtered by the same
        runtime-realizability gates (schedule_space)."""
        if requested is None:
            return schedule_space(pp, ga, self.cfg.num_layers)
        if pp <= 1:
            return [("gpipe", 1)]
        # validate pinned pairs with the runtime gates directly (the default
        # space only explores power-of-two interleaves, but any v with
        # num_layers % (pp·v) == 0 is realizable when asked for explicitly)
        out = []
        for sched, v in requested:
            if sched == "gpipe" and v == 1:
                out.append((sched, v))
            elif sched == "1f1b" and v == 1 and schedule_windowable(pp, ga):
                out.append((sched, v))
            elif (sched == "interleaved"
                    and interleave_realizable(self.cfg.num_layers, pp, v)):
                out.append((sched, v))
        return out

    # ------------------------------------------------------------ one combo
    def _evaluate(self, profile: ModelProfile, cands: list, devices: int,
                  pp: int, ga: int, micro: int, mesh_axes, mesh_shape,
                  n_buckets: int, *, arch: str, shape_name: str,
                  schedule: str = "gpipe", interleave: int = 1,
                  rejections: Optional[dict] = None,
                  mesh_constrained: bool = True):
        cfg = self.cfg
        if rejections is None:
            rejections = {}
        layers = profile.layers
        L, C = len(layers), len(cands)
        times = np.full((L, C), INF)
        mems = np.full((L, C), INF)
        env = cm.CostEnv(cluster=self.cluster, devices=devices, pp=pp,
                         micro_batch=micro, grad_accum=ga,
                         opt_bytes=self.opt_bytes,
                         pp_schedule=schedule, pp_interleave=interleave,
                         calibration=self.calibration)
        for ci, s in enumerate(cands):
            # static verifier gate: a candidate failing an invariant is
            # rejected WITH its GALV code, never costed (the pre-verifier
            # filters here were silent `continue`s)
            code = pc.check_strategy(s, stage_devices=devices,
                                     micro_batch=micro, cfg=cfg,
                                     seq_len=profile.seq_len)
            if code is not None:
                rejections[code] = rejections.get(code, 0) + 1
                continue
            seen_shared: set = set()
            for li, lp in enumerate(layers):
                if s.ep > 1 and lp.kind != "moe_block":
                    continue
                if lp.kind == "moe_block" and cfg.num_experts % s.ep != 0:
                    continue
                if s.cp > 1 and (lp.kind != "attn_block"
                                 or lp.cp_ring_bytes == 0):
                    continue          # ring attention: dense attn blocks only
                count = True
                if lp.shared_group is not None:
                    count = lp.shared_group not in seen_shared
                    seen_shared.add(lp.shared_group)
                times[li, ci] = cm.layer_step_time(lp, s, env)
                mems[li, ci] = mm.layer_memory(lp, s, env, count_params=count)

        # Pareto prune on the aggregate (sum over layers where valid)
        valid_cols = [c for c in range(C) if np.isfinite(times[:, c]).any()]
        if not valid_cols:
            return None
        agg_t = [float(np.nansum(np.where(np.isfinite(times[:, c]), times[:, c], 0)))
                 for c in valid_cols]
        agg_m = [float(np.nansum(np.where(np.isfinite(mems[:, c]), mems[:, c], 0)))
                 for c in valid_cols]
        keep = [valid_cols[i] for i in prune_dominated(
            [cands[c] for c in valid_cols], agg_t, agg_m)]
        # MoE layers need their own Pareto set — union both
        if cfg.num_experts:
            moe_rows = [i for i, lp in enumerate(layers) if lp.kind == "moe_block"]
            if moe_rows:
                r = moe_rows[0]
                ok = [c for c in valid_cols if np.isfinite(times[r, c])]
                keep2 = [ok[i] for i in prune_dominated(
                    [cands[c] for c in ok],
                    [float(times[r, c]) for c in ok],
                    [float(mems[r, c]) for c in ok])]
                keep = sorted(set(keep) | set(keep2))
        cands = [cands[c] for c in keep]
        times, mems = times[:, keep], mems[:, keep]
        C = len(cands)

        # transition matrix (boundary resharding)
        env0 = env
        trans = np.zeros((C, C))
        for i in range(C):
            for j in range(C):
                trans[i, j] = cm.transition_time(cands[i], cands[j], layers[0], env0)

        # budget after fixed memory (embed/head under best-tp strategy)
        fixed_strat = max(cands, key=lambda s: (s.tp, s.zero))
        env_f = env
        fixed = mm.fixed_memory(profile, fixed_strat, env_f)
        budget = self.cluster.hbm_bytes / self.cluster.mem_overhead - fixed
        if pp > 1:
            budget = budget * pp    # layers divide across stages; DP sums all layers

        big = np.nanmax(times[np.isfinite(times)]) if np.isfinite(times).any() else 1.0
        times = np.where(np.isfinite(times), times, big * 1e6)
        mems = np.where(np.isfinite(mems), mems, budget * 1e3)

        # The embeddings/logits follow the min-fixed-memory strategy among
        # the chosen set (the runtime applies plan.default_strategy to them).
        # Because that choice feeds back into the DP's budget, iterate the
        # (budget -> DP -> fixed_choice) loop to a fixed point (<=3 rounds).
        env_h = env
        for _ in range(3):
            res = optimize(times, mems, budget, trans, n_buckets=n_buckets)
            if not res.feasible:
                return None
            strategies = [cands[c] for c in res.choices]
            distinct = list(dict.fromkeys(strategies))
            fixed_choice = min(distinct, key=lambda s: mm.fixed_memory(profile, s, env))
            mem_total = mm.plan_memory(profile, strategies, env_h,
                                       fixed_strategy=fixed_choice)
            if mem_total <= self.cluster.hbm_bytes:
                break
            new_budget = (self.cluster.hbm_bytes / self.cluster.mem_overhead
                          - mm.fixed_memory(profile, fixed_choice, env))
            if new_budget >= budget - 1e6:      # no progress possible
                return None
            budget = new_budget
        else:
            return None
        step = res.total_time
        per_micro_stage = res.total_time / max(ga, 1) / pp
        step += cm.pipeline_extras(profile, env_h, per_micro_stage, fixed_choice)
        step += cm.head_time(profile, fixed_choice, env_h)
        plan = _mk_plan(arch, shape_name, mesh_shape, mesh_axes, profile, self.cfg,
                        strategies, pp, ga, step, mem_total, default=fixed_choice,
                        schedule=schedule, interleave=interleave)
        # mandatory full-plan verification: a winning DP assignment that
        # still violates an invariant is rejected with its code(s), not
        # silently returned.  The caller's mesh is ground truth for the
        # search (multi-pod dry-runs exceed one pod's chip count), so the
        # capacity bound is widened to the mesh — --validate-only and the
        # elastic replan police real capacity.
        cl = self.cluster
        if plan.num_devices > cl.chips:
            cl = dataclasses.replace(cl, chips=plan.num_devices)
        report = pc.check_plan(
            plan, cl, cfg, seq_len=profile.seq_len,
            global_batch=micro * ga, profile=profile,
            profile_strategies=strategies, opt_bytes=self.opt_bytes,
            mesh_constrained=mesh_constrained, calibration=self.calibration)
        if not report.ok():
            for rcode in report.error_codes():
                rejections[rcode] = rejections.get(rcode, 0) + 1
            return None
        return plan

    # ------------------------------------------------------------ serving
    def search_serve(self, *, max_context: int,
                     prompt_len: Optional[int] = None, slo=None,
                     **kw) -> "ServeSearchResult":
        """The serve objective: pick (tp, num_slots, page_size) for
        continuous-batching decode under an SLO — see :func:`search_serve`."""
        return search_serve(self, max_context=max_context,
                            prompt_len=prompt_len, slo=slo, **kw)


def getattr_supports(cfg: ModelConfig) -> bool:
    """PP runtime supports stacked-block families (see runtime/train_pp)."""
    return cfg.family in ("dense", "vlm", "ssm")


def evaluate_uniform(
    cfg: ModelConfig,
    cluster: ClusterSpec,
    seq_len: int,
    global_batch: int,
    devices: int,
    strategy: LayerStrategy,
    *,
    pp: int = 1,
    grad_accum: int = 1,
    pp_schedule: str = "gpipe",
    pp_interleave: int = 1,
    causal_frac: float = 0.5,
    opt_bytes: float = 8.0,
    calibration: cal.Calibration = cal.DEFAULT_CALIBRATION,
) -> tuple[float, float, bool]:
    """(step_time, per-device memory, feasible) for one uniform strategy —
    used to cost the manually-tuned baseline systems (Fig. 3 benchmark)."""
    profile = profile_model(cfg, seq_len, causal_frac=causal_frac)
    stage_devices = devices // pp
    dp = stage_devices // (strategy.tp * strategy.cp)
    micro = global_batch // grad_accum
    if dp < 1 or dp * strategy.tp * strategy.cp != stage_devices or micro % dp != 0:
        return INF, INF, False
    env = cm.CostEnv(cluster=cluster, devices=stage_devices, pp=pp,
                     micro_batch=micro, grad_accum=grad_accum,
                     opt_bytes=opt_bytes,
                     pp_schedule=pp_schedule, pp_interleave=pp_interleave,
                     calibration=calibration)
    t = 0.0
    seen: set = set()
    strategies = []
    for lp in profile.layers:
        if strategy.ep > 1 and (lp.kind != "moe_block"
                                or cfg.num_experts % strategy.ep != 0):
            s = dataclasses.replace(strategy, ep=1)
        else:
            s = strategy
        strategies.append(s)
        t += cm.layer_step_time(lp, s, env)
    t += cm.head_time(profile, strategy, env)
    t += cm.pipeline_extras(profile, env, t / max(grad_accum, 1) / pp, strategy)
    mem = mm.plan_memory(profile, strategies, env)
    return t, mem, mem <= cluster.hbm_bytes


def _mk_plan(arch, shape_name, mesh_shape, mesh_axes, profile, cfg,
             profile_strategies, pp, ga, step, mem, default=None,
             schedule="gpipe", interleave=1) -> ExecutionPlan:
    runtime_strats = to_runtime_strategies(cfg, profile, profile_strategies)
    if default is None:
        default = max(set(runtime_strats), key=runtime_strats.count)
    sched_note = f", {schedule}" + (f"x{interleave}" if interleave > 1 else "") \
        if pp > 1 else ""
    return ExecutionPlan(
        arch=arch or cfg.name, shape=shape_name,
        mesh_axes=tuple(mesh_axes), mesh_shape=tuple(mesh_shape),
        pp=pp, pp_schedule=schedule, pp_interleave=interleave, grad_accum=ga,
        layer_strategies=runtime_strats, default_strategy=default,
        predicted_step_time=float(step), predicted_memory=float(mem),
        notes=f"searched: {len(set(runtime_strats))} distinct strategies{sched_note}",
    )


def to_runtime_strategies(cfg: ModelConfig, profile: ModelProfile,
                          choices: list) -> list:
    """Map per-profile-layer strategies onto the model's stacked blocks.

    hybrid: shared-attn profile entries fold into the preceding mamba layer's
    position (runtime is uniform for hybrid anyway); audio: enc+dec profile
    entries -> decoder-length majority list.

    Stacked-block families get their strategy multiset COALESCED into
    contiguous runs (stable by first appearance): the stack is homogeneous,
    so any permutation of the per-layer assignment has identical cost and
    memory, while contiguity minimizes scan-group count — the DP freely
    interleaves equal-cost strategies, which exploded compiled buffer usage
    4–7× before coalescing (measured: qwen3 train_4k 156 GB -> 36 GB)."""
    if cfg.family == "hybrid":
        mamba = [s for lp, s in zip(profile.layers, choices)
                 if lp.kind == "mamba_block"]
        maj = max(set(mamba), key=mamba.count)
        return [maj] * cfg.num_layers
    if cfg.family == "audio":
        dec = [s for lp, s in zip(profile.layers, choices) if lp.kind == "dec_block"]
        maj = max(set(dec), key=dec.count) if dec else choices[0]
        return [maj] * cfg.num_layers
    order: list = []
    counts: dict = {}
    for s in choices:
        if s not in counts:
            order.append(s)
            counts[s] = 0
        counts[s] += 1
    out: list = []
    for s in order:
        out.extend([s] * counts[s])
    return out


# --------------------------------------------------------------------------
# serving plans (decode/prefill cells) — heuristic, not DP-searched
# --------------------------------------------------------------------------

def serving_plan(cfg: ModelConfig, *, seq_len: int, batch: int,
                 mesh_shape=(1, 1), mesh_axes=("data", "model"),
                 cluster: ClusterSpec = H100_1,
                 arch: str = "", shape_name: str = "") -> ExecutionPlan:
    """TP over the model axis; ZeRO-3-style weight sharding over DP only when
    parameters would not fit replicated; cache sharded per cache_spec_tree."""
    tp = mesh_shape[mesh_axes.index("model")]
    devices = int(np.prod(mesh_shape))
    profile = profile_model(cfg, min(seq_len, 4096))
    param_bytes = 2.0 * profile.total_params()
    cache = mm.kv_cache_bytes(cfg, batch, seq_len)
    per_dev_replicated = param_bytes / tp + cache / devices
    zero = 0 if per_dev_replicated < 0.55 * cluster.hbm_bytes else 3
    strat = LayerStrategy(tp=tp, zero=zero, remat="none")
    return ExecutionPlan(
        arch=arch or cfg.name, shape=shape_name,
        mesh_axes=tuple(mesh_axes), mesh_shape=tuple(mesh_shape),
        pp=1, grad_accum=1,
        layer_strategies=[strat] * cfg.num_layers, default_strategy=strat,
        predicted_memory=per_dev_replicated if zero == 0 else
        param_bytes / devices + cache / devices,
        notes=f"serving heuristic: zero={zero} (params {param_bytes/1e9:.1f} GB)",
    )


# --------------------------------------------------------------------------
# serve objective — searched continuous-batching deployment
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServePlanChoice:
    """One searched serving deployment: tp degree + paged-cache geometry,
    with the roofline's latency/throughput predictions attached."""

    tp: int
    num_slots: int
    page_size: int
    num_pages: int                    # incl. the reserved null page
    ttft_s: float                     # queue-free prefill latency, prompt_len
    tpot_s: float                     # steady-state per-token latency
    tokens_per_s: float               # aggregate decode throughput, full slots
    tokens_per_s_per_chip: float      # the objective: throughput / tp
    bound: str                        # "memory" | "compute" at steady state
    pool_gb: float                    # kv page pool, device bytes / 1e9


@dataclasses.dataclass
class ServeSearchResult:
    choice: Optional[ServePlanChoice]
    evaluated: int                    # (tp, slots, page) combos costed
    search_seconds: float
    feasible: bool
    #: GALV code (or "slo-ttft"/"slo-tpot"/"slo-rate") -> rejected candidates
    rejections: dict = dataclasses.field(default_factory=dict)
    candidates: list = dataclasses.field(default_factory=list)  # all feasible


def search_serve(
    engine: "SearchEngine",
    *,
    max_context: int,
    prompt_len: Optional[int] = None,
    slo=None,                         # ttft_s / tpot_s / request_rate attrs
    tp_options: Optional[list] = None,
    num_slots_options: tuple = (1, 2, 4, 8, 16, 32, 64, 128, 256),
    page_size_options: tuple = (8, 16, 32, 64, 128),
    bytes_per_elem: float = 2.0,
) -> ServeSearchResult:
    """Pick (tp, num_slots, page_size) for continuous-batching serving.

    Every candidate geometry is gated through the static serving verifier
    (``plan_check.check_serve`` — GALV080/081/082) before it is costed;
    rejected candidates are tallied by code, exactly like the training
    search.  Survivors are costed with the decode roofline
    (``cost_model.decode_step_time`` at the steady-state kv length of
    ``max_context/2``) and the prefill estimate, filtered against the SLO
    (``slo.ttft_s`` / ``slo.tpot_s`` p50 targets, ``slo.request_rate``
    offered load), and ranked by **decode tokens/sec per chip** — the
    serving analogue of the training search's step-time objective.
    """
    t0 = time.perf_counter()
    cfg = engine.cfg
    cluster = engine.cluster
    prompt_len = prompt_len if prompt_len is not None else max_context // 2
    profile = profile_model(cfg, min(max_context, 4096))
    if tp_options is None:
        tp_options = [t for t in (1, 2, 4, 8, 16, 32)
                      if t <= cluster.intra_size
                      and cfg.num_heads % t == 0]
    gen_len = max(max_context - prompt_len, 1)

    rejections: dict = {}
    feasible: list[ServePlanChoice] = []
    evaluated = 0

    def reject(key: str) -> None:
        rejections[key] = rejections.get(key, 0) + 1

    for tp in tp_options:
        for slots in num_slots_options:
            for page in page_size_options:
                spec = pc.ServeSpec(num_slots=slots, page_size=page,
                                    max_context=max_context, tp=tp,
                                    bytes_per_elem=bytes_per_elem)
                report = pc.check_serve(spec, cluster, cfg)
                if not report.ok():
                    for code in report.error_codes():
                        reject(code)
                    continue
                evaluated += 1
                dc = cm.decode_step_time(
                    profile, cluster, kv_len=max_context // 2, tp=tp,
                    batch=slots, bytes_per_elem=bytes_per_elem,
                    calibration=engine.calibration)
                ttft = cm.prefill_time(
                    profile, cluster, prompt_len=prompt_len, tp=tp,
                    bytes_per_elem=bytes_per_elem,
                    calibration=engine.calibration)
                tokens_per_s = slots / dc.step_s
                if slo is not None:
                    if (getattr(slo, "ttft_s", None)
                            and ttft > slo.ttft_s):
                        reject("slo-ttft")
                        continue
                    if (getattr(slo, "tpot_s", None)
                            and dc.step_s > slo.tpot_s):
                        reject("slo-tpot")
                        continue
                    rate = getattr(slo, "request_rate", None)
                    if rate and tokens_per_s < rate * gen_len:
                        reject("slo-rate")
                        continue
                num_pages = spec.resolved_num_pages()
                pool = (2.0 * bytes_per_elem * cfg.num_layers * num_pages
                        * page * cfg.num_kv_heads
                        * cfg.resolved_head_dim) / tp
                feasible.append(ServePlanChoice(
                    tp=tp, num_slots=slots, page_size=page,
                    num_pages=num_pages, ttft_s=ttft, tpot_s=dc.step_s,
                    tokens_per_s=tokens_per_s,
                    tokens_per_s_per_chip=tokens_per_s / tp,
                    bound=dc.bound, pool_gb=pool / 1e9))

    feasible.sort(key=lambda c: (-c.tokens_per_s_per_chip, c.tpot_s,
                                 c.tp, c.page_size))
    return ServeSearchResult(
        choice=feasible[0] if feasible else None,
        evaluated=evaluated, search_seconds=time.perf_counter() - t0,
        feasible=bool(feasible), rejections=rejections,
        candidates=feasible)
