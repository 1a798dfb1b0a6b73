"""Training launcher: plan -> check -> construct -> train.

On one device (``WORLD_SIZE`` unset or 1), the single-device path of
``repro.launch.train``: the plan is uniform, built
from ``--remat`` and ``--grad-accum`` exactly as the JAX launcher builds it
on one device (it does not search there, and neither does this one).  The
cost model prices that plan on one H100 (``H100_1``), calibrated from
``--profile-cache`` when given (see the ``profile`` subcommand); it
prints the plan, the predicted breakdown, then trains through
``construct_hybrid_parallel_model(model, plan).train_step`` on
``SyntheticDataset`` batches and ends with GALV070: the median step time
against the plan's prediction.  ``--device`` defaults to ``cuda`` (the CUDA
kernels); ``--device cpu`` runs the plain versions.

    python -m repro_torch.launch.train --arch llama3.2-1b --seq 4096 \\
        --batch 8 --grad-accum 4 --remat selective --steps 3
    python -m repro_torch.launch.train profile --full --seq 1024,4096 --dtype bf16

Under ``torchrun`` (``WORLD_SIZE`` n > 1) it follows JAX's multi-device
branch: the mesh ``train_mesh_spec(n)``, a ``SearchEngine`` over it on an
n-card H100 cluster (``H100_NODE8`` with ``chips=n``, ``intra_size=min(n,
8)``) with ``pp_options=[--pp]``, the plan line printed by rank 0 alone, then
the mesh (NCCL on CUDA, gloo on the CPU), ``construct_hybrid_parallel_model``
and training, every rank building the same global ``SyntheticDataset``
batch and taking its rows of it; the moe family too (its layers route
the global microbatch; ``ep`` > 1 where the search picks it: at n = 4 the
mesh is (2, 2), so ep 2 is a candidate).  ``--validate-only`` checks the
searched plan on that cluster and exits 0 or 1.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch llama3.2-1b \
        --reduced --device cpu --steps 2 --seq 32 --batch 8

``--pp N`` (with ``--pp-schedule {searched,gpipe,1f1b,interleaved}`` and
``--pp-interleave v``) takes JAX's pipeline branch: the mesh
``train_mesh_spec(n, pp=N)`` = (pod N, data, model), the search over
``pp_options=[N]`` and the schedule asked for, JAX's ``SystemExit`` when no
feasible plan has that pp, and ``runtime.train_pp.PipelineTrainer`` for a
plan with pp > 1; one device keeps the single-device branch, which
ignores ``--pp`` as JAX's does.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch llama3.2-1b \
        --reduced --device cpu --steps 2 --seq 32 --batch 8 --pp 2 --pp-schedule 1f1b

``--cp N`` takes JAX's context-parallel branch for the dense family: the
mesh ``train_mesh_spec(n, cp=N)`` = (cp N, data, model), the search over
``cp_options=[N]``, and ``construct_hybrid_parallel_model``, whose
attention runs the ring over the cp axis.  ``--seq`` must split into 2·N
zig-zag chunks and the arch must be dense (JAX's ``SystemExit``s); one
device prints a warning and ignores ``--cp``, as JAX's does.  ``--pp`` with
``--cp`` builds ``train_mesh_spec(n, pp=N, cp=M)`` = (pod N, cp M, data,
model), searches with both pinned, and trains the plan through
``PipelineTrainer``, each stage running the ring; a searched plan whose pp
or cp is not the one asked for exits as JAX's does.

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch llama3.2-1b \
        --reduced --device cpu --steps 2 --seq 32 --batch 4 --cp 2
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch llama3.2-1b \
        --reduced --device cpu --steps 2 --seq 32 --batch 8 --pp 2 --cp 2

``--ckpt-dir DIR`` saves the canonical state (``runtime/checkpoint.py``,
JAX's format v2, readable by either package) every ``--ckpt-every`` steps
and once at the end, skipping a final save that repeats the last periodic
one; ``--ckpt-async on`` (the default) writes on a background thread
(``CheckpointWriter``), ``off`` synchronously, byte-identical either way.
``--resume`` restores the latest step of ``DIR``: GALV050 refuses a
checkpoint of another model (arch or layer count) before any array is
read, then the trainer places the canonical state (``place_params`` /
``place_opt_state``) and training continues from the saved step up to
``--steps`` on ``SyntheticDataset.batch(step)``.  Under ``torchrun`` every
rank takes part in ``checkpoint_state``'s gathers, rank 0 writes while the
others wait at a barrier, and every rank reads the checkpoint on resume.
A checkpoint whose keys are not this trainer's canonical ones (JAX's
pre-resize grouped layout) is refused.

    python -m repro_torch.launch.train --arch llama3.2-1b --reduced --device cpu \
        --steps 4 --seq 32 --batch 4 --ckpt-dir /tmp/ck --ckpt-every 2
    python -m repro_torch.launch.train ... --ckpt-dir /tmp/ck --resume --steps 6

``--run-dir DIR`` writes the run's JSONL log (``repro_torch.obs.RunSink``,
``DIR/run.jsonl``, JAX's schema and bytes) as JAX's ``main`` does:
``run_start`` with ``{arch, seq, batch, steps, devices}``, one ``plan``
event (reason ``search``, the predicted breakdown; ``search_rejections``
on the mesh branch), a ``step`` event every ``--log-every`` steps and at
the last (the ``StepTimer``'s record — step time, tokens/s and MFU against
989 TFLOP/s, the peak of the H100 the plan was priced on, times the
devices — plus ``loss`` and ``grad_norm``), ``drift`` events while the
``DriftMonitor`` sees the step time off the prediction (GALV070's warning
and a ``DriftReplanAdvisor`` ``replan_signal`` when sustained), ``ckpt``
events (``queued`` / ``written`` from the async writer, ``written`` for a
sync save), and ``run_end`` with the metrics' snapshot and the span
timeline.  ``scripts/render_run.py DIR`` renders it.  Three departures
from JAX: the ``memory`` event is ``torch.cuda.max_memory_allocated`` after
the first step, on CUDA only (JAX reads its compiled step's memory
analysis before it); under ``torchrun`` rank 0 alone opens the sink (the
others hold a ``NullSink``) and the timer's fence is synchronize plus a
barrier, so a step's time is the slowest rank's; the printed step line
keeps the port's form (``step N loss … grad_norm … step_time … ms tok/s
…``, which its tests and chip_smoke parse) with the record's MFU appended,
where JAX prints ``obs.format_live_line`` of the same record.  As in
JAX, ``run_end``'s ``spans`` is the whole process's
``obs.default_tracer()`` timeline, never cleared: a process that calls
``main`` twice, or ran the step engine or a writer before, logs those
spans too.

    python -m repro_torch.launch.train --arch llama3.2-1b --reduced --device cpu \
        --steps 4 --seq 32 --batch 4 --log-every 2 --run-dir results/runs/r0
    PYTHONPATH=src python scripts/render_run.py results/runs/r0

``--simulate-failure-at-step S1,S2,...`` (alias ``--simulate-failure-at``)
with ``--resize-to N1,N2,...`` is JAX's live elastic resize, under
``torchrun``: at step Si rank 0 replans for Ni devices
(``runtime.elastic.replan_and_diff`` on the cluster it searched on) and
broadcasts the plan (``broadcast_object_list``), every rank builds the
plan's mesh over the first Ni ranks (``make_mesh(..., ranks=Ni)``, so
every rank makes every group) and its trainer, and the state moves
(``runtime.resize.migrate``, or ``migrate_via_checkpoint`` under
``--elastic-mode checkpoint``; both bitwise the same) with the step, the
data cursor and the host generator carried; training goes on from step Si.
Each resize logs JAX's ``plan`` event (reason ``resize``, with the
``migration`` spec and its ``migration spec:`` line) and ``resize`` event,
then the step timer's peak counts the new plan's devices and the drift
monitor takes its prediction.  A rank outside the new mesh is idle: it
runs no step, takes part only in the resize events (the plan's broadcast,
``new_group``, the migration's gathers, broadcast and barriers), and
reaches the world's barrier at the end; the step fence, the checkpoints'
barrier and their gathers use the running mesh's group.  ``--digest``
prints JAX's ``digest params=… opt_m=… loss=…``: the canonical params'
and m's absolute sums in float64 and the last step's loss, so two runs'
states can be compared.  Events before a resumed step are dropped with
JAX's warning.  On one device ``--resize-to`` exits as JAX's does (its
text names ``torchrun`` where JAX's names ``XLA_FLAGS``), and
``--simulate-failure-at-step`` alone is JAX's legacy advisory: the plan
for 192 of 256 devices, printed and logged (reason ``replan-advisory``).
A replanned plan the runtime refuses (one mixing cp degrees:
``check_layout``) raises on every rank; nothing falls back.  NCCL refuses
ranks that share one card, so ``chip_smoke.py`` holds the resize on gloo
ranks through the library, and the launcher's run is held on the CPU.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch llama3.2-1b \\
        --reduced --device cpu --steps 6 --seq 32 --batch 8 \\
        --simulate-failure-at-step 2,4 --resize-to 2,4 --digest

Every rank reaches one barrier before the process group is torn down, on
each path that returns and on the ``SystemExit``s every rank raises alike,
so a rank that finishes first cannot close its connections while a slower
one still builds its own.

``--audit`` is JAX's ``_run_audit`` on the port's evidence: before the first
step, and after every resize's rebuild, each rank traces its own step
(``analysis/step_trace.py``) on fake tensors of its own shapes
(``hp.abstract_params()`` / ``abstract_opt_state()`` and the global batch's
``input_specs``) over the run's real mesh — a collective on a fake tensor
sends nothing, a kernel launches nothing; on one card, with no collective
to trace, a trainer of the same plan on ``meta`` tensors, which take the
kernels' route at half the host time — and audits it against the plan
(``analysis/step_audit.py``: GALV090-093).  Rank 0 emits JAX's ``audit``
event and every rank's rank-0 printer shows ``format_table()``; audit
errors raise ``SystemExit`` with JAX's text on every rank, before any real
step.  The ``memory`` event stays the measured peak; with ``--audit`` the
launcher also prints the traced peak (arguments plus temp) beside it after
the first step.

    python -m repro_torch.launch.train --arch llama3.2-1b --reduced --device cpu \
        --steps 2 --seq 32 --batch 4 --audit --run-dir results/runs/a0
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import sys
import time
import warnings
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.analysis import plan_check
from repro_torch.analysis.invariants import cp_seq_divisible
from repro_torch.configs.registry import ARCH_IDS, ModelConfig, get_config
from repro_torch.core import calibrate
from repro_torch.core import cost_model as cm
from repro_torch.core import profile_cache as pcache_lib
from repro_torch.core.cluster import H100_1, H100_NODE8, ClusterSpec
from repro_torch.core.profiler_model import profile_model
from repro_torch.core.search import SearchEngine, evaluate_uniform
from repro_torch.core.strategy import ExecutionPlan, LayerStrategy, uniform_plan
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves
from repro_torch.runtime import checkpoint as ckpt_lib
from repro_torch.runtime import resize as resize_lib
from repro_torch.runtime.data import SyntheticDataset
from repro_torch.runtime.elastic import (DriftReplanAdvisor, ElasticEvent, replan,
                                         replan_and_diff)
from repro_torch.runtime.train import construct_hybrid_parallel_model

PRESET_100M = ModelConfig(
    name="llama-100m", family="dense", num_layers=12, d_model=640,
    num_heads=10, num_kv_heads=10, d_ff=2560, vocab_size=32_000,
    head_dim=64, mlp_type="swiglu", rope_theta=10_000.0)


def resolve_cfg(args) -> ModelConfig:
    if args.preset == "100m":
        return PRESET_100M
    cfg = get_config(args.arch)
    return cfg.reduced() if args.reduced else cfg


def _int_list(text: str) -> list[int]:
    return [int(tok) for tok in str(text).split(",") if tok.strip()]


def _parse_events(args, n_dev: int) -> list[tuple[int, int]]:
    """[(fire_step, new_device_count), ...] from --simulate-failure-at-step /
    --resize-to, validated against the live device pool (JAX's, with its
    texts)."""
    steps = _int_list(args.simulate_failure_at_step or "")
    sizes = _int_list(args.resize_to or "")
    if not steps:
        if sizes:
            raise SystemExit("--resize-to needs --simulate-failure-at-step "
                             "entries naming when each resize fires")
        return []
    if sizes and len(sizes) != len(steps):
        raise SystemExit("--resize-to needs one device count per "
                         "--simulate-failure-at-step entry")
    events = list(zip(steps, sizes)) if sizes else [(s, 0) for s in steps]
    if any(b <= a for a, b in zip(steps, steps[1:])):
        raise SystemExit("--simulate-failure-at-step entries must be "
                         "strictly increasing")
    for _, n in events:
        if sizes and n < 1:
            raise SystemExit(f"--resize-to {n} is not a device count")
        if n > n_dev:
            raise SystemExit(f"--resize-to {n} exceeds the live device pool "
                             f"({n_dev}); grow events can only reuse devices "
                             "this process already sees")
    return events


class _Run:
    """What this rank trains: the trainer (an ``OutsideMesh`` on a rank a
    shrink left idle), its params and optimizer state, and the last step's
    metrics.  ``barrier`` and ``sync`` span the running mesh's ranks; a
    resize rebinds the rest."""

    def __init__(self, hp, params, opt):
        self.last_metrics = None
        self.rebind(hp, params, opt)

    def rebind(self, hp, params, opt) -> None:
        self.hp, self.params, self.opt = hp, params, opt

    @property
    def plan(self) -> ExecutionPlan:
        return self.hp.plan

    @property
    def member(self) -> bool:
        return resize_lib.holds_state(self.hp)

    def barrier(self) -> None:
        mesh = self.hp.mesh
        if mesh is not None and mesh.member and mesh.size > 1:
            import torch.distributed as dist

            dist.barrier(group=mesh.group(mesh.axis_names).pg)

    def sync(self) -> None:
        device = self.hp.model.device if self.hp.mesh is None else self.hp.mesh.device
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.barrier()

def _predicted_breakdown(plan: ExecutionPlan, cfg: ModelConfig, seq_len: int,
                         global_batch: int, calibration,
                         cluster: ClusterSpec = H100_1) -> dict:
    """Cost-model comm-vs-compute split for ``plan`` on ``cluster`` (seconds
    per step), beside the plan's predicted step time and memory."""
    profile = profile_model(cfg, seq_len)
    micro = max(global_batch // max(plan.grad_accum, 1), 1)
    env = cm.CostEnv(cluster=cluster,
                     devices=plan.num_devices // max(plan.pp, 1),
                     pp=plan.pp, micro_batch=micro,
                     grad_accum=plan.grad_accum,
                     pp_schedule=plan.pp_schedule,
                     pp_interleave=plan.pp_interleave,
                     calibration=calibration)
    if len(plan.layer_strategies) == len(profile.layers):
        strategies = list(plan.layer_strategies)
    else:
        strategies = [plan.default_strategy] * len(profile.layers)
    M = env.microbatches()
    compute = comm = 0.0
    for lp, s in zip(profile.layers, strategies):
        compute += M * cm.compute_time(lp, s, env)
        comm += M * (cm.tp_comm_time(lp, s, env)
                     + cm.cp_comm_time(lp, s, env)
                     + cm.ep_comm_time(lp, s, env))
        comm += cm.dp_comm_time(lp, s, env)
    return {"compute_s": compute, "comm_s": comm,
            "predicted_step_time_s": plan.predicted_step_time,
            "predicted_memory_bytes": plan.predicted_memory}


def _emit_plan(sink, reason: str, plan: ExecutionPlan, *, breakdown: Optional[dict] = None,
               spec: "Optional[resize_lib.MigrationSpec]" = None,
               rejections: Optional[dict] = None, say=print) -> None:
    """JAX's ``_emit_plan``: the plan line (and ``migration spec:`` after a
    resize), then one structured ``plan`` event (with the spec's
    ``migration``; and ``search_rejections`` when the search reported
    them)."""
    sched = (f" pp={plan.pp}/{plan.pp_schedule}"
             + (f"x{plan.pp_interleave}" if plan.pp_interleave > 1 else "")
             if plan.pp > 1 else "")
    note = plan.notes.split("|")[-1].strip() if plan.notes else ""
    say(f"plan[{reason}]: {plan.default_strategy.short()} ga={plan.grad_accum}{sched} "
        f"mesh={plan.mesh_shape} groups={len(plan.groups())}" + (f" ({note})" if note else ""))
    if spec is not None:
        say(f"   migration spec: {spec.summary()}")
    fields = dict(
        reason=reason, strategy=plan.default_strategy.short(),
        mesh_shape=list(plan.mesh_shape), mesh_axes=list(plan.mesh_axes),
        grad_accum=plan.grad_accum, pp=plan.pp, pp_schedule=plan.pp_schedule,
        predicted_step_time_s=plan.predicted_step_time, notes=note)
    if breakdown:
        fields["predicted_breakdown"] = breakdown
    if spec is not None:
        fields["migration"] = spec.summary()
    sink.emit("plan", **fields)
    if rejections:
        sink.emit("search_rejections", counts={k: int(v) for k, v in rejections.items()})


def _open_sink(args, cfg: ModelConfig, devices: int, rank: int = 0):
    """``--run-dir``'s ``RunSink`` on rank 0 (JAX's meta), else a ``NullSink``."""
    if not args.run_dir or rank != 0:
        return obs.NullSink()
    return obs.RunSink.create(args.run_dir, meta={
        "arch": cfg.name, "seq": args.seq, "batch": args.batch, "steps": args.steps,
        "devices": devices})


def _resume_step(args, plan: ExecutionPlan, say=print) -> Optional[int]:
    """The step ``--resume`` continues from: the latest in ``--ckpt-dir``,
    or None when there is none (JAX's: train from step 0).  GALV050 is
    checked on the saved plan before any param is drawn or read (each
    diagnostic printed, then exit 1)."""
    if not (args.resume and args.ckpt_dir
            and ckpt_lib.latest_step(args.ckpt_dir) is not None):
        return None
    saved = ckpt_lib.restore(args.ckpt_dir)           # the step index alone
    if saved["plan"] is not None:
        incompat = plan_check.check_checkpoint_compat(saved["plan"], plan)
        if incompat:
            for d in incompat:
                say(d)
            raise SystemExit(1)
    return saved["step"]


def _restore(args, hp, step: int, params, opt, say=print):
    """(params, opt) of ``step`` in ``--ckpt-dir``, laid out for ``hp``:
    the canonical state restored on the templates ``hp.checkpoint_state``
    gives, then ``place_params`` / ``place_opt_state``."""
    canon_p, canon_o = hp.checkpoint_state(params, opt)
    try:
        restored = ckpt_lib.restore(args.ckpt_dir, step, params_like=canon_p,
                                    opt_like=canon_o)
    except KeyError as e:
        raise SystemExit(f"--resume: step {step} of {args.ckpt_dir} has no leaf {e} of "
                         "this trainer's canonical state (a checkpoint in JAX's "
                         "pre-resize grouped layout is not read by the port)")
    del canon_p, canon_o, params, opt
    params = hp.place_params(restored["params"])
    opt = hp.place_opt_state(restored["opt"])
    say(f"resumed from step {step}")
    return params, opt


class _Checkpoints:
    """``--ckpt-dir``'s saves, as JAX's ``save_checkpoint``: the canonical
    state of ``run`` at a step (every rank of its mesh gathers it), written
    by rank 0 with ``run``'s plan, async (``CheckpointWriter(sink=sink)``)
    or sync (a ``ckpt`` event each); on a mesh the mesh's other ranks wait
    at its barrier.  ``run`` is read at each save, so a save after a resize
    takes the new trainer and plan.  ``stall_seconds`` sums the sync saves
    and the writer's blocking."""

    def __init__(self, args, run: _Run, sink, rank: int = 0):
        self.args, self.run, self.sink, self.rank = args, run, sink, rank
        self.writer = (ckpt_lib.CheckpointWriter(sink=sink)
                       if args.ckpt_async == "on" and rank == 0 else None)
        self.last = -1
        self.sync_seconds = 0.0

    def save(self, step: int) -> None:
        if step == self.last:                 # final save == last periodic save
            return
        self.last = step
        run = self.run
        canon_p, canon_o = run.hp.checkpoint_state(run.params, run.opt)
        if self.rank == 0:
            if self.writer is not None:
                self.writer.save_async(self.args.ckpt_dir, step, canon_p, canon_o, run.plan)
                print(f"checkpoint queued (async) step {step}")
            else:
                t0 = time.perf_counter()
                path = ckpt_lib.save(self.args.ckpt_dir, step, canon_p, canon_o, run.plan)
                dt = time.perf_counter() - t0
                self.sync_seconds += dt
                self.sink.emit("ckpt", phase="written", step=step, stall_seconds=dt,
                               queue_depth=0, path=str(path))
                print(f"checkpoint -> {path}")
        run.barrier()

    def close(self) -> None:
        """Drain the writer (raising its error); every rank then waits for
        rank 0's last file."""
        if self.writer is not None:
            path = self.writer.close()
            print(f"checkpoint -> {path} (async writer: {self.writer.saves_completed} "
                  f"saves, {self.writer.blocked_seconds * 1e3:.1f} ms total step-loop stall)")
        self.run.barrier()

    @property
    def stall_seconds(self) -> float:
        return self.sync_seconds + (self.writer.blocked_seconds if self.writer else 0.0)


def _step_timer(args, cfg: ModelConfig, cluster: ClusterSpec, devices: int,
                fence_fn=obs.fence) -> obs.StepTimer:
    """JAX's ``StepTimer``: ``--batch`` x ``--seq`` tokens a step, the
    model's 6N FLOPs a token, MFU against ``cluster``'s per-card peak (the
    cluster the plan was priced on) times ``devices``."""
    tokens = args.batch * args.seq
    return obs.StepTimer(
        obs.MetricsRegistry(), tokens_per_step=tokens,
        flops_per_step=profile_model(cfg, args.seq).model_flops_per_token() * tokens,
        peak_flops=cluster.peak_flops * devices, fence_fn=fence_fn)


def _run_audit(args, run: _Run, sink, say=print):
    """Trace this rank's step on fake tensors over the run's mesh, audit it
    against the plan, emit the ``audit`` event and print the table; raise
    JAX's ``SystemExit`` on audit errors.  Returns the trace."""
    from repro_torch.analysis.step_audit import audit_step
    from repro_torch.analysis.step_trace import materialize, trace_step, tracing
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.runtime.data import input_specs

    hp, cfg = run.hp, run.hp.model.cfg
    device = hp.device
    if hp.mesh is None and device.type == "cuda":
        # one card, no collective: a trainer of the same plan on meta tensors
        # takes the kernels' route as CUDA tensors do (their fake paths), at
        # about half a fake CUDA trace's host time
        device = torch.device("meta")
        hp = construct_hybrid_parallel_model(build_model(cfg, impl=hp.model.impl,
                                                         device=device), hp.plan)
    spec = ShapeSpec("launch", "train", args.seq, args.batch)
    with tracing(device):
        params = materialize(hp.abstract_params(), device)
        opt = materialize(hp.abstract_opt_state(), device)
        batch = materialize(input_specs(cfg, spec, hp.model), device)
        trace = trace_step(lambda: hp.train_step(params, opt, batch, donate=True),
                           (params, opt, batch), hp.mesh)
    say(f"step traced on {device.type} tensors in {trace.seconds:.1f} s")
    report = audit_step(run.plan, cfg, seq_len=args.seq, global_batch=args.batch,
                        trace=trace)
    sink.emit("audit", **report.to_event())
    say(report.format_table())
    if not report.ok():
        raise SystemExit("step audit failed: " + ", ".join(report.error_codes())
                         + " — the traced step does not match the plan")
    return trace


def _train_loop(args, run: _Run, start: int, ckpts, say, sink, timer: obs.StepTimer,
                cluster: ClusterSpec, events=(), on_event=None) -> list:
    """Steps ``start`` .. ``--steps - 1`` on ``SyntheticDataset.batch(step)``
    under JAX's telemetry (see the module note), a checkpoint every
    ``--ckpt-every`` steps and one at the end; emits ``run_end`` and
    returns the step times.  At each event's step (``events``: JAX's
    ``(step, devices)`` pairs) ``on_event(step, devices)`` runs first; when
    it reports a live resize the drift monitor takes the new plan's
    prediction and the timer's peak its devices (``cluster``'s per-card
    peak).  A rank a resize left outside the mesh runs no step."""
    cfg = run.hp.model.cfg
    ds = SyntheticDataset(cfg, seq_len=args.seq, global_batch=args.batch)
    registry = timer.registry
    drift = obs.DriftMonitor(run.plan.predicted_step_time)
    advisor = DriftReplanAdvisor(sink)
    drift_was_sustained = False
    t_start = time.perf_counter()
    times = []
    pending = [e for e in events if e[0] >= start]
    if len(pending) != len(events):
        say(f"warning: dropping {len(events) - len(pending)} resize event(s) "
            f"before resumed step {start}")
    audit_due, traced = args.audit, None
    for step in range(start, args.steps):
        if pending and step == pending[0][0]:
            _, new_dev = pending.pop(0)
            if on_event(step, new_dev):
                drift.reset(run.plan.predicted_step_time)
                timer.peak_flops = cluster.peak_flops * run.plan.num_devices
                audit_due = args.audit              # the rebuilt step
        if not run.member:
            continue
        if audit_due:
            traced, audit_due = _run_audit(args, run, sink, say), False
        batch = ds.batch(step)
        run.sync()
        timer.start()
        run.params, run.opt, metrics = run.hp.train_step(run.params, run.opt, batch)
        rec = timer.stop(step, (run.params, run.opt, metrics))
        run.last_metrics = metrics
        times.append(rec.step_time_s)
        device = run.hp.device
        if step == start and device.type == "cuda":
            peak = float(torch.cuda.max_memory_allocated(device))
            registry.gauge("peak_hbm_bytes").set(peak)
            sink.emit("memory", step=step, peak_hbm_bytes=peak)
            if traced is not None:
                say(f"peak memory: traced {(traced.argument_bytes + traced.temp_bytes) / 1e9:.3f}"
                    f" GB (arguments {traced.argument_bytes / 1e9:.3f} + temp "
                    f"{traced.temp_bytes / 1e9:.3f}), measured {peak / 1e9:.3f} GB")
        verdict = drift.observe(step, rec.step_time_s)
        if verdict is not None and (verdict.drifting or drift_was_sustained):
            sink.emit("drift", **verdict.as_dict())
            if verdict.sustained and not drift_was_sustained:
                warnings.warn(
                    f"GALV070 cost-model-drift: measured step-time EMA "
                    f"{verdict.measured_ema * 1e3:.1f} ms is {verdict.ratio:.2f}x the "
                    f"plan's predicted {verdict.predicted * 1e3:.1f} ms — re-profile and "
                    f"re-search recommended", stacklevel=2)
            advisor.observe(verdict)
            drift_was_sustained = verdict.sustained
        if step % args.log_every == 0 or step == args.steps - 1:
            # ONE device read for both numbers
            loss, gnorm = torch.stack([metrics["loss"].float(),
                                       metrics["grad_norm"].float()]).tolist()
            step_rec = {**rec.as_dict(), "loss": loss, "grad_norm": gnorm}
            sink.emit("step", **step_rec)
            say(f"step {step} loss {loss:.6f} grad_norm {gnorm:.6f} step_time "
                f"{rec.step_time_s * 1e3:.1f} ms tok/s {rec.tokens_per_sec:,.1f} "
                f"mfu {rec.mfu * 100:.2f}%")
        if ckpts is not None and (step + 1) % args.ckpt_every == 0:
            ckpts.save(step + 1)
    if ckpts is not None and run.member:
        ckpts.save(args.steps)
        ckpts.close()
    sink.emit("run_end", steps=timer.steps.value, tokens=timer.tokens_per_step * len(times),
              wall_seconds=time.perf_counter() - t_start,
              ckpt_stall_seconds=ckpts.stall_seconds if ckpts is not None else 0.0,
              drift_sustained=drift_was_sustained, metrics=registry.snapshot(),
              spans=obs.default_tracer().timeline())
    return times


def _advisory_replan(args, cfg: ModelConfig, sink, say=print) -> None:
    """JAX's legacy event (a failure step with no ``--resize-to``, or one
    device): the plan for 192 of 256 devices, printed and logged; nothing
    moves."""
    say("!! simulated node failure: re-searching plan for 75% capacity")
    event = ElasticEvent(old_devices=256, new_devices=192)
    new_plan = replan(get_config(args.arch) if not args.preset else cfg, event, args.seq,
                      args.batch)
    _emit_plan(sink, "replan-advisory", new_plan, say=say)


def _digest(run: _Run, say=print) -> None:
    """JAX's ``--digest`` line: the canonical params' and m's absolute sums
    in float64 and the last step's loss (every rank of the mesh gathers;
    rank 0 prints)."""
    if not run.member:
        return
    import numpy as np

    canon_p, canon_o = resize_lib.canonical_state(run.hp, run.params, run.opt)
    total = lambda tree: sum(float(np.abs(x.detach().cpu().double().numpy()).sum())
                             for x in tree_leaves(tree))
    p_sum, m_sum = total(canon_p), total(canon_o.m)
    m = run.last_metrics
    last_loss = float(m["loss"]) if m else float("nan")
    say(f"digest params={p_sum:.6e} opt_m={m_sum:.6e} loss={last_loss:.8f}")


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "profile":
        from repro_torch.launch import profile as profile_cli
        return profile_cli.main(argv[1:])
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3.2-1b")
    ap.add_argument("--preset", choices=["100m"], default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", "--seq-len", dest="seq", type=int, default=128,
                    help="sequence length (--seq-len is an alias)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=0,
                    help="microbatches per step (0 = 1 on one device)")
    ap.add_argument("--remat", default=None, choices=["none", "selective", "full"])
    ap.add_argument("--validate-only", action="store_true",
                    help="statically verify the plan (repro_torch.analysis."
                         "plan_check) and print the GALV diagnostic table — "
                         "no params are initialized; exit 1 on any error")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--profile-cache", default="",
                    help="path to a measured profile cache (see the `profile` "
                         "subcommand); calibrates the cost model's prediction "
                         "— analytic defaults when unset")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda: the CUDA kernels; cpu: the "
                         "plain versions)")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages (>1 stages the block stack over a pod axis)")
    ap.add_argument("--pp-schedule", default="searched",
                    choices=["searched", "gpipe", "1f1b", "interleaved"],
                    help="pipeline schedule; 'searched' lets the engine pick")
    ap.add_argument("--pp-interleave", type=int, default=2,
                    help="virtual stages per physical stage (interleaved only)")
    ap.add_argument("--cp", type=int, default=1,
                    help="context-parallel degree (>1 runs attention as a ring over a cp "
                         "mesh axis; needs seq %% (2*cp) == 0)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-async", default="on", choices=["on", "off"],
                    help="'on' (default) writes checkpoints on a background "
                         "writer thread (the step loop only ever blocks on "
                         "the previous save); 'off' writes synchronously — "
                         "byte-identical output either way")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--simulate-failure-at-step", "--simulate-failure-at",
                    dest="simulate_failure_at_step", default="",
                    help="comma-separated steps at which to fire a simulated "
                         "membership change (with --resize-to: live resize; "
                         "without: legacy replan-and-print)")
    ap.add_argument("--resize-to", default="",
                    help="comma-separated surviving device counts, one per "
                         "--simulate-failure-at-step entry; each event "
                         "replans + migrates live state onto the new mesh")
    ap.add_argument("--elastic-mode", default="live", choices=["live", "checkpoint"],
                    help="how a resize event moves state: 'live' = in-memory "
                         "migration (gathers, the grow broadcast, the new "
                         "trainer's placement); 'checkpoint' = save/restore "
                         "round trip (the fallback path / equivalence oracle)")
    ap.add_argument("--digest", action="store_true",
                    help="print a deterministic state digest at the end "
                         "(params/opt sums + final loss) — lets two runs be "
                         "compared for bitwise-equivalent training state")
    ap.add_argument("--audit", action="store_true",
                    help="audit the traced step against the plan before the first "
                         "step (repro_torch.analysis.step_audit, GALV090-093: "
                         "per-axis collective census vs the cost model, dtype drift, "
                         "remat presence, host reads); writes an `audit` event to the "
                         "run sink and exits on audit errors")
    ap.add_argument("--run-dir", default="",
                    help="directory for the JSONL run log (repro_torch.obs "
                         "RunSink; e.g. results/runs/<run_id>) — step "
                         "metrics, plan/resize/ckpt/drift events; render a "
                         "report with scripts/render_run.py")
    args = ap.parse_args(argv)

    calibration = calibrate.DEFAULT_CALIBRATION
    if args.profile_cache:
        try:
            calibration = calibrate.load_calibration(args.profile_cache)
        except FileNotFoundError:
            raise SystemExit(f"--profile-cache {args.profile_cache}: no such "
                             "file — run the `profile` subcommand first")
        except (pcache_lib.CorruptProfileCacheError,
                pcache_lib.StaleProfileCacheError) as e:
            raise SystemExit(f"--profile-cache: {e}")
        print(f"calibration: {calibration.source} ({args.profile_cache})")

    cfg = resolve_cfg(args)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    events = _parse_events(args, world)
    if args.cp > 1:             # JAX's checks, in its order
        if not cp_seq_divisible(args.seq, args.cp):
            raise SystemExit(f"--cp {args.cp} needs --seq % (2*cp) == 0 "
                             f"(zig-zag split); got seq {args.seq}")
        if cfg.family != "dense":
            raise SystemExit(f"--cp supports dense-family archs; "
                             f"{cfg.name} is {cfg.family}")
    if world > 1:
        return _main_ranks(args, cfg, calibration, world, events)
    if args.cp > 1:
        print(f"warning: --cp {args.cp} ignored on a single device")
    if any(n for _, n in events):
        raise SystemExit("--resize-to needs a multi-device pool "
                         "(run the launcher under torchrun --nproc-per-node N)")
    model = build_model(cfg, device=args.device)
    with _open_sink(args, cfg, 1) as sink:
        return _run_single(args, cfg, calibration, model, sink, events)


def _run_single(args, cfg: ModelConfig, calibration, model, sink, events=()) -> int:
    """``main``'s single-device path (see the module note)."""
    # the JAX launcher's plan on one device: one strategy for every layer
    plan = uniform_plan(cfg.name, "train", (1,), ("data",), cfg.num_layers,
                        LayerStrategy(remat=args.remat or "none"),
                        grad_accum=max(args.grad_accum, 1))
    step_s, mem, _ = evaluate_uniform(cfg, H100_1, args.seq, args.batch, 1,
                                      plan.default_strategy,
                                      grad_accum=plan.grad_accum,
                                      calibration=calibration)
    plan = dataclasses.replace(plan, predicted_step_time=step_s, predicted_memory=mem)
    # JAX's plan line and event, reason "search" on one device too (where
    # neither launcher searches)
    b = _predicted_breakdown(plan, cfg, args.seq, args.batch, calibration)
    _emit_plan(sink, "search", plan, breakdown=b)
    print(f"predicted ({H100_1.name}, {calibration.source} calibration): compute "
          f"{b['compute_s']:.6g} s, comm {b['comm_s']:.6g} s per step; plan step "
          f"{b['predicted_step_time_s']:.6g} s, memory "
          f"{b['predicted_memory_bytes'] / 1e9:.6g} GB")

    if args.validate_only:
        report = plan_check.check_plan(
            plan, H100_1, cfg, seq_len=args.seq, global_batch=args.batch,
            profile=profile_model(cfg, args.seq), calibration=calibration)
        print(report.format_table())
        return 0 if report.ok() else 1

    resume = _resume_step(args, plan)
    hp = construct_hybrid_parallel_model(model, plan)
    dev = model.device
    params = hp.init_params(torch.Generator(device=dev).manual_seed(0))
    opt = hp.init_opt_state(params)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"model: {cfg.name} {n_params / 1e6:.1f}M params on {dev}")
    start = 0
    if resume is not None:
        params, opt = _restore(args, hp, resume, params, opt)
        start = resume

    run = _Run(hp, params, opt)
    ckpts = _Checkpoints(args, run, sink) if args.ckpt_dir else None
    advisory = lambda step, devices: _advisory_replan(args, cfg, sink)
    times = _train_loop(args, run, start, ckpts, print, sink,
                        _step_timer(args, cfg, H100_1, 1), H100_1, events, advisory)
    if dev.type == "cuda":
        print(f"peak memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    if args.digest:
        _digest(run)
    if not times:
        print(f"no step to run: resumed at step {start} of --steps {args.steps}")
        print("done")
        return 0

    median = statistics.median(times)
    report = plan_check.check_plan(plan, H100_1, cfg, seq_len=args.seq,
                                   measured_step_time=median)
    drift = [d for d in report.diagnostics if d.code == "GALV070"]
    print(f"GALV070: median step {median * 1e3:.1f} ms vs predicted "
          f"{plan.predicted_step_time * 1e3:.1f} ms (ratio "
          f"{median / plan.predicted_step_time:.3f}, band "
          f"{obs.DRIFT_RATIO_THRESHOLD}x either way): "
          + (str(drift[0]) if drift else "within the band"))
    print("done")
    return 0


def _main_ranks(args, cfg: ModelConfig, calibration, world: int, events=()) -> int:
    """The multi-device branch under ``torchrun`` (see the module note)."""
    import torch.distributed as dist

    rank = int(os.environ.get("RANK", "0"))
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        rc = _run_ranks(args, cfg, calibration, world, rank, device, events)
    except SystemExit:
        dist.barrier()               # every rank raises these alike
        raise
    else:
        dist.barrier()
        return rc
    finally:
        dist.destroy_process_group()


def _apply_resize(cfg: ModelConfig, args, event: ElasticEvent, run: _Run,
                  carry: "resize_lib.CarryState", sink, cluster: ClusterSpec, calibration,
                  device: torch.device, say=print) -> "resize_lib.CarryState":
    """JAX's ``_apply_resize`` on every rank: rank 0 replans for the
    survivors and diffs the plan against the running one, the plan goes to
    every rank by broadcast, every rank builds its mesh over the plan's
    first ranks and its trainer (a plan the runtime refuses raises here, on
    every rank alike), then the state migrates and ``run`` takes the new
    runtime.  Returns the carried state, the loop's resume point."""
    import torch.distributed as dist

    box = [None]
    if dist.get_rank() == 0:
        box[0] = replan_and_diff(cfg, event, args.seq, args.batch, run.plan, cluster=cluster,
                                 arch=cfg.name, calibration=calibration)
    dist.broadcast_object_list(box, src=0)
    new_plan, spec = box[0]
    _emit_plan(sink, "resize", new_plan, spec=spec, say=say)
    mesh = mesh_lib.make_mesh(new_plan.mesh_shape, new_plan.mesh_axes, device=device,
                              ranks=new_plan.num_devices)
    new_hp = resize_lib.make_trainer(run.hp.model, new_plan, mesh)
    with obs.span("resize_migrate"):
        if args.elastic_mode == "checkpoint":
            params, opt, carry, report = resize_lib.migrate_via_checkpoint(
                run.hp, new_hp, run.params, run.opt, carry, step=carry.step,
                async_write=args.ckpt_async == "on")
        else:
            params, opt, carry, report = resize_lib.migrate(run.hp, new_hp, run.params,
                                                            run.opt, carry)
    say(f"   {report.summary()}")
    sink.emit("resize", step=carry.step, old_devices=event.old_devices,
              new_devices=event.new_devices, reason=event.reason, path=report.path,
              seconds=report.seconds, bytes_moved=report.bytes_moved,
              migration=spec.summary())
    run.rebind(new_hp, params, opt)
    return carry


def _run_ranks(args, cfg: ModelConfig, calibration, world: int, rank: int,
               device: torch.device, events=()) -> int:
    """``_main_ranks``' body, inside the initialised process group."""
    try:
        shape, axes = mesh_lib.train_mesh_spec(world, pp=args.pp, cp=args.cp)
    except ValueError as e:
        raise SystemExit(str(e))
    cluster = dataclasses.replace(H100_NODE8, chips=world, intra_size=min(world, 8))
    sched_opts = None
    if args.pp_schedule != "searched":
        v = args.pp_interleave if args.pp_schedule == "interleaved" else 1
        sched_opts = [(args.pp_schedule, v)]
    res = SearchEngine(cfg, cluster=cluster, calibration=calibration).search(
        args.seq, args.batch, mesh_shape=shape, mesh_axes=axes, pp_options=[args.pp],
        pp_schedule_options=sched_opts,
        cp_options=[args.cp] if args.cp > 1 else None, arch=cfg.name)
    searched_cp = max(s.cp for s in res.plan.layer_strategies
                      + [res.plan.default_strategy])
    if (args.pp > 1 or args.cp > 1) and (not res.feasible or res.plan.pp != args.pp
                                         or searched_cp != args.cp):
        # JAX's: the search falls back to a pp=1 plan when nothing fits;
        # train nothing other than what was asked
        raise SystemExit(
            f"no feasible pp={args.pp} cp={args.cp} plan for "
            f"--pp-schedule {args.pp_schedule} ({cfg.num_layers} layers, "
            f"{world} devices; interleaved needs num_layers % "
            f"(pp*interleave) == 0, cp needs seq % (2*cp) == 0)")
    say = print if rank == 0 else (lambda *a, **k: None)
    with _open_sink(args, cfg, world, rank) as sink:
        plan = res.plan
        b = _predicted_breakdown(plan, cfg, args.seq, args.batch, calibration, cluster)
        _emit_plan(sink, "search", plan, breakdown=b, rejections=res.rejections, say=say)
        say(f"predicted ({cluster.name} x{world}, {calibration.source} calibration): "
            f"compute {b['compute_s']:.6g} s, comm {b['comm_s']:.6g} s per step; plan step "
            f"{b['predicted_step_time_s']:.6g} s, memory "
            f"{b['predicted_memory_bytes'] / 1e9:.6g} GB per device")
        if args.validate_only:
            report = plan_check.check_plan(
                plan, cluster, cfg, seq_len=args.seq, global_batch=args.batch,
                profile=profile_model(cfg, args.seq), calibration=calibration)
            say(report.format_table())
            return 0 if report.ok() else 1

        resume = _resume_step(args, plan, say)
        mesh = mesh_lib.make_mesh(shape, axes, device=device)
        hp = resize_lib.make_trainer(build_model(cfg, device=device), plan, mesh)
        params = hp.init_params(torch.Generator(device=device).manual_seed(0))
        opt = hp.init_opt_state(params)
        say(f"model: {cfg.name} on {world} ranks of {mesh.backend} ({device.type}), "
            f"groups {[g.strategy.short() for g in plan.groups()]}")
        start = 0
        if resume is not None:
            params, opt = _restore(args, hp, resume, params, opt, say)
            start = resume

        run = _Run(hp, params, opt)
        ckpts = _Checkpoints(args, run, sink, rank) if args.ckpt_dir else None
        # a step's time is the slowest rank's: synchronize, then a barrier
        timer = _step_timer(args, cfg, cluster, world, fence_fn=lambda outputs: run.sync())
        host_rng = torch.Generator().manual_seed(0)     # the run's host generator
        devices = world

        def on_event(step: int, new_dev: int) -> bool:
            nonlocal host_rng, devices
            if not new_dev:
                _advisory_replan(args, cfg, sink, say)
                return False
            say(f"!! simulated membership change at step {step}: {devices} -> {new_dev} "
                f"devices ({args.elastic_mode})")
            event = ElasticEvent(old_devices=devices, new_devices=new_dev, reason="simulated")
            carry = resize_lib.CarryState(step=step, samples_seen=step * args.batch,
                                          rng=host_rng)
            carry = _apply_resize(cfg, args, event, run, carry, sink, cluster, calibration,
                                  device, say)
            host_rng, devices = carry.rng, new_dev      # resume exactly where it stopped
            return True

        times = _train_loop(args, run, start, ckpts, say, sink, timer, cluster, events,
                            on_event)
        if device.type == "cuda":
            say(f"peak memory (rank 0) "
                f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
        if times:
            say(f"median step {statistics.median(times) * 1e3:.1f} ms vs predicted "
                f"{run.plan.predicted_step_time * 1e3:.1f} ms")
        if args.digest:
            _digest(run, say)
        say("done")
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
