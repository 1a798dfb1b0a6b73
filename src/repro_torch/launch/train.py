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

Every rank reaches one barrier before the process group is torn down, on
each path that returns and on the ``SystemExit``s every rank raises alike,
so a rank that finishes first cannot close its connections while a slower
one still builds its own.  Elastic resize, the compiled-step audit and run
sinks wait for later slices.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import sys
import time
from typing import Optional

import torch

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
from repro_torch.obs.drift import DRIFT_RATIO_THRESHOLD
from repro_torch.runtime import checkpoint as ckpt_lib
from repro_torch.runtime.data import SyntheticDataset
from repro_torch.runtime.train import construct_hybrid_parallel_model
from repro_torch.runtime.train_pp import PipelineTrainer

PRESET_100M = ModelConfig(
    name="llama-100m", family="dense", num_layers=12, d_model=640,
    num_heads=10, num_kv_heads=10, d_ff=2560, vocab_size=32_000,
    head_dim=64, mlp_type="swiglu", rope_theta=10_000.0)


def resolve_cfg(args) -> ModelConfig:
    if args.preset == "100m":
        return PRESET_100M
    cfg = get_config(args.arch)
    return cfg.reduced() if args.reduced else cfg


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
    state at a step (every rank gathers it), written by rank 0, async or
    sync; on a mesh the other ranks wait at a barrier."""

    def __init__(self, args, hp, plan: ExecutionPlan, rank: int = 0, barrier=None):
        self.args, self.hp, self.plan, self.rank = args, hp, plan, rank
        self.barrier = barrier or (lambda: None)
        self.writer = (ckpt_lib.CheckpointWriter()
                       if args.ckpt_async == "on" and rank == 0 else None)
        self.last = -1

    def save(self, step: int, params, opt) -> None:
        if step == self.last:                 # final save == last periodic save
            return
        self.last = step
        canon_p, canon_o = self.hp.checkpoint_state(params, opt)
        if self.rank == 0:
            if self.writer is not None:
                self.writer.save_async(self.args.ckpt_dir, step, canon_p, canon_o, self.plan)
                print(f"checkpoint queued (async) step {step}")
            else:
                path = ckpt_lib.save(self.args.ckpt_dir, step, canon_p, canon_o, self.plan)
                print(f"checkpoint -> {path}")
        self.barrier()

    def close(self) -> None:
        """Drain the writer (raising its error); every rank then waits for
        rank 0's last file."""
        if self.writer is not None:
            path = self.writer.close()
            print(f"checkpoint -> {path} (async writer: {self.writer.saves_completed} "
                  f"saves, {self.writer.blocked_seconds * 1e3:.1f} ms total step-loop stall)")
        self.barrier()


def _train_loop(args, hp, params, opt, start: int, ckpts, step_fn, say, sync) -> list:
    """Steps ``start`` .. ``--steps - 1`` on ``SyntheticDataset.batch(step)``,
    a checkpoint every ``--ckpt-every`` steps and one at the end; returns
    the step times."""
    cfg = hp.model.cfg
    ds = SyntheticDataset(cfg, seq_len=args.seq, global_batch=args.batch)
    tokens = args.batch * args.seq
    times = []
    for step in range(start, args.steps):
        batch = ds.batch(step)
        sync()
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        sync()
        times.append(time.perf_counter() - t0)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step} loss {float(metrics['loss']):.6f} grad_norm "
                f"{float(metrics['grad_norm']):.6f} step_time "
                f"{times[-1] * 1e3:.1f} ms tok/s {tokens / times[-1]:,.1f}")
        if ckpts is not None and (step + 1) % args.ckpt_every == 0:
            ckpts.save(step + 1, params, opt)
    if ckpts is not None:
        ckpts.save(args.steps, params, opt)
        ckpts.close()
    return times


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
    if args.cp > 1:             # JAX's checks, in its order
        if not cp_seq_divisible(args.seq, args.cp):
            raise SystemExit(f"--cp {args.cp} needs --seq % (2*cp) == 0 "
                             f"(zig-zag split); got seq {args.seq}")
        if cfg.family != "dense":
            raise SystemExit(f"--cp supports dense-family archs; "
                             f"{cfg.name} is {cfg.family}")
    if world > 1:
        return _main_ranks(args, cfg, calibration, world)
    if args.cp > 1:
        print(f"warning: --cp {args.cp} ignored on a single device")
    model = build_model(cfg, device=args.device)
    # the JAX launcher's plan on one device: one strategy for every layer
    plan = uniform_plan(cfg.name, "train", (1,), ("data",), cfg.num_layers,
                        LayerStrategy(remat=args.remat or "none"),
                        grad_accum=max(args.grad_accum, 1))
    step_s, mem, _ = evaluate_uniform(cfg, H100_1, args.seq, args.batch, 1,
                                      plan.default_strategy,
                                      grad_accum=plan.grad_accum,
                                      calibration=calibration)
    plan = dataclasses.replace(plan, predicted_step_time=step_s, predicted_memory=mem)
    # the JAX launcher's plan line; nothing is searched on one device
    print(f"plan[uniform]: {plan.default_strategy.short()} ga={plan.grad_accum} "
          f"mesh={plan.mesh_shape} groups={len(plan.groups())}")
    b = _predicted_breakdown(plan, cfg, args.seq, args.batch, calibration)
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

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    ckpts = _Checkpoints(args, hp, plan) if args.ckpt_dir else None
    times = _train_loop(args, hp, params, opt, start, ckpts, hp.jit_train_step(donate=False),
                        print, sync)
    if dev.type == "cuda":
        print(f"peak memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
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
          f"{DRIFT_RATIO_THRESHOLD}x either way): "
          + (str(drift[0]) if drift else "within the band"))
    print("done")
    return 0


def _main_ranks(args, cfg: ModelConfig, calibration, world: int) -> int:
    """The multi-device branch under ``torchrun`` (see the module note)."""
    import torch.distributed as dist

    rank = int(os.environ.get("RANK", "0"))
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        rc = _run_ranks(args, cfg, calibration, world, rank, device)
    except SystemExit:
        dist.barrier()               # every rank raises these alike
        raise
    else:
        dist.barrier()
        return rc
    finally:
        dist.destroy_process_group()


def _run_ranks(args, cfg: ModelConfig, calibration, world: int, rank: int,
               device: torch.device) -> int:
    """``_main_ranks``' body, inside the initialised process group."""
    import torch.distributed as dist

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
    plan = res.plan
    say = print if rank == 0 else (lambda *a, **k: None)
    note = plan.notes.split("|")[-1].strip() if plan.notes else ""
    sched = (f" pp={plan.pp}/{plan.pp_schedule}"
             + (f"x{plan.pp_interleave}" if plan.pp_interleave > 1 else "")
             if plan.pp > 1 else "")
    say(f"plan[search]: {plan.default_strategy.short()} ga={plan.grad_accum}{sched} "
        f"mesh={plan.mesh_shape} groups={len(plan.groups())}" + (f" ({note})" if note
                                                                 else ""))
    b = _predicted_breakdown(plan, cfg, args.seq, args.batch, calibration, cluster)
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
    model = build_model(cfg, device=device)
    if plan.pp > 1:
        hp = PipelineTrainer(model, plan, mesh)
    else:
        hp = construct_hybrid_parallel_model(model, plan, mesh)
    params = hp.init_params(torch.Generator(device=device).manual_seed(0))
    opt = hp.init_opt_state(params)
    say(f"model: {cfg.name} on {world} ranks of {mesh.backend} ({device.type}), "
        f"groups {[g.strategy.short() for g in plan.groups()]}")
    start = 0
    if resume is not None:
        params, opt = _restore(args, hp, resume, params, opt, say)
        start = resume

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier()

    ckpts = _Checkpoints(args, hp, plan, rank, dist.barrier) if args.ckpt_dir else None
    times = _train_loop(args, hp, params, opt, start, ckpts, hp.train_step, say, sync)
    if device.type == "cuda":
        say(f"peak memory (rank 0) "
            f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
    if times:
        say(f"median step {statistics.median(times) * 1e3:.1f} ms vs predicted "
            f"{plan.predicted_step_time * 1e3:.1f} ms")
    say("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
