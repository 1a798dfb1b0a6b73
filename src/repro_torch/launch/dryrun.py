"""Multi-pod dry run: trace every (architecture x shape x mesh) cell of the
port on one rank of a fake world (the port of ``repro.launch.dryrun``).

JAX lowers and compiles each cell's step against abstract inputs on 512
fake XLA devices.  The port has no compiler to ask, so for each cell the
dry run:

1. makes this process one rank of a world of the mesh's size on torch's
   ``fake`` process-group backend (``FakeStore``: collectives return at
   once, nothing is sent) and builds the cell's ``ProcessMesh`` on it —
   JAX's meshes: ``pod16x16`` (data 16, model 16), ``pod2x16x16``, the
   ``--pp`` mesh (pod pp, data, model) and the ``--cp`` mesh (cp, data,
   model) over 512 ranks, or ``--mesh-shape``;
2. obtains the plan — ``SearchEngine`` (mesh-constrained, as JAX's) for
   train cells, the serving heuristic for prefill/decode cells — priced on
   ``H100_NODE8`` with the mesh's chips (the port has no TPU preset; the
   cluster's name goes into the JSON);
3. traces one step of that rank (``analysis/step_trace.py``) on its own
   local shapes, built from the abstract trees (``hp.abstract_params()``,
   ``hp.abstract_opt_state()``, ``runtime.data.input_specs``) as tensors
   without data: for a train cell ``hp.train_step(..., donate=True)``, for
   a serve cell the engine's eager ``prefill_step`` / ``decode_step`` (its
   compiled steps' CUDA graphs are bitwise those).  Nothing is allocated,
   nothing launches: the kernels take their fake paths (``kernels/_fake.py``);
4. records JAX's keys: ``plan``, ``search_seconds``, ``search_feasible``,
   ``memory_analysis`` (this rank's arguments, the traced peak above them as
   ``temp``, outputs, donated aliases), ``cost_analysis.flops_per_device``
   (aten flops plus the kernels' own), ``collectives`` (merged, and per
   axis), and with ``--audit`` the step audit of a train cell
   (``analysis/step_audit.py``: GALV090-093; audit errors fail the cell).
   ``unrolled`` is skipped: an eager trace counts every op, so there is no
   scanned program to unroll.

A ``--pp`` cell traces the first rank of each stage in turn, each in a
world of its own (the fake group is torn down and made again at that rank),
since the stages run different code; it reports every stage and their
maximum.  A cell's error is recorded with its traceback and the dry run goes
on, exiting 1 when any cell failed, as JAX's does.  A step that reads the
host (the MoE exchange's split sizes under ep > 1) stops its trace at the
read: the cell records the site, and its audit reports GALV093 there.

``--device cuda`` (the default) traces fake CUDA tensors under a
``FakeTensorMode``, which needs a torch built with CUDA (no card is
touched); on a CPU-only torch a fake CUDA tensor cannot be indexed, so
there ``--device meta`` traces the same kernel route on plain ``meta``
tensors (no mode; about twice as fast); ``--device cpu`` traces the plain
versions on fake CPU tensors.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --skip-unrolled --device meta

Results land in ``results/dryrun/<arch>__<shape>__<mesh>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, supports_shape
from repro_torch.core.cluster import H100_NODE8
from repro_torch.core.search import SearchEngine, serving_plan
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.parallel import sharding as shd
from repro_torch.runtime.data import input_specs

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun"

FAKE_DEVICES = 512                      # JAX's dry-run host
#: torch's ``fake`` backend for every device a trace's tensors may lie on
#: (``batch_isend_irecv`` looks the backend up by the tensors' device)
FAKE_BACKEND = "cpu:fake,cuda:fake,meta:fake"
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def _mesh_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def _axis_mesh(degree: int, axis: str, flag: str) -> tuple[tuple, str]:
    """(degree, data, model=16) mesh shape + result tag for a cell with a
    leading staged/ring axis ("pod" for --pp cells, "cp" for --cp cells)."""
    if FAKE_DEVICES % (degree * 16) != 0 or degree > 32:
        raise ValueError(
            f"{flag} {degree} does not tile the {FAKE_DEVICES}-device "
            f"dry-run host (need {flag.lstrip('-')}*16 | {FAKE_DEVICES}, "
            f"{flag.lstrip('-')} <= 32)")
    shape = (degree, FAKE_DEVICES // (degree * 16), 16)
    return shape, axis + "x".join(map(str, shape))


def _pp_mesh(pp: int) -> tuple[tuple, str]:
    return _axis_mesh(pp, "pod", "--pp")


def _cp_mesh(cp: int) -> tuple[tuple, str]:
    return _axis_mesh(cp, "cp", "--cp")


def cluster_for(devices: int):
    """The cluster a cell's plan is priced on: ``H100_NODE8`` with the
    mesh's chips."""
    return dataclasses.replace(H100_NODE8, chips=devices)


def _plan_for(cfg, spec, mesh_shape, mesh_axes, arch, shape_id,
              pp: int = 1, pp_schedule: str | None = None,
              pp_interleave: int = 2, cp: int = 1):
    cluster = cluster_for(int(np.prod(mesh_shape)))
    if spec.kind == "train":
        sched_opts = None
        if pp > 1 and pp_schedule:
            v = pp_interleave if pp_schedule == "interleaved" else 1
            sched_opts = [(pp_schedule, v)]
        res = SearchEngine(cfg, cluster=cluster).search(
            spec.seq_len, spec.global_batch, mesh_shape=mesh_shape, mesh_axes=mesh_axes,
            pp_options=[pp], pp_schedule_options=sched_opts,
            cp_options=[cp] if cp > 1 else None, arch=arch, shape_name=shape_id)
        return res.plan, {"search_seconds": res.search_seconds,
                          "search_feasible": res.feasible}
    plan = serving_plan(cfg, seq_len=spec.seq_len, batch=spec.global_batch,
                        mesh_shape=mesh_shape, mesh_axes=mesh_axes, cluster=cluster,
                        arch=arch, shape_name=shape_id)
    return plan, {"search_seconds": 0.0, "search_feasible": True}


def _summarize_plan(plan) -> dict:
    ss: dict = {}
    for s in plan.layer_strategies:
        ss[s.short()] = ss.get(s.short(), 0) + 1
    return {"pp": plan.pp, "pp_schedule": plan.pp_schedule,
            "pp_interleave": plan.pp_interleave, "grad_accum": plan.grad_accum,
            "cp": plan.default_strategy.cp,
            "strategies": ss, "default": plan.default_strategy.short(),
            "predicted_step_time": plan.predicted_step_time,
            "predicted_memory": plan.predicted_memory,
            "notes": plan.notes}


def _force(plan, force_strategy: str | None, force_ga: int | None):
    """JAX's ``--force-strategy`` / ``--force-ga`` pins."""
    if force_strategy is not None:
        from repro_torch.core.strategy import LayerStrategy

        kw: dict = {}
        for tkn in force_strategy.split("-"):
            if tkn.startswith("tp"):
                kw["tp"] = int(tkn[2:])
            elif tkn == "sp":
                kw["sp"] = True
            elif tkn.startswith("cp"):
                kw["cp"] = int(tkn[2:])
            elif tkn.startswith("z"):
                kw["zero"] = int(tkn[1:])
            elif tkn.startswith("ep"):
                kw["ep"] = int(tkn[2:])
            elif tkn in ("none", "selective", "full"):
                kw["remat"] = tkn
        strat = LayerStrategy(**kw)
        plan = dataclasses.replace(
            plan, layer_strategies=[strat] * len(plan.layer_strategies),
            default_strategy=strat, notes=plan.notes + f" | forced {force_strategy}")
    if force_ga is not None:
        plan = dataclasses.replace(plan, grad_accum=force_ga,
                                   notes=plan.notes + f" | forced ga{force_ga}")
    return plan


def fake_world(world: int, rank: int) -> None:
    """Make this process ``rank`` of a ``world``-rank group on the ``fake``
    backend, tearing down a default group of another size or rank."""
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_rank() == rank \
                and dist.get_backend() == FAKE_BACKEND:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group(FAKE_BACKEND, store=FakeStore(), rank=rank, world_size=world)


def check_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and torch.version.cuda is None:
        raise ValueError("--device cuda traces fake CUDA tensors, which a CPU-only torch "
                         "cannot index ('PyTorch is not linked with support for cuda "
                         "devices'); trace with --device meta (the same kernel route)")
    if dev.type not in ("cuda", "meta", "cpu"):
        raise ValueError(f"--device {device}: cuda, meta or cpu")
    return dev


def _trace_train(hp, cfg, spec, model, dev, mesh):
    from repro_torch.analysis.step_trace import materialize, trace_step, tracing

    with tracing(dev):
        params = materialize(hp.abstract_params(), dev)
        opt = materialize(hp.abstract_opt_state(), dev)
        batch = materialize(input_specs(cfg, spec, model), dev)
        return trace_step(lambda: hp.train_step(params, opt, batch, donate=True),
                          (params, opt, batch), mesh)


def _trace_serve(engine, cfg, spec, model, dev, mesh):
    from repro_torch.analysis.step_trace import materialize, trace_step, tracing

    specs = input_specs(cfg, spec, model)
    with tracing(dev):
        params = materialize(engine.abstract_params(), dev)
        tokens = materialize(specs["tokens"], dev)
        if spec.kind == "prefill":
            extras = {k: materialize(v, dev) for k, v in specs.items() if k != "tokens"}
            return trace_step(lambda: engine.prefill_step(params, tokens, extras),
                              (params, tokens, extras), mesh)
        cache = specs["cache"]
        if mesh is not None:
            cache = shd.place_params(cache, engine.cache_specs, mesh)
        cache = materialize(cache, dev)
        index, kv_len = materialize(specs["cache_index"], dev), materialize(specs["kv_len"], dev)
        return trace_step(lambda: engine.decode_step(params, tokens, cache, index, kv_len),
                          (params, tokens, cache, index, kv_len), mesh)


def _trace_record(tr) -> dict:
    return {"memory_analysis": tr.memory_analysis(),
            "cost_analysis": {"flops_per_device": tr.flops, "aten_flops": float(tr.aten_flops),
                              "kernel_flops": tr.kernel_flops},
            "collectives": tr.census.stats().merged(),
            "collectives_by_axis": [
                {"axis": ax, "kind": k, "bytes": b, "count": c}
                for ax, k, b, c in tr.census.axis_census().rows()],
            "kernels": tr.kernel_counts(),
            "trace_seconds": tr.seconds,
            "stopped_at": tr.stopped}


def run_cell(arch: str, shape_id: str, *, multi_pod: bool = False,
             skip_unrolled: bool = False, verbose: bool = True,
             custom_mesh: tuple | None = None,
             force_strategy: str | None = None,
             force_ga: int | None = None,
             pp: int = 1, pp_schedule: str | None = None,
             pp_interleave: int = 2, cp: int = 1,
             seq_len: int | None = None,
             validate_only: bool = False,
             audit: bool = False,
             device: str = "cuda",
             out: dict | None = None) -> dict:
    """One cell (JAX's arguments, plus ``device``).  ``out`` (when given)
    is filled in place as stages complete, so a failure mid-cell leaves the
    stages that did succeed beside the error."""
    cfg = get_config(arch)
    spec = SHAPES[shape_id]
    if seq_len is not None:                          # long-context override
        spec = dataclasses.replace(spec, seq_len=seq_len)
    if pp > 1 and cp > 1:
        raise ValueError("--pp and --cp dry-run cells are separate scenarios")
    if cp > 1:                                       # ring: cp axis = seq shards
        from repro_torch.analysis.invariants import cp_seq_divisible

        if not cp_seq_divisible(spec.seq_len, cp):
            raise ValueError(f"--cp {cp} needs seq_len % (2*cp) == 0; got {spec.seq_len}")
        shape, mesh_tag = _cp_mesh(cp)
        axes = ("cp", "data", "model")
    elif pp > 1:                                     # staged: pod axis = stages
        shape, mesh_tag = _pp_mesh(pp)
        axes = ("pod", "data", "model")
    elif custom_mesh is not None:
        shape, axes = tuple(custom_mesh), ("data", "model")
        mesh_tag = "x".join(map(str, custom_mesh))
    else:
        shape, axes = PRODUCTION_MESHES[multi_pod]
        mesh_tag = _mesh_tag(multi_pod)
    devices = int(np.prod(shape))
    out = out if out is not None else {}
    out.update({"arch": arch, "shape": shape_id, "mesh": mesh_tag,
                "mesh_shape": tuple(shape), "devices": devices,
                "kind": spec.kind, "seq_len": spec.seq_len,
                "global_batch": spec.global_batch,
                "cluster": cluster_for(devices).name, "device": device})

    ok, why = supports_shape(cfg, spec)
    if not ok:
        out["skipped"] = why
        if verbose:
            print(f"[skip] {arch} × {shape_id}: {why}")
        return out

    if (pp > 1 or cp > 1) and spec.kind != "train":
        raise ValueError(f"--pp/--cp apply to train shapes, not {spec.kind}")
    plan, search_meta = _plan_for(cfg, spec, shape, axes, arch, shape_id, pp=pp,
                                  pp_schedule=pp_schedule, pp_interleave=pp_interleave,
                                  cp=cp)
    if pp > 1 and (not search_meta["search_feasible"] or plan.pp != pp):
        raise ValueError(
            f"no feasible pp={pp} plan for {arch}×{shape_id} "
            f"(schedule={pp_schedule or 'searched'}; fallback pp={plan.pp})")
    if cp > 1 and (not search_meta["search_feasible"] or plan.default_strategy.cp != cp):
        raise ValueError(f"no feasible cp={cp} plan for {arch}×{shape_id} "
                         f"(needs dense family + seq % (2*cp) == 0)")
    plan = _force(plan, force_strategy, force_ga)
    out.update(search_meta)
    out["plan"] = _summarize_plan(plan)

    if validate_only:
        from repro_torch.analysis import plan_check as pc
        from repro_torch.core.profiler_model import profile_model

        is_train = spec.kind == "train"
        report = pc.check_plan(
            plan, cluster_for(devices), cfg, seq_len=spec.seq_len,
            global_batch=spec.global_batch if is_train else None,
            profile=profile_model(cfg, spec.seq_len) if is_train else None)
        print(report.format_table())
        out["validate_only"] = {"ok": report.ok(), "codes": report.codes()}
        if not report.ok():
            raise ValueError("plan verification failed: " + ", ".join(report.error_codes()))
        return out

    dev = check_device(device)
    ranks = [0] if plan.pp == 1 else [s * (devices // plan.pp) for s in range(plan.pp)]
    records, traces = [], []
    for rank in ranks:
        fake_world(devices, rank)
        mesh = make_mesh(shape, axes, device=dev, backend=FAKE_BACKEND)
        model = build_model(cfg, device=dev)
        t0 = time.perf_counter()
        if spec.kind == "train":
            from repro_torch.runtime import optimizer as opt_lib
            from repro_torch.runtime.resize import make_trainer

            opt_cfg = (opt_lib.AdamWConfig(m_dtype=torch.bfloat16, v_dtype=torch.bfloat16)
                       if "bf16-adam" in plan.notes else None)
            hp = make_trainer(model, plan, mesh, opt_cfg=opt_cfg)
            tr = _trace_train(hp, cfg, spec, model, dev, mesh)
        else:
            from repro_torch.runtime.serve import ServingEngine

            engine = ServingEngine.for_plan(model, plan, mesh, batch=spec.global_batch,
                                            max_len=spec.seq_len)
            tr = _trace_serve(engine, cfg, spec, model, dev, mesh)
        rec = {"rank": rank, "build_seconds": time.perf_counter() - t0 - tr.seconds,
               **_trace_record(tr)}
        if plan.pp > 1:
            rec["stage"] = len(records)
        records.append(rec)
        traces.append(tr)
        if verbose:
            ma = rec["memory_analysis"]
            print(f"  rank {rank}: argument {ma['argument_size_in_bytes'] / 1e9:.3f} GB, temp "
                  f"{ma['temp_size_in_bytes'] / 1e9:.3f} GB, "
                  f"{rec['cost_analysis']['flops_per_device'] / 1e12:.2f} TFLOP, collectives "
                  f"{rec['collectives']['collective_bytes'] / 1e9:.3f} GB, traced in "
                  f"{tr.seconds:.1f} s")
    if plan.pp > 1:
        out["stages"] = records
        top = max(records, key=lambda r: r["memory_analysis"]["argument_size_in_bytes"]
                  + r["memory_analysis"]["temp_size_in_bytes"])
        out.update({k: v for k, v in top.items() if k not in ("rank", "stage")})
        out["memory_analysis"] = {k: max(r["memory_analysis"][k] for r in records)
                                  for k in top["memory_analysis"]}
        out["cost_analysis"] = {k: max(r["cost_analysis"][k] for r in records)
                                for k in top["cost_analysis"]}
        out["max_over_stages"] = ["memory_analysis", "cost_analysis"]
    else:
        out.update(records[0])

    reports = []
    if audit and spec.kind == "train":
        from repro_torch.analysis.step_audit import audit_step

        reports = [audit_step(plan, cfg, seq_len=spec.seq_len,
                              global_batch=spec.global_batch, trace=tr) for tr in traces]
        for report in reports:
            print(report.format_table())
        out["audit"] = reports[0].to_event()
        if len(reports) > 1:
            out["audit"]["stages"] = [r.to_event() for r in reports]
            out["audit"]["ok"] = all(r.ok() for r in reports)
    elif audit:
        out["audit"] = {"skipped": "census prediction covers train steps; "
                                   "prefill/decode cells are not audited"}
    stopped = [r["stopped_at"] for r in records if r["stopped_at"]]
    if stopped:
        raise ValueError(f"the step reads the host at {stopped[0]} (GALV093); its trace "
                         "stopped there")
    bad = sorted({c for r in reports for c in r.error_codes()}) if audit and reports else []
    if bad:
        raise ValueError("step audit failed: " + ", ".join(bad))
    if not skip_unrolled:
        out["unrolled"] = {"skipped": "the eager trace counts every op; no unrolled variant"}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-unrolled", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--mesh-shape", default=None,
                    help="custom single-pod mesh 'dp,tp' (hillclimb variants)")
    ap.add_argument("--force-strategy", default=None,
                    help="uniform LayerStrategy short string, e.g. tp16-sp-z2")
    ap.add_argument("--force-ga", type=int, default=None)
    ap.add_argument("--pp", type=int, default=1,
                    help=">1 stages the block stack over a pod axis (PP cell)")
    ap.add_argument("--pp-schedule", default=None,
                    choices=["gpipe", "1f1b", "interleaved"],
                    help="pin the pipeline schedule (default: searched)")
    ap.add_argument("--pp-interleave", type=int, default=2)
    ap.add_argument("--cp", type=int, default=1,
                    help=">1 rings attention over a cp axis (context-parallel "
                         "cell; needs seq %% (2*cp) == 0)")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="override the shape's sequence length (long-context "
                         "cells, e.g. --arch llama3.2-1b-long --seq-len 32768)")
    ap.add_argument("--validate-only", action="store_true",
                    help="statically verify the plan (repro_torch.analysis."
                         "plan_check) and print the GALV diagnostic table — "
                         "nothing is traced; exit 1 on any error")
    ap.add_argument("--audit", action="store_true",
                    help="audit every traced train cell against its plan "
                         "(repro_torch.analysis.step_audit — GALV090-093: per-axis "
                         "collective census vs the cost model, dtype drift, "
                         "remat presence, host reads); a cell with audit "
                         "errors counts as a failure")
    ap.add_argument("--tag", default="", help="output filename suffix")
    ap.add_argument("--device", default="cuda", choices=["cuda", "meta", "cpu"],
                    help="the traced tensors' device: cuda (fake CUDA tensors, the "
                         "kernels' route; needs a torch built with CUDA), meta (the "
                         "same route on a CPU-only torch), cpu (the plain versions)")
    args = ap.parse_args(argv)

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    elif not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    else:
        cells = [(args.arch, args.shape)]
    if args.pp > 1 or args.cp > 1:
        meshes = [False]           # staged/ring cells build their own mesh
    elif args.both_meshes or (args.all and not args.multipod):
        meshes = [False, True]
    else:
        meshes = [args.multipod]

    custom = tuple(int(x) for x in args.mesh_shape.split(",")) if args.mesh_shape else None
    failures = 0
    try:
        for arch, shape_id in cells:
            for mp in meshes:
                if args.cp > 1:
                    mtag = _cp_mesh(args.cp)[1]
                elif args.pp > 1:
                    mtag = _pp_mesh(args.pp)[1]
                elif custom:
                    mtag = "x".join(map(str, custom))
                else:
                    mtag = _mesh_tag(mp)
                if args.seq_len:
                    mtag += f"__seq{args.seq_len}"
                tag = f"{arch}__{shape_id}__{mtag}" + (f"__{args.tag}" if args.tag else "")
                path = outdir / f"{tag}.json"
                print(f"=== {tag} ===", flush=True)
                res: dict = {"arch": arch, "shape": shape_id, "mesh": mtag}
                t0 = time.perf_counter()
                try:
                    run_cell(arch, shape_id, multi_pod=mp, skip_unrolled=args.skip_unrolled,
                             custom_mesh=custom, force_strategy=args.force_strategy,
                             force_ga=args.force_ga, pp=args.pp,
                             pp_schedule=args.pp_schedule, pp_interleave=args.pp_interleave,
                             cp=args.cp, seq_len=args.seq_len,
                             validate_only=args.validate_only, audit=args.audit,
                             device=args.device, out=res)
                except Exception as e:  # noqa: BLE001 — JAX's: record the cell, go on
                    failures += 1
                    res["error"] = f"{type(e).__name__}: {e}"
                    res["traceback"] = traceback.format_exc()
                    print(f"[FAIL] {tag}: {e}")
                res["cell_seconds"] = time.perf_counter() - t0
                path.write_text(json.dumps(res, indent=2, default=str))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"done; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
