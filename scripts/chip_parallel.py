#!/usr/bin/env python3
"""Phase 25 of ``chip_smoke.py`` alone, on one CUDA GPU: the parallel
runtime at full llama3.2-1b width and depth on two ranks sharing the card
over gloo, each plan held to one rank's step (see
``chip_smoke.parallel_phase``).

    python3 scripts/chip_parallel.py            # the phase, about three minutes
    python3 scripts/chip_parallel.py --probe    # the backends, about half a minute

``--probe`` asks each process-group backend for two ranks on device 0:
NCCL (with ``NCCL_DEBUG=WARN``, whose reason for refusing lands in the
ranks' output), then gloo on CUDA tensors with ``all_reduce``,
``all_gather_into_tensor``, ``reduce_scatter_tensor`` and ``broadcast`` in
fp32, and the gather, all-reduce and reduce-scatter in bf16; it prints
each rank's answer
per op, then gloo's all-reduce fit (``measure_allreduce``, 1 to 64 MiB) on
CUDA tensors, and the same fit of all-reduces on CPU tensors: the host's
rate, no interconnect.  Exits non-zero
without a GPU.
"""
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROBE_OPS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor", "broadcast")


def probe_rank(rank: int, world: int, store: str, backend: str) -> None:
    """One rank of the probe: each op on CUDA tensors on device 0, its
    answer printed (a refusal is the answer this probe asks for)."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    dev = torch.device("cuda", 0)
    x = torch.full((8,), float(rank + 1), device=dev)
    ops = {"all_reduce": lambda: dist.all_reduce(x.clone()),
           "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
               torch.empty(8 * world, device=dev), x),
           "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
               torch.empty(8 // world, device=dev), x),
           "broadcast": lambda: dist.broadcast(x.clone(), 0)}
    y = x.to(torch.bfloat16)
    ops["all_gather_into_tensor bf16"] = lambda: dist.all_gather_into_tensor(
        torch.empty(8 * world, device=dev, dtype=torch.bfloat16), y)
    ops["all_reduce bf16"] = lambda: dist.all_reduce(y.clone())
    ops["reduce_scatter_tensor bf16"] = lambda: dist.reduce_scatter_tensor(
        torch.empty(8 // world, device=dev, dtype=torch.bfloat16), y)
    for name in ops:
        try:
            ops[name]()
            torch.cuda.synchronize()
            answer = "ok"
        except Exception as e:
            answer = f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
        print(f"probe {backend} rank {rank} {name}: {answer}", flush=True)
    if backend == "gloo":
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.core.profiler_hw import measure_allreduce

        sizes = [1 << k for k in range(20, 27, 2)]
        fit = measure_allreduce(sizes, iters=4)
        print(f"probe gloo rank {rank} measure_allreduce fp32 on cuda tensors, 1-64 MiB: "
              f"alpha {fit.alpha:.6g} s, beta {fit.beta:.6g} s/B "
              f"({1 / fit.beta / 1e9:.4g} GB/s), r2 {fit.r2:.4f}", flush=True)
        # the same sizes on CPU tensors: the median of 4 all-reduces each,
        # fitted as measure_allreduce fits them
        xs, ys = [], []
        for sz in sizes:
            a = torch.ones(sz // 4)
            dist.all_reduce(a)
            ts = []
            for _ in range(4):
                t0 = time.perf_counter()
                dist.all_reduce(a)
                ts.append(time.perf_counter() - t0)
            xs.append(float(sz))
            ys.append(sorted(ts)[len(ts) // 2])
        beta, alpha = np.polyfit(xs, ys, 1)
        print(f"probe gloo rank {rank} all_reduce fp32 on cpu tensors, 1-64 MiB: alpha "
              f"{alpha:.6g} s, beta {beta:.6g} s/B ({1 / beta / 1e9:.4g} GB/s)", flush=True)
    dist.destroy_process_group()


def probe() -> int:
    for backend in ("nccl", "gloo"):
        with tempfile.TemporaryDirectory() as tmp:
            env = dict(os.environ, NCCL_DEBUG="WARN")
            procs = [subprocess.Popen(
                [sys.executable, __file__, "--probe-rank", str(r), "2",
                 os.path.join(tmp, "store"), backend], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True) for r in range(2)]
            for p in procs:
                try:
                    out = p.communicate(timeout=180)[0]
                except subprocess.TimeoutExpired:
                    p.kill()
                    out = p.communicate()[0] + "\n(no answer in 180 s)"
                lines = [ln for ln in out.splitlines()
                         if ln.startswith("probe ") or "NCCL WARN" in ln or "Duplicate" in ln]
                print("\n".join(lines), flush=True)
    return 0


def main() -> int:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_parallel: needs one CUDA GPU", file=sys.stderr)
        return 1
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if sys.argv[1:2] == ["--probe"]:
        return probe()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    cs.log(f"build: {time.perf_counter() - t0:.1f} s")
    cs.parallel_phase(torch)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--probe-rank"]:
        probe_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
        sys.exit(0)
    sys.exit(main())
