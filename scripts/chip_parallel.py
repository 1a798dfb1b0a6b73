#!/usr/bin/env python3
"""Phase 25, 26, 27, 28, 29 or 30 of ``chip_smoke.py`` alone, on one CUDA
GPU: the parallel runtime on two ranks (four in phase 30) sharing the card
over gloo, each plan held to one rank's step (see
``chip_smoke.parallel_phase``, ``chip_smoke.moe_parallel_phase``,
``chip_smoke.ssm_parallel_phase``, ``chip_smoke.pipeline_phase``,
``chip_smoke.cp_phase`` and ``chip_smoke.ppcp_phase``).

    python3 scripts/chip_parallel.py            # phase 25 (llama), about three minutes
    python3 scripts/chip_parallel.py --moe      # phase 26 (moonshot on a mesh)
    python3 scripts/chip_parallel.py --ssm      # phase 27 (mamba2, zamba2, whisper at tp 2)
    python3 scripts/chip_parallel.py --pp       # phase 28 (llama and mamba2 in 2 stages)
    python3 scripts/chip_parallel.py --cp       # phase 29 (llama3.2-1b-long, cp 2 ring)
    python3 scripts/chip_parallel.py --ppcp     # phase 30 (pp 2 x cp 2 on four ranks)
    python3 scripts/chip_parallel.py --probe    # the backends, about half a minute

``--probe`` asks each process-group backend for two ranks on device 0:
NCCL (with ``NCCL_DEBUG=WARN``, whose reason for refusing lands in the
ranks' output), then gloo on CUDA tensors with ``all_reduce``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``broadcast`` and
``all_to_all_single`` (uneven splits) in fp32, the gather, all-reduce,
reduce-scatter and all-to-all in bf16, and the gather and all-to-all in
int64 (the MoE counts and slots), point-to-point (``send`` / ``recv`` and
``batch_isend_irecv``) on CPU tensors; it prints each rank's answer per op,
then gloo's all-reduce fit (``measure_allreduce``, 1 to 64 MiB) on CUDA
tensors, the same fit of all-reduces on CPU tensors (the host's rate, no
interconnect), a 64 MiB fp32 hop staged through pinned host buffers (the
pipeline's transport under gloo on the card), and last point-to-point on
CUDA tensors in fp32 and bf16, and each rank's exit code (gloo fails to
send a CUDA tensor: "writev ... Bad address", or the sender dies).  Exits
non-zero without a GPU.
"""
import datetime
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def probe_rank(rank: int, world: int, store: str, backend: str) -> None:
    """One rank of the probe: each op on CUDA tensors on device 0, its
    answer printed (a refusal is the answer this probe asks for)."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
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
    # uneven splits, as the expert exchange sends: rank r sends r + 1 rows
    # to each rank and receives (its sender's index + 1) from each
    send, recv = [rank + 1] * world, [s + 1 for s in range(world)]
    for dtype in (torch.float32, torch.bfloat16, torch.int64):
        name = str(dtype).split(".")[-1]
        rows = torch.full((sum(send), 4), rank + 1, device=dev).to(dtype)

        def a2a(rows=rows, dtype=dtype):
            out = torch.zeros((sum(recv), 4), device=dev, dtype=dtype)
            dist.all_to_all_single(out, rows, recv, send)
            want = torch.cat([torch.full((s + 1, 4), s + 1, device=dev) for s in range(world)])
            if not torch.equal(out.float(), want.float()):
                raise ValueError(f"wrong rows {out[:, 0].tolist()}")
        ops[f"all_to_all_single {name}"] = a2a
    ops["all_gather_into_tensor int64"] = lambda: dist.all_gather_into_tensor(
        torch.empty(8 * world, device=dev, dtype=torch.int64), x.long())
    # the pipeline's stage hop: point-to-point between the two ranks, last
    # (a refused hop may leave its peer waiting until the group's timeout)
    peer = 1 - rank

    def p2p(dtype, batched, device):
        mine = torch.full((8,), float(rank + 1), device=device).to(dtype)
        got = torch.zeros_like(mine)
        if batched:
            for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, mine, peer),
                                               dist.P2POp(dist.irecv, got, peer)]):
                req.wait()
        elif rank == 0:
            dist.send(mine, peer)
            dist.recv(got, peer)
        else:
            dist.recv(got, peer)
            dist.send(mine, peer)
        if not torch.equal(got.float().cpu(), torch.full((8,), float(peer + 1))):
            raise ValueError(f"wrong values {got.tolist()}")
    ops["send/recv float32 cpu"] = lambda: p2p(torch.float32, False, "cpu")
    ops["batch_isend_irecv float32 cpu"] = lambda: p2p(torch.float32, True, "cpu")
    on_card = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for batched in (False, True):
            kind = "batch_isend_irecv" if batched else "send/recv"
            on_card[f"{kind} {name} cuda"] = (lambda d=dtype, b=batched: p2p(d, b, dev))
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
        # a pipeline hop's size at full llama width (2 x 4096 x 2048 fp32):
        # rank 0 sends, rank 1 returns it, 4 round trips, on CUDA tensors
        # directly and staged through pinned host buffers
        hop = torch.ones(1 << 24, device=dev)
        for how in ("pinned host buffers",):
            try:
                host = torch.empty(hop.shape, pin_memory=True)
                ts = []
                for _ in range(5):
                    dist.barrier()
                    t0 = time.perf_counter()
                    for turn in (0, 1):
                        if rank == turn:
                            host.copy_(hop)
                            dist.send(host, 1 - rank)
                        else:
                            dist.recv(host, 1 - rank)
                            hop.copy_(host)
                    torch.cuda.synchronize()
                    ts.append(time.perf_counter() - t0)
                s_hop = sorted(ts[1:])[1] / 2
                print(f"probe gloo rank {rank} hop of 64 MiB fp32 through {how}: "
                      f"{s_hop * 1e3:.2f} ms ({hop.numel() * 4 / s_hop / 1e9:.3g} GB/s)",
                      flush=True)
            except Exception as e:
                print(f"probe gloo rank {rank} hop through {how}: {type(e).__name__}: "
                      f"{str(e).splitlines()[0][:300]}", flush=True)
    # point-to-point on CUDA tensors last: a rank that dies here (gloo may)
    # takes only these answers with it
    for name, op in on_card.items():
        try:
            op()
            torch.cuda.synchronize()
            answer = "ok"
        except Exception as e:
            answer = f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
        print(f"probe {backend} rank {rank} {name}: {answer}", flush=True)
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
                lines.append(f"probe {backend} rank {procs.index(p)} exited {p.returncode}")
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
    if sys.argv[1:2] == ["--moe"]:
        cs.moe_parallel_phase(torch)
    elif sys.argv[1:2] == ["--ssm"]:
        cs.ssm_parallel_phase(torch)
    elif sys.argv[1:2] == ["--pp"]:
        cs.pipeline_phase(torch)
    elif sys.argv[1:2] == ["--cp"]:
        cs.cp_phase(torch)
    elif sys.argv[1:2] == ["--ppcp"]:
        cs.ppcp_phase(torch)
    else:
        cs.parallel_phase(torch)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--probe-rank"]:
        probe_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
        sys.exit(0)
    sys.exit(main())
