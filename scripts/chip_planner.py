#!/usr/bin/env python3
"""The planner phases of ``chip_smoke.py`` alone, on one CUDA GPU:

    python3 scripts/chip_planner.py

Builds the kernels, then runs, each with chip_smoke's own checks, phase
11's profiling (``launch.profile`` over two full-width llama3.2-1b blocks as
CUDA graphs, each cell beside its eager measurement, and the calibration)
and phase 23 (moonshot-v1-16b-a3b profiled, calibrated, searched on one
H100, its plan trained with the cyclic collector on and off, and the
launcher's ``--validate-only`` refusal).  About a minute and a half of
command time: the quick way to measure the block cells and the MoE plan.
Exits non-zero without a GPU.
"""
import gc
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_planner: needs one CUDA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    cs.log(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    _build.library()
    cs.log(f"build: {time.perf_counter() - t0:.1f} s")
    counters = cs.launch_counters(flash_ops, rms_ops, ssd_ops)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cs.profile_and_calibrate(counters, get_config(cs.TRAIN_ARCH),
                                 os.path.join(tmp, "cuda.json"), "planner")
    gc.collect()
    torch.cuda.empty_cache()
    cs.log(f"llama profiling: {time.perf_counter() - t0:.1f} s")
    cs.moe_planner_phase(torch, counters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
