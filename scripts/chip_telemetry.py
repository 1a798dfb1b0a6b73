#!/usr/bin/env python3
"""Phase 32 of ``chip_smoke.py`` alone, on one CUDA GPU: the ``StepTimer``'s
fence against CUDA events (and its no-op control), an ``obs.span`` in a
``torch.profiler`` trace, full-width llama3.2-1b served through
``serving.build(..., metrics=, sink=)`` and trained through ``python -m
repro_torch.launch.train --run-dir`` (see ``chip_smoke.telemetry_phase``).
Phase 31, whose writer logs to a run sink, runs alone as
``scripts/chip_checkpoint.py``:

    python3 scripts/chip_checkpoint.py && python3 scripts/chip_telemetry.py

About a minute of command time with the kernels' build.  Exits non-zero
without a GPU.
"""
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_telemetry: needs one CUDA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np

    import chip_smoke as cs
    from repro_torch import serving
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
    cs.telemetry_phase(torch, np, serving, rms_ops, counters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
