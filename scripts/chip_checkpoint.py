#!/usr/bin/env python3
"""Phase 31 of ``chip_smoke.py`` alone, on one CUDA GPU: llama3.2-1b at full
width cut to 2 layers trained with every step donated, its step-2 state
saved synchronously and through ``CheckpointWriter.save_async`` while step
3 runs in place, restored into a fresh trainer; both step 3s bitwise the
uninterrupted run's, the two directories byte-identical, the async save
blocking less than the sync one (see ``chip_smoke.checkpoint_phase``).

    python3 scripts/chip_checkpoint.py

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
        print("chip_checkpoint: needs one CUDA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
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
    cs.checkpoint_phase(torch, cs.launch_counters(flash_ops, rms_ops, ssd_ops))
    return 0


if __name__ == "__main__":
    sys.exit(main())
