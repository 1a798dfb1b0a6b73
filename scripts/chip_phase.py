"""What the one-phase scripts of ``chip_smoke.py`` share
(``chip_checkpoint.py``, ``chip_telemetry.py``, ``chip_elastic.py``):
``setup(name)`` sets chip_smoke's allocator option, refuses to run without
a GPU, puts the checkout on the path, logs the card's name and power
limit, loads (building when needed) the kernels and returns ``(torch,
chip_smoke, the launch counters)``.
"""
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def setup(name: str):
    """``(torch, chip_smoke, counters)``, or None (after a message on
    stderr) without a GPU."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print(f"{name}: needs one CUDA GPU", file=sys.stderr)
        return None
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
    return torch, cs, cs.launch_counters(flash_ops, rms_ops, ssd_ops)
