#!/usr/bin/env python3
"""The serving phases of ``chip_smoke.py`` alone, on one CUDA GPU:

    python3 scripts/chip_serve_graphs.py [PATH ...]

Builds the kernels, then runs, each with chip_smoke's own checks, the paths
named (all of them, in this order, when none is):

- ``llama``: phase 4 (the llama scheduler, graphed and eager, both
  profiled) and 5 (its parity);
- ``mamba2``: phase 6 with 6b (mamba2 served eagerly, then through
  ``jit_decode_step``) and 7b (a reduced mamba2's prefill graph against
  eager);
- ``zamba2``: phase 8 with 8b (zamba2 served eagerly, then through
  ``jit_prefill_step`` and ``jit_decode_step``);
- ``moonshot``: phase 12 with 12b (the same for full-depth moonshot);
- ``whisper``: phase 15 with 15b (whisper's frames through the graphed
  prefill, then the graphed decode);
- ``internvl2``: phase 18 with 18b (the same for internvl2).

All six take about five minutes of command time: the quick way to measure
the decode paths.  Exits non-zero without a GPU.
"""
import gc
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
PATHS = ("llama", "mamba2", "zamba2", "moonshot", "whisper", "internvl2")


def main(argv: list[str]) -> int:
    unknown = sorted(set(argv) - set(PATHS))
    if unknown:
        print(f"chip_serve_graphs: unknown paths {unknown}; choose from {PATHS}",
              file=sys.stderr)
        return 2
    paths = [p for p in PATHS if p in argv] or list(PATHS)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_serve_graphs: needs one CUDA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np

    import chip_smoke as cs
    from repro_torch import serving
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    cs.log(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    _build.library()
    cs.log(f"build: {time.perf_counter() - t0:.1f} s")
    counters = cs.launch_counters(flash_ops, rms_ops, ssd_ops)

    def llama():
        session, eager, prompts, _ = cs.serve_full_width(torch, np, serving, counters)
        cs.profile_decode(torch, np, serving, session)
        cs.profile_decode(torch, np, serving, eager)
        cs.parity(torch, np, serving, build_model, session, prompts)

    def step_engine(arch, prefill_graph):
        engine, params, prompts, _, eager_run = cs.serve_step_engine(
            torch, np, serving, build_model, get_config, counters, arch)
        cs.graphed_serve(torch, engine, params, prompts, None, cs.STATIC_NEW, eager_run,
                         counters, prefill_graph=prefill_graph)

    def mamba2():
        step_engine("mamba2-2.7b", False)
        cs.graphed_prefill_check(torch, np, serving, build_model,
                                 get_config("mamba2-2.7b").reduced(), counters)

    def whisper():
        engine, params, frames, prompts, _, eager_run = cs.whisper_serve_phase(
            torch, np, serving, build_model, get_config, counters)
        cs.graphed_serve(torch, engine, params, prompts, {"frames": frames}, cs.WHISPER_NEW,
                         eager_run, counters, prefill_graph=True)

    def internvl2():
        engine, params, vis, prompts, _, eager_run = cs.vlm_serve_phase(
            torch, np, serving, build_model, get_config, counters)
        cs.graphed_serve(torch, engine, params, prompts, {"vis_embeds": vis}, cs.VLM_NEW,
                         eager_run, counters, prefix=cs.VLM_PREFIX, prefill_graph=True)

    runs = {"llama": llama, "mamba2": mamba2,
            "zamba2": lambda: step_engine("zamba2-7b", True),
            "moonshot": lambda: step_engine(cs.MOE_ARCH, True),
            "whisper": whisper, "internvl2": internvl2}
    for path in paths:
        t0 = time.perf_counter()
        runs[path]()
        gc.collect()
        torch.cuda.empty_cache()
        cs.log(f"{path}: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
