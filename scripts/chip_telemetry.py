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
import sys

from chip_phase import setup


def main() -> int:
    ready = setup("chip_telemetry")
    if ready is None:
        return 1
    torch, cs, counters = ready
    import numpy as np

    from repro_torch import serving
    from repro_torch.kernels.rmsnorm import ops as rms_ops

    cs.telemetry_phase(torch, np, serving, rms_ops, counters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
