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
import sys

from chip_phase import setup


def main() -> int:
    ready = setup("chip_checkpoint")
    if ready is None:
        return 1
    torch, cs, counters = ready
    cs.checkpoint_phase(torch, counters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
