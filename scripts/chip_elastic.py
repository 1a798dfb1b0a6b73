#!/usr/bin/env python3
"""Phase 33 of ``chip_smoke.py`` alone, on one CUDA GPU: four gloo ranks
sharing the card train llama3.2-1b at full width cut to 2 layers through a
replanned shrink from 4 ranks to 2 and a grow back to 4, each migration
run in memory and through a checkpoint from the same state (bitwise on
every rank), each post-resize loss held to one rank's on the same
canonical state and the launches pinned (see ``chip_smoke.elastic_phase``).

    python3 scripts/chip_elastic.py

Exits non-zero without a GPU.
"""
import sys

from chip_phase import setup


def main() -> int:
    ready = setup("chip_elastic")
    if ready is None:
        return 1
    torch, cs, _ = ready
    cs.elastic_phase(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
