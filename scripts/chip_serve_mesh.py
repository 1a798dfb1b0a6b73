#!/usr/bin/env python3
"""Phase 34 of ``chip_smoke.py`` alone, on one CUDA GPU: four gloo ranks
sharing the card serve qwen2.5-3b at full width on a (data 2, model 2)
mesh under tp 2 — (a) bf16 at full depth, 4 x 512 prompt tokens and 16
greedy tokens through ``step_engine(...).greedy_generate`` with the KV
cache's positions split over the model axis (flash-decode), held to one
rank's engine and the plain path; (b) fp32 cut to 4 layers, logits and the
gathered cache against one rank's; (c) the same at ``max_len`` 543, whose
cache stays whole (see ``chip_smoke.serve_mesh_phase``) — then the K1 and
K2 rows of phase 3 that the phase's ranks run (paths ``serve_mesh`` and
``serve_mesh_whole``).

    python3 scripts/chip_serve_mesh.py

Exits non-zero without a GPU.
"""
import sys

from chip_phase import setup


def main() -> int:
    ready = setup("chip_serve_mesh")
    if ready is None:
        return 1
    torch, cs, _ = ready
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm import ref as rms_ref

    started = cs.serve_mesh_start()
    gen = torch.Generator(device="cuda").manual_seed(0)
    paths = cs.SERVE_MESH_PATHS
    rows = {"flash_attention_fwd": cs.check_flash(torch, flash_ops, flash_ref, gen, only=paths),
            "rmsnorm": cs.check_rmsnorm(torch, rms_ops, rms_ref, gen, only=paths)}
    launches = cs.serve_mesh_phase(torch, started)
    for name, kernel_rows in rows.items():
        for r in kernel_rows:
            for path in paths:
                if cs.on_path(r["path"], path):
                    cs.log(f"{path} row {name} [{r['label']}] launches {launches[path][name]} "
                           f"ms {r['ms']:.5f} bound {r['bound_ms']:.6f} ({r['bound_by']}) "
                           f"plain {r['plain_ms']:.4f} library {r['library_ms']:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
