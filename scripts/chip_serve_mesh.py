#!/usr/bin/env python3
"""Phase 34 of ``chip_smoke.py`` alone, on one CUDA GPU: four gloo ranks
sharing the card serve on a (data 2, model 2) mesh under tp 2 — (a)
qwen2.5-3b bf16 at full width and depth, 4 x 512 prompt tokens and 16
greedy tokens through ``step_engine(...).greedy_generate`` with the KV
cache's positions split over the model axis (flash-decode), held to one
rank's engine and the plain path; (b) fp32 cut to 4 layers, logits and the
gathered cache against one rank's; (c) the same at ``max_len`` 543, whose
cache stays whole; (d) mamba2-2.7b at full width and depth and (e)
zamba2-7b at full width cut to 12 layers, bf16, each as (a): the SSD state
sharded by heads, K3 on a rank's heads, the gate norm through K2's
split-row passes, zamba2's sites by flash-decode; (f) both in fp32 at 2 and
6 layers, as (b) (see ``chip_smoke.serve_mesh_phase``) — then the K1, K2,
split K2 and K3 rows of phase 3 that the phase's ranks run (paths
``serve_mesh``, ``serve_mesh_whole``, ``serve_mesh_ssm`` and
``serve_mesh_hybrid``), each with its launches.

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
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    started = cs.serve_mesh_start()
    gen = torch.Generator(device="cuda").manual_seed(0)
    paths = cs.SERVE_MESH_ALL_PATHS
    rows = {"flash_attention_fwd": cs.check_flash(torch, flash_ops, flash_ref, gen, only=paths),
            "rmsnorm": cs.check_rmsnorm(torch, rms_ops, rms_ref, gen, only=paths),
            "rmsnorm_split_fwd": cs.check_rmsnorm_split(torch, rms_ops, rms_ref, gen,
                                                        only=paths),
            "ssd": cs.check_ssd(torch, ssd_ops, ssd_ref, gen, only=paths)}
    launches = cs.serve_mesh_phase(torch, started)
    for name, kernel_rows in rows.items():
        for r in kernel_rows:
            for path in paths:
                if cs.on_path(r["path"], path):
                    library = "null" if r["library_ms"] is None else f"{r['library_ms']:.5f}"
                    cs.log(f"{path} row {name} [{r['label']}] launches {launches[path][name]} "
                           f"ms {r['ms']:.5f} bound {r['bound_ms']:.6f} ({r['bound_by']}) "
                           f"plain {r['plain_ms']:.4f} library {library}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
