"""``profile`` subcommand — measure block timings into the profile cache.

Shared by both launchers (``train.py profile ...`` / ``serve.py profile ...``).
Times one block's forward, grad and full-remat grad per (arch, dtype, seq)
cell on the card with :func:`repro_torch.core.profiler_model.measure_block`
(a decoder block of a dense, vlm or MoE model, a Mamba2 block of an ssm or
hybrid one; K1, K2 and K3 under autograd), each step a CUDA graph as JAX
jits it, fits the collective alpha-beta with
:func:`repro_torch.core.profiler_hw.measure_allreduce` (one device: the
exact degenerate fit), writes the versioned on-disk cache
(``results/profiles/cuda.json``, the JAX package's layout) and prints the
fitted calibration table.  A second run over the same cells does **zero**
re-measurement — everything comes from the cache.

    python -m repro_torch.launch.profile --arch llama3.2-1b --full \\
        --seq 1024,4096 --dtype bf16 --microbatch 2
    python -m repro_torch.launch.profile --arch moonshot-v1-16b-a3b --full \\
        --seq 1024,4096 --dtype bf16 --microbatch 2
"""
from __future__ import annotations

import argparse
import functools

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core import calibrate as cal
from repro_torch.core import profile_cache as pcache
from repro_torch.core import profiler_hw as hw
from repro_torch.core.profiler_model import measure_block
from repro_torch.models.common import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="profile",
        description="measure per-block timings into the profile cache")
    ap.add_argument("--arch", action="append", choices=ARCH_IDS, default=None,
                    help="model(s) to profile (repeatable; default llama3.2-1b)")
    ap.add_argument("--full", action="store_true",
                    help="profile the full-size config (default: reduced)")
    ap.add_argument("--seq", default="64,128",
                    help="comma-separated sequence lengths")
    ap.add_argument("--dtype", default="fp32,bf16",
                    help="comma-separated compute dtypes (fp32,bf16)")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--no-remat", action="store_true",
                    help="skip the full-remat overhead measurement")
    ap.add_argument("--cache", default=None,
                    help="cache path (default results/profiles/<backend>.json)")
    ap.add_argument("--force", action="store_true",
                    help="drop cached entries and re-measure everything")
    ap.add_argument("--device", default="cuda",
                    help="torch device to measure on (cuda: the CUDA kernels; "
                         "cpu: the plain versions)")
    args = ap.parse_args(argv)

    backend = resolve_device(args.device).type
    path = args.cache or pcache.default_path(backend)
    cache = pcache.ProfileCache.load_or_create(path)
    if args.force:
        cache.reset()

    dtypes = [d.strip() for d in args.dtype.split(",") if d.strip()]
    seqs = [int(s) for s in args.seq.split(",") if s.strip()]
    cells = []
    for arch in (args.arch or ["llama3.2-1b"]):
        cfg = get_config(arch)
        if not args.full:
            cfg = cfg.reduced()
        for dt in dtypes:
            for seq in seqs:
                key = pcache.ProfileKey(
                    backend=backend, model=pcache.model_key(cfg), dtype=dt,
                    tp=1, cp=1, seq=seq, microbatch=args.microbatch)
                cells.append((cfg, key))

    measured, cached = cal.run_profile_cells(
        cells, cache, iters=args.iters, with_remat=not args.no_remat,
        measure_fn=functools.partial(measure_block, device=args.device),
        verbose=True)

    n = 1                               # the port runs on one device
    for dt in dtypes:
        if cache.get_comm(backend, dt, n) is None:
            fit = hw.measure_allreduce(dtype=dt, n_devices=n)
            cache.put_comm(pcache.CommEntry(
                backend=backend, dtype=dt, n_devices=n,
                alpha=fit.alpha, beta=fit.beta, r2=fit.r2))
        else:
            cached += 1

    cache.save()
    print(cal.calibrate(cache).format_table())
    print(f"profile: {measured} cell(s) measured, {cached} from cache "
          f"-> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
