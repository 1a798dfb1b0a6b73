"""Serving driver: continuous batching over the paged KV cache, on a device.

The run path of ``repro.launch.serve`` for the port: builds a frozen,
statically validated :class:`repro_torch.serving.ServeConfig`, stands the
engine up with ``repro_torch.serving.build``, submits a batch of random
prompts (numpy seed 1) and drains the scheduler, then prints throughput and
the TTFT/TPOT percentiles.  As in the JAX CLI the model is the arch's
``.reduced()`` variant (``chip_smoke.py`` serves the published widths).
``--device`` defaults to ``cuda`` (the CUDA kernels, the scheduler's decode
and prefill steps replayed as captured CUDA graphs, as JAX jits them);
``--device cpu`` runs the plain versions, eagerly.

    python -m repro_torch.launch.serve --arch llama3.2-1b --batch 8 \\
        --prompt-len 512 --max-new 32 --prefill-chunk 256

``serve.py search ...`` runs the serve objective instead: the port's
``SearchEngine.search_serve`` picks (tp, num_slots, page_size) for one H100
and a context window under an SLO and prints the roofline's predictions
without touching any device memory.  ``serve.py profile ...`` is the
``profile`` subcommand.

``--run-dir DIR`` writes the run's JSONL log as JAX's does
(``repro_torch.obs.RunSink``, ``DIR/run.jsonl``): ``run_start`` with the
meta ``{arch, mode: "serve", batch}``, then the scheduler's per-request
events (``request_start``, ``first_token``, ``request_end``,
``request_evicted``); ``scripts/render_run.py DIR`` renders its serving
section (TTFT/TPOT percentiles, queue depth).

    python -m repro_torch.launch.serve search --arch qwen3-14b --max-context 4096
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS


def _search_main(argv) -> int:
    from repro_torch import serving
    from repro_torch.configs.registry import get_config
    from repro_torch.core.search import SearchEngine

    ap = argparse.ArgumentParser(prog="serve.py search")
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-14b")
    ap.add_argument("--max-context", type=int, default=4096)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--ttft", type=float, default=None, help="SLO p50 TTFT, s")
    ap.add_argument("--tpot", type=float, default=None, help="SLO p50 TPOT, s")
    ap.add_argument("--rate", type=float, default=None,
                    help="offered load, requests/s")
    args = ap.parse_args(argv)

    slo = serving.SLOConfig(ttft_s=args.ttft, tpot_s=args.tpot,
                            request_rate=args.rate)
    engine = SearchEngine(get_config(args.arch))
    result = engine.search_serve(
        max_context=args.max_context, prompt_len=args.prompt_len, slo=slo)
    print(f"cluster {engine.cluster.name}: evaluated {result.evaluated} geometries in "
          f"{result.search_seconds * 1e3:.0f} ms; rejections: "
          f"{result.rejections}")
    if result.choice is None:
        print("no feasible serving deployment under this SLO")
        return 1
    c = result.choice
    print(f"tp={c.tp} num_slots={c.num_slots} page_size={c.page_size} "
          f"num_pages={c.num_pages} ({c.pool_gb:.2f} GB pool/chip)")
    print(f"predicted: ttft {c.ttft_s * 1e3:.1f} ms, tpot "
          f"{c.tpot_s * 1e3:.2f} ms, {c.tokens_per_s:,.0f} tok/s "
          f"({c.tokens_per_s_per_chip:,.0f}/chip), {c.bound}-bound")
    return 0


def main(argv=None):
    import sys
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "profile":
        from repro_torch.launch import profile as profile_cli
        return profile_cli.main(argv[1:])
    if argv and argv[0] == "search":
        return _search_main(argv[1:])
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2.5-3b")
    ap.add_argument("--batch", type=int, default=4,
                    help="requests to submit")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--num-slots", type=int, default=0,
                    help="concurrent decode slots (0: same as --batch)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-context", type=int, default=0,
                    help="per-request cache ceiling (0: prompt+new, padded "
                         "to a whole page)")
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda: the CUDA kernels; cpu: the "
                         "plain versions)")
    ap.add_argument("--run-dir", default="",
                    help="directory for the JSONL run log (repro_torch.obs "
                         "RunSink) — per-request TTFT/TPOT events land there")
    args = ap.parse_args(argv)

    from repro_torch import obs, serving

    sink = (obs.RunSink.create(args.run_dir,
                               meta={"arch": args.arch, "mode": "serve",
                                     "batch": args.batch})
            if args.run_dir else obs.NullSink())
    metrics = obs.MetricsRegistry()

    need = args.prompt_len + args.max_new
    max_context = args.max_context or -(-need // args.page_size) * args.page_size
    config = serving.ServeConfig(
        arch=args.arch, reduced=True, device=args.device,
        cache=serving.CacheConfig(max_context=max_context,
                                  page_size=args.page_size),
        scheduler=serving.SchedulerConfig(
            num_slots=args.num_slots or args.batch,
            prefill_chunk=args.prefill_chunk,
            temperature=args.temperature))
    engine = serving.build(config, metrics=metrics, sink=sink)
    vocab = config.model_config().vocab_size
    sync = (torch.cuda.synchronize if engine.model.device.type == "cuda"
            else (lambda: None))

    rng = np.random.default_rng(1)
    prompts = rng.integers(0, vocab, (args.batch, args.prompt_len),
                           dtype=np.int32)
    sync()
    t0 = time.perf_counter()
    streams = [engine.submit(serving.Request(prompt=prompts[b],
                                             max_new=args.max_new))
               for b in range(args.batch)]
    engine.run_until_drained()
    sync()
    wall = time.perf_counter() - t0
    sink.close()

    reqs = [s.request for s in streams]
    tokens = sum(len(r.tokens) for r in reqs)
    ttft = sorted(r.ttft_s for r in reqs)
    tpot = sorted(r.tpot_s for r in reqs)
    print(f"arch={config.model_config().name} requests={args.batch} "
          f"slots={config.scheduler.num_slots} page={args.page_size} "
          f"max_context={max_context} device={engine.model.device}")
    print(f"generated {tokens} tokens in {wall * 1e3:.1f} ms "
          f"({tokens / wall:,.0f} tok/s)")
    print(f"ttft: p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms  "
          f"max {ttft[-1] * 1e3:.1f} ms")
    print(f"tpot: p50 {tpot[len(tpot) // 2] * 1e3:.2f} ms  "
          f"max {tpot[-1] * 1e3:.2f} ms")
    print(f"stats: {engine.stats()}")
    print(f"sample tokens: {reqs[0].tokens[:10]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
