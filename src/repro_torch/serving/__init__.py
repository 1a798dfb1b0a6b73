"""``repro_torch.serving`` — the port's serving entry point.

A frozen :class:`ServeConfig` (model / cache / scheduler / SLO sections plus
the device, statically validated against the GALV08x checks in
``__post_init__``) and one constructor::

    from repro_torch import serving

    config = serving.ServeConfig(
        arch="llama3.2-1b", reduced=False,
        cache=serving.CacheConfig(max_context=1024, page_size=16),
        scheduler=serving.SchedulerConfig(num_slots=8, prefill_chunk=256))
    engine = serving.build(config)            # on config.device ("cuda")

    stream = engine.submit(serving.Request(prompt=ids, max_new=64))
    for token in stream:          # drives engine.tick() under the hood
        ...

``build`` returns a :class:`ServeSession` wrapping the continuous-batching
scheduler (``repro_torch.runtime.scheduler``) over the paged KV cache (dense
models).  On CUDA the scheduler serves through captured CUDA graphs of its
decode step (all ``num_slots`` lanes) and prefill step (one chunk), as JAX
jits them (``runtime/compiled.py``).  The default cluster is one H100 card.

``step_engine(model, single_device_plan(cfg))`` is the step-level engine
(``repro_torch.runtime.serve.ServingEngine``): ``greedy_generate`` serves a
static batch, through the paged scheduler for a dense model and through
``forward_prefill`` + ``forward_decode`` for every other family (the vlm,
moe, ssm, hybrid and audio families: internvl2, moonshot, grok, mamba2,
zamba2, whisper)::

    model = build_model(get_config("mamba2-2.7b"))          # on "cuda"
    engine = serving.step_engine(model, serving.single_device_plan(model.cfg))
    tokens = engine.greedy_generate(params, prompts, max_new=32, max_len=2080)

Its ``jit_prefill_step()`` and ``jit_decode_step(donate=True)`` are the
compiled steps (CUDA graphs; dense, vlm and ssm families).  Mesh-sharded
engines and telemetry sinks are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.analysis import plan_check as pc
from repro_torch.configs.registry import ModelConfig, get_config
from repro_torch.core.cluster import H100_1, ClusterSpec
from repro_torch.core.strategy import ExecutionPlan, LayerStrategy
from repro_torch.models.common import resolve_device
from repro_torch.runtime.kv_cache import CacheOOM, PagedCacheConfig
from repro_torch.runtime.scheduler import (ContinuousBatchingScheduler, Request,
                                           TokenStream)

__all__ = [
    "CacheConfig", "SchedulerConfig", "SLOConfig", "ServeConfig",
    "ServeSession", "Request", "TokenStream", "CacheOOM", "build",
    "single_device_plan", "step_engine",
]


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Paged-pool geometry.  ``num_pages=None`` fully provisions every slot
    (no oversubscription, the scheduler never evicts)."""

    max_context: int = 512         # per-request ceiling: prompt + new tokens
    page_size: int = 16            # tokens per cache page
    num_pages: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Continuous-batching knobs."""

    num_slots: int = 4             # concurrent decode streams
    prefill_chunk: int = 32        # prompt tokens prefilled per tick
    temperature: float = 0.0       # default for submitted requests (<=0 greedy)
    seed: int = 0                  # base seed for temperature sampling


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Latency / load targets (read by benchmarks, not enforced)."""

    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None
    request_rate: Optional[float] = None


def single_device_plan(cfg: ModelConfig, shape: str = "serve") -> ExecutionPlan:
    """The trivial 1-device plan of a single-card serving path."""
    strat = LayerStrategy()
    return ExecutionPlan(arch=cfg.name, shape=shape, mesh_axes=("data",),
                         mesh_shape=(1,),
                         layer_strategies=[strat] * cfg.num_layers,
                         default_strategy=strat)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Everything needed to stand up a serving engine, in one frozen value.
    An invalid geometry raises ``ValueError`` carrying the GALV08x table."""

    arch: str = "qwen2.5-3b"
    reduced: bool = True           # CPU-scale .reduced() variant of the arch
    cluster: Optional[ClusterSpec] = None  # None: one H100 card
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    scheduler: SchedulerConfig = dataclasses.field(
        default_factory=SchedulerConfig)
    slo: SLOConfig = dataclasses.field(default_factory=SLOConfig)
    init_seed: int = 0             # generator seed for build()'s param init
    device: str = "cuda"

    def __post_init__(self):
        report = self.check()
        if not report.ok():
            raise ValueError("invalid ServeConfig:\n" + report.format_table())

    # ------------------------------------------------------------ derived
    def model_config(self) -> ModelConfig:
        cfg = get_config(self.arch)
        return cfg.reduced() if self.reduced else cfg

    def resolved_cluster(self) -> ClusterSpec:
        return self.cluster if self.cluster is not None else H100_1

    def serve_spec(self) -> pc.ServeSpec:
        """The plan-check view of this config's cache geometry."""
        return pc.ServeSpec(num_slots=self.scheduler.num_slots,
                            page_size=self.cache.page_size,
                            max_context=self.cache.max_context,
                            num_pages=self.cache.num_pages)

    def cache_config(self) -> PagedCacheConfig:
        return PagedCacheConfig.for_model(
            self.model_config(), num_slots=self.scheduler.num_slots,
            page_size=self.cache.page_size,
            max_context=self.cache.max_context,
            num_pages=self.cache.num_pages)

    def check(self) -> pc.PlanReport:
        """The GALV08x report."""
        return pc.check_serve(self.serve_spec(), self.resolved_cluster(),
                              self.model_config())


class ServeSession:
    """A built serving engine: ``submit(request) -> stream`` / ``tick()`` /
    ``stats()`` over a continuous-batching scheduler.  Construct with
    :func:`build`."""

    def __init__(self, config: ServeConfig,
                 scheduler: ContinuousBatchingScheduler, model: Any,
                 params: Any):
        self.config = config
        self.scheduler = scheduler
        self.model = model
        self.params = params

    def submit(self, request: Request) -> TokenStream:
        """Queue one request; returns a stream yielding its tokens (iterating
        the stream drives ``tick()`` as needed)."""
        if request.temperature == 0.0 and self.config.scheduler.temperature:
            request.temperature = self.config.scheduler.temperature
        if request.seed == 0:
            request.seed = self.config.scheduler.seed
        return self.scheduler.submit(request)

    def tick(self) -> dict:
        """One scheduling quantum: admit / prefill a chunk / decode a token."""
        return self.scheduler.tick()

    def stats(self) -> dict:
        return self.scheduler.stats()

    def run_until_drained(self, max_ticks: int = 100_000) -> None:
        self.scheduler.run_until_drained(max_ticks)


def build(config: ServeConfig, *, model: Any = None, params: Any = None,
          dtype: torch.dtype = torch.bfloat16,
          sample_fn: Optional[Callable] = None,
          clock: Optional[Callable[[], float]] = None) -> ServeSession:
    """Stand up a :class:`ServeSession` on ``config.device``.

    ``model`` defaults to ``build_model(cfg, device=config.device)`` (the
    CUDA kernels on a CUDA device); ``params`` to a fresh init from a
    ``torch.Generator`` seeded with ``config.init_seed`` on that device.
    Params are cast to ``dtype`` (bf16, the serving dtype; fp32 for exact
    comparisons), which is also the pool's and the forward passes' dtype."""
    from repro_torch.models import build_model
    from repro_torch.models.common import cast_tree

    cfg = config.model_config()
    device = resolve_device(config.device)
    if cfg.family not in ("dense",):
        raise NotImplementedError(
            f"paged serving supports the dense cache layout; family "
            f"{cfg.family!r} goes through step_engine()")
    if model is None:
        model = build_model(cfg, device=device)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(config.init_seed)
        params = model.init(gen, dtype)
    params = cast_tree(params, dtype)
    kw = {} if clock is None else {"clock": clock}
    scheduler = ContinuousBatchingScheduler(
        model, params, config.cache_config(),
        prefill_chunk=config.scheduler.prefill_chunk, dtype=dtype,
        sample_fn=sample_fn, **kw)
    return ServeSession(config, scheduler, model, params)


def step_engine(model: Any, plan: ExecutionPlan, mesh=None, *, batch: int = 0,
                max_len: int = 0, dtype: torch.dtype = torch.bfloat16,
                device: str = "cuda"):
    """The sanctioned constructor of the step-level ``ServingEngine``.

    ``device`` (the card by default; raises without a GPU) must be the
    model's; ``dtype`` is the forward passes' compute dtype (bf16, the
    serving dtype; fp32 for exact comparisons).  A ``mesh`` raises: only the
    single-device engine is ported."""
    from repro_torch.runtime.serve import ServingEngine

    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"step_engine: the model lives on {model.device}, not {dev}")
    return ServingEngine.for_plan(model, plan, mesh, batch=batch, max_len=max_len,
                                  dtype=dtype)
