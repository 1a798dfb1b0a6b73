"""Step-level serving engine on one device (the port of
``repro.runtime.serve``).

``ServingEngine`` runs a model's ``forward_prefill`` / ``forward_decode``
under an :class:`ExecutionPlan`, and ``greedy_generate`` serves one static
batch of equal-length prompts:

- an unsharded dense model goes through the paged KV cache, as the trivial
  B-requests-at-once case of the continuous-batching scheduler;
- every other model (the vlm, moe, ssm, hybrid and audio families:
  internvl2, moonshot, grok, mamba2, zamba2, whisper) takes
  :meth:`greedy_generate_reference`, one ``forward_prefill`` then one
  ``forward_decode`` per token — the slow, obviously-correct loop that
  stays the scheduler's oracle.  As in JAX it passes no ``extras``, so the
  encoder-decoder encodes zero frames there and the VLM serves no image
  prefix; real frames or patch embeddings go through
  ``prefill_step(params, tokens, {"frames": f})`` (or ``{"vis_embeds":
  v}``) and ``decode_step``, whose positions then count the Sv prefix rows
  (``cache_index = Sv + S + i``).

``jit_decode_step(donate=True)`` and ``jit_prefill_step()`` are JAX's
compiled steps with JAX's signatures: captured CUDA graphs of
``decode_step`` and ``prefill_step`` (``runtime/compiled.py``) on a CUDA
device, sharing one graph pool per engine; the same static-buffer plumbing
with direct calls on the CPU.  They hold every family, as JAX's do: a
nested cache (the hybrid's ``{"mamba", "attn"}``, the encoder-decoder's
``{"self", "cross"}``) is donated leaf by leaf, and ``extras`` (``frames``,
``vis_embeds``, or None) are fed.  ``greedy_generate_reference`` stays
eager, as JAX's does: it is their oracle.

Telemetry as JAX's: with ``metrics`` (a ``repro_torch.obs.MetricsRegistry``)
``greedy_generate_reference`` records its fenced prefill and per-token
decode latencies into the ``prefill_latency_s`` / ``decode_latency_s``
histograms and the ``requests`` / ``generated_tokens`` counters, inside the
``prefill`` / ``decode`` spans; ``latencies`` keeps the same times as lists.
``greedy_generate`` hands ``metrics`` to its scheduler.

Only a single device for now: a ``mesh`` raises ``NotImplementedError``.
Construct through ``repro_torch.serving.step_engine``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.strategy import ExecutionPlan
from repro_torch.obs import fence, span
from repro_torch.runtime.compiled import compile_step


@dataclasses.dataclass
class ServingEngine:
    model: Any
    plan: ExecutionPlan
    mesh: Any = None
    batch: int = 0                 # request batch
    max_len: int = 0               # cache capacity
    dtype: torch.dtype = torch.bfloat16   # compute dtype of the forward passes
    metrics: Any = None            # optional repro_torch.obs.MetricsRegistry
    latencies: dict = dataclasses.field(
        default_factory=lambda: {"prefill_s": [], "decode_s": []})
    _graph_pool: Any = dataclasses.field(default=None, init=False, repr=False)

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "ServingEngine: mesh-sharded serving is not ported yet (single device only)")

    @classmethod
    def for_plan(cls, model: Any, plan: ExecutionPlan, mesh: Any = None, *, batch: int = 0,
                 max_len: int = 0, dtype: torch.dtype = torch.bfloat16,
                 metrics: Any = None) -> "ServingEngine":
        return cls(model, plan, mesh, batch=batch, max_len=max_len, dtype=dtype,
                   metrics=metrics)

    # ------------------------------------------------------------ steps
    def prefill_step(self, params, tokens, extras=None):
        """``extras``: an optional dict of side inputs to ``forward_prefill``
        (``frames`` of the encoder-decoder, ``vis_embeds`` of the VLM), as
        in JAX."""
        return self.model.forward_prefill(params, tokens, max_len=self.max_len or None,
                                          dtype=self.dtype, **(extras or {}))

    def decode_step(self, params, tokens, cache, cache_index, kv_len=None):
        return self.model.forward_decode(params, tokens, cache, cache_index, kv_len=kv_len,
                                         dtype=self.dtype)

    # ------------------------------------------------------------ jit
    def _compiled_device(self) -> torch.device:
        """The device of the compiled steps; the graphs of this engine share
        one pool."""
        device = self.model.device
        if device.type == "cuda" and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return device

    def jit_decode_step(self, donate: bool = True):
        """``decode_step`` compiled: ``(params, tokens, cache, cache_index,
        kv_len=None) -> (logits, cache)``.  ``cache_index`` and ``kv_len``
        may be ints (turned into tensors on the host, fed to the graph) or
        tensors.  ``donate=True`` writes ``cache`` in place, as JAX donates
        it: the returned cache is the graph's buffers (the first call's cache
        itself) and its logits the graph's static output, valid until the
        next call; pass the returned cache back.  ``donate=False`` copies the
        cache in and returns clones, leaving the argument as it was."""
        device = self._compiled_device()
        step = compile_step(self.decode_step, device, held=(0,),
                            donated=(2,) if donate else (), pool=self._graph_pool,
                            clone_outputs=not donate, name="jit_decode_step")

        def decode(params, tokens, cache, cache_index, kv_len=None):
            if isinstance(kv_len, int):
                kv_len = torch.full((tokens.shape[0],), kv_len, dtype=torch.long)
            return step(params, tokens, cache, torch.as_tensor(cache_index), kv_len)

        decode.compiled = step
        return decode

    def jit_prefill_step(self):
        """``prefill_step`` compiled: ``(params, tokens, extras=None) ->
        (logits, cache)``, returned as fresh tensors (JAX's outputs are new
        arrays; the graph's own stay in the pool).  A graph per ``max_len``
        of the engine, which sizes the cache."""
        device = self._compiled_device()
        steps: dict = {}

        def prefill(params, tokens, extras=None):
            step = steps.get(self.max_len)
            if step is None:
                step = steps[self.max_len] = compile_step(
                    self.prefill_step, device, held=(0,), pool=self._graph_pool,
                    clone_outputs=True, name="jit_prefill_step")
            return step(params, tokens, extras)

        prefill.compiled = steps
        return prefill

    # ------------------------------------------------------------ loops
    def greedy_generate(self, params, prompt_tokens, max_new: int,
                        max_len: int) -> torch.Tensor:
        """Greedy generation for one static batch of equal-length prompts
        (B, S) -> tokens (B, max_new) int32 on the model's device.  A dense
        model goes through the paged scheduler, every other model through
        :meth:`greedy_generate_reference`."""
        if self.model.cfg.family != "dense":
            return self.greedy_generate_reference(params, prompt_tokens, max_new, max_len)
        from repro_torch.runtime.kv_cache import PagedCacheConfig
        from repro_torch.runtime.scheduler import ContinuousBatchingScheduler, Request

        prompts = np.asarray(torch.as_tensor(prompt_tokens).cpu(), np.int32)
        B, S = prompts.shape
        cache_cfg = PagedCacheConfig.for_model(
            self.model.cfg, num_slots=B, page_size=min(16, max(S, 1)), max_context=max_len)
        sched = ContinuousBatchingScheduler(self.model, params, cache_cfg, dtype=self.dtype,
                                            metrics=self.metrics)
        reqs = [sched.submit(Request(prompt=prompts[b], max_new=max_new)).request
                for b in range(B)]
        sched.run_until_drained()
        return torch.tensor(np.stack([r.tokens for r in reqs]), dtype=torch.int32,
                            device=self.model.device)

    def greedy_generate_reference(self, params, prompt_tokens, max_new: int,
                                  max_len: int) -> torch.Tensor:
        """Reference generation loop: one ``forward_prefill``, then one
        synchronous ``forward_decode`` per token.  Each step's fenced host
        time is appended to ``latencies["prefill_s"]`` / ``["decode_s"]`` and,
        with ``metrics``, observed in ``prefill_latency_s`` /
        ``decode_latency_s``."""
        tokens = torch.as_tensor(prompt_tokens).to(self.model.device, torch.long)
        B, S = tokens.shape
        self.max_len = max_len
        t0 = time.perf_counter()
        with span("prefill"):
            logits, cache = self.prefill_step(params, tokens)
            fence(logits)
        self._observe("prefill", time.perf_counter() - t0)
        out = [logits[:, -1, :].argmax(dim=-1).to(torch.int32)]
        kv_len = torch.full((B,), S, dtype=torch.long, device=tokens.device)
        for i in range(max_new - 1):
            t0 = time.perf_counter()
            with span("decode"):
                logits, cache = self.decode_step(params, out[-1][:, None].long(), cache,
                                                 S + i, kv_len=kv_len + i + 1)
                fence(logits)
            self._observe("decode", time.perf_counter() - t0)
            out.append(logits[:, -1, :].argmax(dim=-1).to(torch.int32))
        if self.metrics is not None:
            self.metrics.counter("requests").inc()
            self.metrics.counter("generated_tokens").inc(B * max_new)
        return torch.stack(out, dim=1)

    def _observe(self, kind: str, seconds: float) -> None:
        self.latencies[f"{kind}_s"].append(seconds)
        if self.metrics is not None:
            self.metrics.histogram(f"{kind}_latency_s").observe(seconds)
