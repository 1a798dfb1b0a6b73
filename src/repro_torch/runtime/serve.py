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

On a mesh (a ``launch.mesh.ProcessMesh`` under ``torch.distributed``) the
engine serves the dense, vlm, ssm and hybrid families under data
parallelism over the batch and tensor parallelism over heads, ff, vocab
and the SSM heads and channels, as JAX's ``ServingEngine`` does under
GSPMD: ``param_specs`` (``param_spec_tree``), ``cache_specs``
(``cache_spec_tree`` at the engine's ``batch`` and ``max_len``) and the
activation rules of the plan's default strategy, under which
``prefill_step`` and ``decode_step`` run.  Each rank holds local shards:
``place_params`` cuts them from the canonical tree, and ``gather_cache``
puts a cache (flat or nested) back together.  The steps take JAX's global
arrays (tokens, ``kv_len``, ``extras`` and a per-slot ``cache_index``, the
same on every rank), run this rank's batch rows (``batch_spec``: whole
where the batch does not divide) and return the global fp32 logits on every
rank, gathered over the vocab shards and the batch group, with this rank's
cache: where ``cache_specs`` shards an attention cache's positions over the
model axis, each rank's slice holds every KV head and a decode step is
flash-decode (K1's partials over every rank's slice, merged;
``models/attention.py``); an SSM state holds this rank's heads and
``d_inner`` channels, its B / C conv buffers whole (``models/mamba2.py``).
The batch split and ``cache_seq`` are read off the cache's logical axes
(``batch`` and ``seq``), so a flat dense cache, an SSM state and the
hybrid's nested ``{"mamba", "attn"}`` take one rule, and a cache whose
SSM leaves are split where the layer's params are not (or the reverse)
raises ``ValueError`` naming the leaf (``check_state_layout``).
``greedy_generate`` takes ``greedy_generate_reference`` on a mesh, as JAX
routes it; every rank takes the argmax of the same gathered logits, so
the ranks feed the same tokens.  ``jit_prefill_step`` / ``jit_decode_step``
return the eager sharded steps (``.compiled`` None): a gloo collective reads
the host, and NCCL refuses ranks that share one card.

The moe and audio families on a mesh, and a plan with sequence or
context parallelism, pipeline or expert parallelism, ZeRO-3 or layers of
different tp, raise ``NotImplementedError`` naming ``Queue 1 item 4``.  Construct
through ``repro_torch.serving.step_engine``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.strategy import ExecutionPlan
from repro_torch.models.common import abstract_params, tree_map, tree_paths
from repro_torch.obs import fence, span
from repro_torch.parallel import collectives
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.axes import axis_rules
from repro_torch.runtime.compiled import compile_step

_ITEM = "Queue 1 item 4"
#: the families a serving mesh holds (the dense serving passes, the Mamba2
#: state sharded by heads, and both in the hybrid)
MESH_FAMILIES = ("dense", "vlm", "ssm", "hybrid")
#: the logical axes of the SSM state that its layer's params share
_STATE_AXES = ("ssm_heads", "ssm_inner", "ssm_groups")


def check_mesh_serving(model: Any, plan: ExecutionPlan, mesh: Any) -> None:
    """Refuse, naming its Queue 1 item, what a serving mesh does not hold
    yet: the moe and audio families, and a plan with sequence or context
    parallelism, pipeline or expert parallelism, ZeRO-3 or layers of
    different tp; then the trainer's layout checks (a ``ProcessMesh``
    whose axes are the plan's, tp the model axis, a tp that divides the
    SSM heads into whole groups)."""
    from repro_torch.runtime.train import check_layout

    family = model.cfg.family
    if family not in MESH_FAMILIES:
        raise NotImplementedError(f"serving the {family} family on a mesh waits for {_ITEM} "
                                  f"(a serving mesh holds the {', '.join(MESH_FAMILIES[:-1])} "
                                  f"and {MESH_FAMILIES[-1]} families)")
    strategies = [plan.default_strategy, *plan.layer_strategies]
    for what, refused in (
            ("sequence parallelism", any(s.sp for s in strategies)),
            ("context parallelism", any(s.cp > 1 for s in strategies)),
            ("pipeline parallelism", plan.pp > 1),
            ("expert parallelism", any(s.ep > 1 for s in strategies)),
            ("ZeRO-3", any(s.zero >= 3 for s in strategies)),
            ("layers of different tp", len({s.tp for s in strategies}) > 1)):
        if refused:
            raise NotImplementedError(f"a serving mesh under {what} waits for {_ITEM}")
    check_layout(model, plan, mesh)


def _axis_entries(axes_tree: dict, spec_tree: dict):
    """(leaf path, logical axis, mesh axes or None) of every dim of every
    leaf: ``axes_tree``'s logical axes beside ``spec_tree``'s specs."""
    specs = dict(tree_paths(spec_tree))
    for path, axes in tree_paths(axes_tree):
        spec = tuple(specs[path]) + (None,) * (len(axes) - len(specs[path]))
        for ax, entry in zip(axes, spec):
            yield path, ax, entry


def check_state_layout(model: Any, param_specs: dict, cache_specs: dict) -> None:
    """Raise ``ValueError`` naming the cache leaf where a dim of an SSM
    state (logical axes ``ssm_heads``, ``ssm_inner``, ``ssm_groups``) is
    split otherwise than that axis in the layers' params (``param_specs``'
    ``blocks``): a layer computes on its params' shards and would write
    them into a state laid out otherwise."""
    defs = model.param_defs().get("blocks")
    blocks = param_specs.get("blocks")
    if defs is None or blocks is None:
        return
    logical = tree_map(lambda d: d.logical_axes, defs)
    params: dict = {}
    for group in (blocks.values() if shd.is_grouped(blocks) else [blocks]):
        for _, ax, entry in _axis_entries(logical, group):
            if ax in _STATE_AXES:
                params.setdefault(ax, set()).add(entry)
    for path, ax, entry in _axis_entries(model.cache_logical_axes(), cache_specs):
        if ax in params and params[ax] != {entry}:
            raise ValueError(f"cache leaf {'/'.join(path)}: its {ax} dim is split over {entry}, "
                             f"the layers' params over {sorted(map(str, params[ax]))}; a "
                             "serving mesh computes on one layout")


def cache_layout(model: Any, cache_specs: dict) -> tuple:
    """(the mesh axes the cache's rows are split over, those its positions
    are split over), each None where whole: the entries of its leaves'
    ``batch`` and ``seq`` dims (``cache_logical_axes``), one rule for a
    flat or nested cache; an SSM state has no ``seq`` dim."""
    found: dict = {}
    for _, ax, entry in _axis_entries(model.cache_logical_axes(), cache_specs):
        found.setdefault(ax, entry)
    return found.get("batch"), found.get("seq")


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
        self._rules = None
        if self.mesh is None:
            return
        check_mesh_serving(self.model, self.plan, self.mesh)
        if not (self.batch and self.max_len):
            raise ValueError("a serving mesh lays its cache out at the engine's batch and "
                             f"max_len: got batch {self.batch}, max_len {self.max_len}")
        self.param_specs = shd.param_spec_tree(self.model, self.plan, self.mesh, kind="param")
        self._layout()

    def _layout(self) -> None:
        """``cache_specs`` at the engine's batch and max_len, and the
        activation rules the steps run under: the default strategy's, with
        ``cache_seq`` where an attention cache's positions are sharded
        (``cache_layout``)."""
        plan, mesh = self.plan, self.mesh
        self.cache_specs = shd.cache_spec_tree(self.model, plan, mesh, self.batch,
                                               self.max_len)
        check_state_layout(self.model, self.param_specs, self.cache_specs)
        rows, seq = cache_layout(self.model, self.cache_specs)
        rules = shd.act_rules(plan, plan.default_strategy, mesh)
        if seq is not None:
            rules = dataclasses.replace(rules, rules={**rules.rules, "cache_seq": seq})
        self._rules = rules
        self._batch_group = mesh.group(plan.dp_axes_for(plan.default_strategy))
        self._split_rows = rows is not None
        self._tp_group = (mesh.group(plan.tp_axis) if plan.default_strategy.tp > 1
                          else None)

    @classmethod
    def for_plan(cls, model: Any, plan: ExecutionPlan, mesh: Any = None, *, batch: int = 0,
                 max_len: int = 0, dtype: torch.dtype = torch.bfloat16,
                 metrics: Any = None) -> "ServingEngine":
        return cls(model, plan, mesh, batch=batch, max_len=max_len, dtype=dtype,
                   metrics=metrics)

    def abstract_params(self) -> dict:
        """The serving params' shapes on the ``meta`` device: floating
        leaves in bf16 (no fp32 masters at inference, as JAX's), this rank's
        ``param_specs`` shards on a mesh."""
        tree = abstract_params(self.model.param_defs(), torch.bfloat16)
        if self.mesh is None:
            return tree
        return shd.place_params(tree, self.param_specs, self.mesh)

    # ------------------------------------------------------------ mesh
    def place_params(self, canonical: dict) -> dict:
        """This rank's shards (``param_specs``) of a canonical tree, on the
        mesh's device; the tree itself off a mesh."""
        if self.mesh is None:
            return canonical
        return tree_map(lambda x: x.to(self.mesh.device),
                        shd.place_params(canonical, self.param_specs, self.mesh))

    def gather_cache(self, local: dict) -> dict:
        """The canonical cache from every rank's shard (``cache_specs``), as
        new tensors: every rank takes part and holds it whole."""
        if self.mesh is None:
            return local

        def whole(x, spec):
            out = shd.unshard_leaf(x, spec, self.mesh)
            return out.clone() if out is x else out

        return tree_map(whole, local, self.cache_specs)

    def _rows(self, x):
        """This rank's batch rows of a global array (on the mesh's device):
        its shard over the batch axes, or every row where the batch does not
        divide."""
        x = torch.as_tensor(x).to(self.mesh.device)
        if x.shape[0] != self.batch:
            raise ValueError(f"the engine serves a batch of {self.batch}, got "
                             f"{x.shape[0]} rows")
        return collectives.take_shard(x, 0, self._batch_group) if self._split_rows else x

    def _global_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """This rank's (rows, vocab columns) of the logits -> the global
        fp32 logits, the same on every rank."""
        if logits.shape[-1] < self.model.cfg.vocab_size:
            logits = collectives.all_gather(logits, logits.dim() - 1, self._tp_group)
        if self._split_rows:
            logits = collectives.all_gather(logits, 0, self._batch_group)
        return logits

    # ------------------------------------------------------------ steps
    def prefill_step(self, params, tokens, extras=None):
        """``extras``: an optional dict of side inputs to ``forward_prefill``
        (``frames`` of the encoder-decoder, ``vis_embeds`` of the VLM), as
        in JAX."""
        if self.mesh is None:
            return self.model.forward_prefill(params, tokens, max_len=self.max_len or None,
                                              dtype=self.dtype, **(extras or {}))
        tokens = self._rows(tokens)
        extras = {k: self._rows(v) for k, v in (extras or {}).items()}
        with axis_rules(self._rules):
            logits, cache = self.model.forward_prefill(params, tokens, max_len=self.max_len,
                                                       dtype=self.dtype, **extras)
            return self._global_logits(logits), cache

    def decode_step(self, params, tokens, cache, cache_index, kv_len=None):
        if self.mesh is None:
            return self.model.forward_decode(params, tokens, cache, cache_index, kv_len=kv_len,
                                             dtype=self.dtype)
        tokens = self._rows(tokens)
        if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
            cache_index = self._rows(cache_index)
        elif isinstance(cache_index, torch.Tensor):
            cache_index = cache_index.to(self.mesh.device)
        if kv_len is not None:
            kv_len = self._rows(kv_len)
        with axis_rules(self._rules):
            logits, cache = self.model.forward_decode(params, tokens, cache, cache_index,
                                                      kv_len=kv_len, dtype=self.dtype)
            return self._global_logits(logits), cache

    # ------------------------------------------------------------ jit
    def _compiled_device(self) -> torch.device:
        """The device of the compiled steps; the graphs of this engine share
        one pool."""
        device = self.model.device
        if device.type == "cuda" and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return device

    @staticmethod
    def _eager(step):
        """A mesh's "compiled" step: the eager sharded step itself, with no
        graph (``.compiled`` None; see the module note)."""

        def run(*args, **kwargs):
            return step(*args, **kwargs)

        run.compiled = None
        return run

    def jit_decode_step(self, donate: bool = True):
        """``decode_step`` compiled: ``(params, tokens, cache, cache_index,
        kv_len=None) -> (logits, cache)``.  ``cache_index`` and ``kv_len``
        may be ints (turned into tensors on the host, fed to the graph) or
        tensors.  ``donate=True`` writes ``cache`` in place, as JAX donates
        it: the returned cache is the graph's buffers (the first call's cache
        itself) and its logits the graph's static output, valid until the
        next call; pass the returned cache back.  ``donate=False`` copies the
        cache in and returns clones, leaving the argument as it was."""
        if self.mesh is not None:
            return self._eager(self.decode_step)
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
        if self.mesh is not None:
            return self._eager(self.prefill_step)
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
        model off a mesh goes through the paged scheduler, every other model
        and every mesh through :meth:`greedy_generate_reference`."""
        if self.mesh is not None or self.model.cfg.family != "dense":
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
        device = self.model.device if self.mesh is None else self.mesh.device
        tokens = torch.as_tensor(prompt_tokens).to(device, torch.long)
        B, S = tokens.shape
        self.max_len = max_len
        if self.mesh is not None:           # the cache laid out at this batch and max_len
            self.batch = B
            self._layout()
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
