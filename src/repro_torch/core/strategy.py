"""Strategy & plan dataclasses — the contract between Galvatron's search
engine and the parallel runtime.

A :class:`LayerStrategy` is the per-layer decision the paper's DP algorithm
makes: tensor-parallel degree, sequence parallelism, ZeRO stage, expert
parallelism and recomputation.  An :class:`ExecutionPlan` bundles the global
decisions (pipeline degree, gradient-accumulation count, mesh) with the
per-layer list and is what ``construct_hybrid_parallel_model`` consumes.

The port's copy of ``repro.core.strategy``, whole and unchanged (pure
Python), so plans serialise identically in both packages.  The port's step
engine takes a plan; the parallel runtime that reads its strategies is a
later slice.
"""
from __future__ import annotations

import dataclasses
import json

REMAT_POLICIES = ("none", "selective", "full")

#: Pipeline schedules the runtime implements (see parallel/pipeline.py).
#: "gpipe"       — all-forward-then-all-backward; every one of the step's
#:                 M = max(grad_accum, pp) microbatch activations is live at
#:                 peak on a stage.
#: "1f1b"        — one-forward-one-backward steady state; at most min(pp, M)
#:                 microbatch activations live per stage, same bubble as GPipe.
#: "interleaved" — 1F1B over pp_interleave virtual stages per physical stage;
#:                 bubble shrinks by 1/v at the cost of a pp·(1+(v-1)/v)
#:                 warm-up in-flight term and v× more p2p hops.
PP_SCHEDULES = ("gpipe", "1f1b", "interleaved")


@dataclasses.dataclass(frozen=True, order=True)
class LayerStrategy:
    """Per-layer hybrid-parallel decision (one node of the decision tree).

    ``tp`` is the tensor-parallel degree over the "model" mesh axis; ``dp`` is
    implied by the mesh (devices / (tp·cp·pp)).  ``zero`` applies to the
    layer's parameters/grads/optimizer state over the DP axes (plus the cp
    axis — cp replicates parameters).  ``sp`` toggles Megatron-style sequence
    parallelism at block boundaries (requires tp>1).  ``cp`` is the
    context-parallel degree over the "cp" mesh axis: the sequence is sharded
    *through* attention and k/v blocks ring-rotate (parallel/context.py);
    realizable only when cp divides the heads-free sequence into 2·cp zig-zag
    chunks (``validate_cp``).  ``ep`` shards MoE experts over the "data"
    axis.  ``remat`` is the recomputation level — the paper treats it as an
    extra parallelism dimension, and so do we.
    """

    tp: int = 1
    sp: bool = False
    zero: int = 1          # 0 | 1 | 2 | 3
    remat: str = "none"    # none | selective | full
    ep: int = 1
    cp: int = 1            # context-parallel (ring attention) degree

    def __post_init__(self):
        if self.remat not in REMAT_POLICIES:
            raise ValueError(f"bad remat {self.remat!r}")
        if self.sp and self.tp == 1:
            raise ValueError("sequence parallelism requires tp > 1")
        if self.zero not in (0, 1, 2, 3):
            raise ValueError(f"bad zero stage {self.zero}")
        if self.cp < 1:
            raise ValueError(f"bad cp degree {self.cp}")

    def short(self) -> str:
        return (f"tp{self.tp}{'-sp' if self.sp else ''}"
                f"{f'-cp{self.cp}' if self.cp > 1 else ''}-z{self.zero}"
                f"{f'-ep{self.ep}' if self.ep > 1 else ''}"
                f"{'' if self.remat == 'none' else '-' + self.remat}")


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """A contiguous run of layers sharing one strategy (one scan chain)."""

    start: int
    stop: int
    strategy: LayerStrategy

    @property
    def size(self) -> int:
        return self.stop - self.start


@dataclasses.dataclass
class ExecutionPlan:
    """Everything the runtime needs to build the hybrid-parallel step fn."""

    arch: str
    shape: str                       # shape id (train_4k, ...)
    mesh_axes: tuple[str, ...]       # e.g. ("pod", "data", "model")
    mesh_shape: tuple[int, ...]
    pp: int = 1                      # pipeline stages (over "pod" when multi-pod)
    pp_schedule: str = "gpipe"       # gpipe | 1f1b | interleaved (PP_SCHEDULES)
    pp_interleave: int = 1           # virtual stages per physical stage (>1 => interleaved)
    grad_accum: int = 1              # microbatches per step
    layer_strategies: list[LayerStrategy] = dataclasses.field(default_factory=list)
    default_strategy: LayerStrategy = dataclasses.field(default_factory=LayerStrategy)
    predicted_step_time: float = 0.0   # seconds, from the cost model
    predicted_memory: float = 0.0      # bytes per device, from the memory model
    notes: str = ""

    def __post_init__(self):
        if self.pp_schedule not in PP_SCHEDULES:
            raise ValueError(f"bad pp_schedule {self.pp_schedule!r}")
        if self.pp_interleave < 1:
            raise ValueError(f"bad pp_interleave {self.pp_interleave}")
        if self.pp_schedule == "interleaved" and self.pp_interleave < 2:
            raise ValueError("interleaved schedule requires pp_interleave >= 2")
        if self.pp_schedule != "interleaved" and self.pp_interleave != 1:
            raise ValueError("pp_interleave > 1 requires pp_schedule='interleaved'")

    # ------------------------------------------------------------ helpers
    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.mesh_shape:
            n *= s
        return n

    @property
    def dp_axes(self) -> tuple[str, ...]:
        """Mesh axes carrying data parallelism (pod folds into DP unless PP>1)."""
        if self.pp > 1:
            return tuple(a for a in self.mesh_axes if a in ("data",))
        return tuple(a for a in self.mesh_axes if a in ("pod", "data"))

    def dp_axes_for(self, strategy: "LayerStrategy") -> tuple[str, ...]:
        """DP axes for one layer strategy: when the layer does not use TP the
        model axis is absorbed into DP (dp = devices / tp), so a tp=1 layer
        shards its batch/ZeRO over pod×data×model — otherwise 15/16ths of the
        mesh would sit idle for that layer.  The cp axis is absorbed the same
        way for cp=1 layers; a cp>1 layer's cp axis carries sequence shards,
        never batch."""
        axes = self.dp_axes
        if strategy.cp == 1 and "cp" in self.mesh_axes:
            axes = axes + ("cp",)
        if strategy.tp == 1 and "model" in self.mesh_axes:
            axes = axes + ("model",)
        return axes

    def state_axes_for(self, strategy: "LayerStrategy") -> tuple[str, ...]:
        """Axes carrying ZeRO parameter/grad/optimizer-state sharding.
        Context parallelism replicates parameters over the cp axis (only
        activations are seq-sharded), so ZeRO may shard states there even
        though the batch cannot — the state-sharding group is dp·cp wide."""
        axes = self.dp_axes_for(strategy)
        if strategy.cp > 1 and "cp" in self.mesh_axes and "cp" not in axes:
            axes = axes + ("cp",)
        return axes

    @property
    def tp_axis(self) -> str:
        return "model"

    @property
    def cp_axis(self) -> str:
        return "cp"

    def groups(self) -> list[GroupSpec]:
        """Contiguous equal-strategy runs (each becomes one lax.scan chain)."""
        if not self.layer_strategies:
            return []
        out: list[GroupSpec] = []
        start = 0
        cur = self.layer_strategies[0]
        for i, s in enumerate(self.layer_strategies[1:], 1):
            if s != cur:
                out.append(GroupSpec(start, i, cur))
                start, cur = i, s
        out.append(GroupSpec(start, len(self.layer_strategies), cur))
        return out

    def uniform(self) -> bool:
        return len({s for s in self.layer_strategies}) <= 1

    # ------------------------------------------------------------ serialization
    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=2, default=list)

    @staticmethod
    def from_json(text: str) -> "ExecutionPlan":
        d = json.loads(text)
        d["layer_strategies"] = [LayerStrategy(**s) for s in d["layer_strategies"]]
        d["default_strategy"] = LayerStrategy(**d["default_strategy"])
        d["mesh_axes"] = tuple(d["mesh_axes"])
        d["mesh_shape"] = tuple(d["mesh_shape"])
        return ExecutionPlan(**d)


def uniform_plan(arch: str, shape: str, mesh_shape, mesh_axes, num_layers: int,
                 strategy: LayerStrategy, *, pp: int = 1, grad_accum: int = 1,
                 pp_schedule: str = "gpipe", pp_interleave: int = 1,
                 notes: str = "") -> ExecutionPlan:
    return ExecutionPlan(
        arch=arch, shape=shape, mesh_axes=tuple(mesh_axes), mesh_shape=tuple(mesh_shape),
        pp=pp, pp_schedule=pp_schedule, pp_interleave=pp_interleave,
        grad_accum=grad_accum,
        layer_strategies=[strategy] * num_layers,
        default_strategy=strategy, notes=notes,
    )
