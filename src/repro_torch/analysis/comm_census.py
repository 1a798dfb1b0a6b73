"""Collective census of a step: the counterpart of ``repro.analysis.hlo_stats``.

JAX parses the partitioned HLO of its compiled step.  The port has no
compiled program: its step issues ``torch.distributed`` collectives
eagerly, so :class:`CommCensus` is a ``TorchDispatchMode`` that records
every c10d op the step dispatches, on real tensors (a step that runs) or on
fake ones (a traced step: ``analysis/step_trace.py``).  Each op is filed
under a JAX collective kind:

================================================  ======================
c10d op                                           kind
================================================  ======================
``allreduce_``                                    ``all-reduce``
``_allgather_base_``, ``allgather_into_tensor_    ``all-gather``
coalesced_``
``_reduce_scatter_base_``, ``reduce_scatter_      ``reduce-scatter``
tensor_coalesced_``
``alltoall_base_``                                ``all-to-all``
``send`` (of ``batch_isend_irecv``)               ``collective-permute``
================================================  ======================

Bytes follow ``hlo_stats``' operand convention: an all-gather charges the
per-device shard it sends, a reduce-scatter the full pre-scatter array,
every other op its operand; a point-to-point hop counts its sent bytes once
(the receive adds nothing), so ``StageHop``'s pinned host staging under
gloo on CUDA counts each hop once too.

Each op is labelled with the mesh axes it spans, in mesh order joined by
``+``, as ``hlo_stats.axis_census`` labels them: the axes of its process
group (``ProcessMesh`` knows which group belongs to which axes) whose size
exceeds one; for a send, the axes on which this rank's and the peer's
coordinates differ; ``"none"`` for a send to itself, ``"other"`` for a
group the mesh does not hold.

An eager step is not a program with loops: every op is counted each time it
runs, so no trip count is ever unknown, ``unresolved_loops`` is always 0,
and the port's audit never emits GALV094.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

#: c10d op name -> (kind, the argument holding the counted tensor(s), the
#: argument holding the process group)
_OPS = {
    "allreduce_": ("all-reduce", 0, 1),
    "_allgather_base_": ("all-gather", 1, 2),
    "allgather_into_tensor_coalesced_": ("all-gather", 1, 2),
    "_reduce_scatter_base_": ("reduce-scatter", 1, 2),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, 2),
    "alltoall_base_": ("all-to-all", 1, 2),
    "send": ("collective-permute", 0, 1),
}


def _nbytes(x) -> int:
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return x.numel() * x.element_size()


def _unbox(pg):
    """The ``ProcessGroup`` of a dispatched op's group argument."""
    if isinstance(pg, dist.ProcessGroup):
        return pg
    return dist.ProcessGroup.unbox(pg)


def group_labels(mesh) -> dict:
    """{id(process group): axis label} of every group ``mesh`` (a
    ``launch.mesh.ProcessMesh``) holds for this rank, and the world's."""
    labels = {}
    for axes in _axis_sets(mesh):
        group = mesh.group(axes)
        if group.pg is not None:
            labels[id(group.pg)] = _label(mesh, group.axes)
    if dist.is_initialized():
        labels.setdefault(id(dist.group.WORLD), _label(mesh, tuple(mesh.axis_names)))
    return labels


def _axis_sets(mesh) -> list:
    names = tuple(mesh.axis_names)
    return [tuple(a for i, a in enumerate(names) if mask >> i & 1)
            for mask in range(1, 1 << len(names))]


def _label(mesh, axes) -> str:
    return "+".join(a for a in mesh.axis_names if a in axes and mesh.shape[a] > 1) or "none"


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    counts_by_kind: dict
    unresolved_loops: int = 0

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))

    def merged(self) -> dict:
        return {"collective_bytes": self.total_bytes,
                **{f"{k}_bytes": v for k, v in sorted(self.bytes_by_kind.items())},
                **{f"{k}_count": v for k, v in sorted(self.counts_by_kind.items())},
                "unresolved_loops": self.unresolved_loops}


@dataclasses.dataclass
class AxisCensus:
    """Per-(mesh-axis-label, kind) collective traffic of one step, JAX's
    fields: ``entries`` maps ``(axis_label, kind) -> (bytes, count)``."""

    entries: dict
    unresolved_loops: int = 0
    mesh_axes: tuple = ()

    def bytes_on(self, axis_label: str, kind: str | None = None) -> float:
        return float(sum(b for (ax, k), (b, _) in self.entries.items()
                         if ax == axis_label and (kind is None or k == kind)))

    def bytes_touching(self, axis_name: str, kind: str | None = None) -> float:
        """Traffic on every label that includes ``axis_name``."""
        return float(sum(
            b for (ax, k), (b, _) in self.entries.items()
            if axis_name in ax.split("+") and (kind is None or k == kind)))

    @property
    def total_bytes(self) -> float:
        return float(sum(b for b, _ in self.entries.values()))

    def labels(self) -> list:
        return sorted({ax for ax, _ in self.entries})

    def rows(self) -> list:
        """(axis_label, kind, bytes, count) sorted rows for rendering."""
        return [(ax, k, b, c) for (ax, k), (b, c) in sorted(self.entries.items())]


class CommCensus(TorchDispatchMode):
    """Record every collective dispatched inside the block (see the module
    note); ``records`` holds ``(axis_label, kind, bytes)`` in order.
    ``mesh`` is the step's ``ProcessMesh`` (None: every op is ``"other"``)."""

    def __init__(self, mesh=None):
        super().__init__()
        self.mesh = mesh
        self._labels = group_labels(mesh) if mesh is not None and mesh.member else {}
        self.records: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            self._record(func._opname if hasattr(func, "_opname") else func.__name__,
                         args)
        return func(*args, **kwargs)

    def _record(self, name: str, args) -> None:
        name = name.split(".")[0]
        if name not in _OPS:
            return
        kind, at, pg_at = _OPS[name]
        pg = _unbox(args[pg_at])
        if kind == "collective-permute":
            label = self._peer_label(pg, int(args[2]))
        else:
            label = self._labels.get(id(pg), "other")
        self.records.append((label, kind, _nbytes(args[at])))

    def _peer_label(self, pg, peer: int) -> str:
        mesh = self.mesh
        if mesh is None or not mesh.member:
            return "other"
        peer = dist.get_global_rank(pg, peer) if pg is not dist.group.WORLD else peer
        if not 0 <= peer < mesh.size:
            return "other"
        mine, theirs = mesh.coords_of(mesh.rank), mesh.coords_of(peer)
        return "+".join(a for a, x, y in zip(mesh.axis_names, mine, theirs) if x != y) \
            or "none"

    # ------------------------------------------------------------ results
    def stats(self) -> CollectiveStats:
        nbytes: dict = defaultdict(float)
        counts: dict = defaultdict(float)
        for _, kind, b in self.records:
            nbytes[kind] += b
            counts[kind] += 1
        return CollectiveStats(dict(nbytes), dict(counts))

    def axis_census(self) -> AxisCensus:
        entries: dict = defaultdict(lambda: [0.0, 0.0])
        for label, kind, b in self.records:
            cell = entries[(label, kind)]
            cell[0] += b
            cell[1] += 1
        axes = tuple(self.mesh.axis_names) if self.mesh is not None else ()
        return AxisCensus({k: (b, c) for k, (b, c) in entries.items()}, 0, axes)
