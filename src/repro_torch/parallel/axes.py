"""Logical-axis -> mesh-axis rules (the port of ``repro.parallel.axes``).

Models never name mesh axes: parameters carry logical axes in their
:class:`~repro_torch.models.common.ParamDef`, and the runtime activates a
:class:`MeshRules` per layer group, derived from the group's
``LayerStrategy``.  A spec is a tuple with one entry per dim: ``None``
(replicated), a mesh-axis name, or a tuple of names (sharded over their
product, the first one major) — JAX's ``PartitionSpec`` as a plain tuple.
The rules drop trailing ``None`` entries, as JAX's do.

The rules need only a mesh's axis names and sizes (:class:`MeshShape`), as
JAX derives them on an ``AbstractMesh``; the process groups that carry them
out live on ``launch.mesh.ProcessMesh``, a ``MeshShape`` too.  Where JAX
hands the specs to GSPMD, the port holds local shards as plain tensors
(``parallel.sharding.place_params``) and moves activations with the region
operators of ``parallel.collectives``.

``lc(x, *axes)`` is a no-op outside a mesh, as in JAX.  Inside one it takes
this rank's sequence shard of a value replicated over the model axis when
the rules put ``seq`` there (sequence parallelism); every other dim is
already laid out: the batch by the runtime's data split, heads and ff by
the shard shapes of the weights.  Under context parallelism the runtime
has already handed each rank its zig-zag shard of the sequence, so ``lc``
splits that shard over the model axis alone; ``ring_context`` tells
attention to run the ring over the ``cp`` process group
(``parallel.context``).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Optional, Sequence

_CTX = threading.local()

Spec = tuple          # e.g. (None, "model") or (("data", "model"),)


def P(*entries) -> Spec:
    """A spec from its entries (JAX's ``PartitionSpec(...)`` as a tuple)."""
    return tuple(entries)


def _trimmed(out: list) -> Spec:
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no process behind it (JAX's
    ``AbstractMesh``)."""

    axis_names: tuple
    sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} vs shape {self.sizes}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def abstract_mesh(shape, axes) -> MeshShape:
    return MeshShape(tuple(axes), tuple(int(s) for s in shape))


def _targets(target) -> tuple:
    return target if isinstance(target, tuple) else (target,)


@dataclass(frozen=True)
class MeshRules:
    """Mapping from logical axis names to mesh axis names (or None).

    ``ring`` names the mesh axis carrying context parallelism for the
    active layer group, as in JAX.  ``seq_len`` is the port's addition: the
    global sequence length of the microbatch being run, which the runtime
    sets under context parallelism (a rank holds S / cp of it)."""

    rules: dict = field(default_factory=dict)
    mesh: Optional[MeshShape] = None
    ring: Optional[str] = None
    seq_len: Optional[int] = None

    def spec(self, logical_axes: Sequence[str | None]) -> Spec:
        used: set[str] = set()
        out = []
        for ax in logical_axes:
            target = self.rules.get(ax) if ax is not None else None
            if target is None:
                out.append(None)
                continue
            # A mesh axis may appear at most once in a spec; on conflict the
            # later logical axis stays unsharded.
            fresh = tuple(t for t in _targets(target) if t not in used)
            if not fresh:
                out.append(None)
                continue
            used.update(fresh)
            out.append(fresh if len(fresh) > 1 else fresh[0])
        return _trimmed(out)

    def axis_size(self, logical: str) -> int:
        """Total shard count the rules assign to a logical axis (1 if unsharded)."""
        target = self.rules.get(logical)
        if target is None or self.mesh is None:
            return 1
        n = 1
        for t in _targets(target):
            n *= self.mesh.shape[t]
        return n

    def spec_for_shape(self, logical_axes: Sequence[str | None],
                       shape: Sequence[int]) -> Spec:
        """Like ``spec`` but drops any mapping whose mesh-axis product does not
        divide the dim size: that dim stays whole on every rank."""
        used: set[str] = set()
        out = []
        for ax, dim in zip(logical_axes, shape):
            target = self.rules.get(ax) if ax is not None else None
            if target is None:
                out.append(None)
                continue
            fresh = tuple(t for t in _targets(target) if t not in used)
            if not fresh:
                out.append(None)
                continue
            if self.mesh is not None:
                n = 1
                for t in fresh:
                    n *= self.mesh.shape[t]
                if n == 0 or dim % n != 0:
                    out.append(None)
                    continue
            used.update(fresh)
            out.append(fresh if len(fresh) > 1 else fresh[0])
        return _trimmed(out)


@contextlib.contextmanager
def axis_rules(rules: Optional[MeshRules]):
    prev = getattr(_CTX, "rules", None)
    _CTX.rules = rules
    try:
        yield
    finally:
        _CTX.rules = prev


def current_rules() -> Optional[MeshRules]:
    return getattr(_CTX, "rules", None)


@dataclass(frozen=True)
class RingContext:
    """An active context-parallelism site: attention runs as a ring over the
    ``cp`` sequence shards of ``group`` (``parallel.context``), this rank
    its ``index``, the microbatch ``seq_len`` tokens long in all; ``hop``
    is the ring's point-to-point hop over the same ranks."""

    group: object          # launch.mesh.AxisGroup of the ring's axis
    hop: object            # parallel.collectives.StageHop over that axis
    index: int
    cp: int
    seq_len: int


def ring_context() -> Optional[RingContext]:
    """The ring of the active rules, or None: no rules, rules with no ring
    axis, an abstract mesh (no process groups) or a ring of one rank.  The
    runtime sets the rules' ``seq_len`` wherever it sets a ring."""
    rules = current_rules()
    if rules is None or not rules.ring or not hasattr(rules.mesh, "group"):
        return None
    group = rules.mesh.group(rules.ring)
    if group.size == 1:
        return None
    if rules.seq_len is None:
        raise RuntimeError(f"rules with a ring over {rules.ring!r} carry no seq_len: the "
                           "runtime sets the microbatch's global sequence length")
    return RingContext(group, rules.mesh.hop(rules.ring), group.index, group.size,
                       rules.seq_len)


def lc(x, *logical_axes: str | None):
    """Logical layout constraint on an activation that every rank of the
    model axis holds whole (see the module note): a no-op outside a mesh
    and without sequence parallelism; under it, this rank's shard of the
    ``seq`` dim, whose backward all-gathers the grad."""
    from repro_torch.parallel import collectives

    tp = collectives.tp_state()
    if tp is None or not tp.sp or "seq" not in logical_axes:
        return x
    return collectives.split(x, logical_axes.index("seq"), tp.group)
