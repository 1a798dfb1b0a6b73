"""Training meshes over ``torch.distributed`` (the port of
``repro.launch.mesh``).

A :class:`ProcessMesh` lays the ranks of the initialised default process
group out row-major over named axes, as JAX lays devices out, and holds one
process group for every set of its axes that a rule can name: each axis
alone and every combination of them (the dp axes of a tp = 1 layer absorb
the model axis, so one group may span several axes).  Every rank creates
every group with ``torch.distributed.new_group``, in one fixed order.

``make_production_mesh`` (single pod: (data 16, model 16); multi-pod: (pod
2, data 16, model 16)) raises unless that many ranks exist.
``train_mesh_spec`` is JAX's, copied.  The backend follows the device: NCCL
for CUDA, gloo for the CPU; ``backend=`` exists so that ranks sharing one
card (which NCCL refuses) can ask for gloo.  Device subsets (elastic
resize) wait for Queue 1 item 6.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.parallel.axes import MeshShape


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The process group of one set of mesh axes that holds this rank:
    ``size`` ranks, this rank at ``index`` (its shard index over those axes,
    the first axis major).  ``pg`` is None for a group of one."""

    axes: tuple
    size: int
    index: int
    pg: Optional[object] = None


class ProcessMesh(MeshShape):
    """A mesh of ranks; see the module note.  ``device`` is this rank's
    torch device."""

    def __init__(self, shape, axes, *, device, backend: Optional[str] = None):
        super().__init__(tuple(axes), tuple(int(s) for s in shape))
        if not dist.is_initialized():
            raise RuntimeError("a ProcessMesh needs the default process group: call "
                               "torch.distributed.init_process_group first")
        world, rank = dist.get_world_size(), dist.get_rank()
        if self.size != world:
            raise ValueError(f"mesh {dict(self.shape)} holds {self.size} ranks; the "
                             f"process group has {world}")
        device = torch.device(device)
        object.__setattr__(self, "device", device)
        object.__setattr__(self, "rank", rank)
        object.__setattr__(self, "backend",
                           backend or ("nccl" if device.type == "cuda" else "gloo"))
        coords = self.coords_of(rank)
        object.__setattr__(self, "coords", dict(zip(self.axis_names, coords)))
        groups = {(): AxisGroup((), 1, 0)}
        n = len(self.axis_names)
        for k in range(1, n + 1):
            for sub in itertools.combinations(range(n), k):
                groups[tuple(self.axis_names[i] for i in sub)] = self._new_group(sub, coords)
        object.__setattr__(self, "_groups", groups)
        object.__setattr__(self, "_hops", {})

    def coords_of(self, rank: int) -> tuple:
        out = []
        for s in reversed(self.sizes):
            out.append(rank % s)
            rank //= s
        return tuple(reversed(out))

    def rank_of(self, coords) -> int:
        r = 0
        for c, s in zip(coords, self.sizes):
            r = r * s + c
        return r

    def _new_group(self, sub: tuple, coords: tuple) -> AxisGroup:
        """Every rank creates every group over the axes ``sub`` (one per
        coordinate of the other axes, in order) and keeps its own."""
        axes = tuple(self.axis_names[i] for i in sub)
        size = 1
        for i in sub:
            size *= self.sizes[i]
        index = 0
        for i in sub:
            index = index * self.sizes[i] + coords[i]
        if size == 1:
            return AxisGroup(axes, 1, 0)
        rest = [i for i in range(len(self.sizes)) if i not in sub]
        mine = None
        for other in itertools.product(*(range(self.sizes[i]) for i in rest)):
            ranks = []
            for inner in itertools.product(*(range(self.sizes[i]) for i in sub)):
                c = [0] * len(self.sizes)
                for i, v in zip(rest, other):
                    c[i] = v
                for i, v in zip(sub, inner):
                    c[i] = v
                ranks.append(self.rank_of(c))
            pg = dist.new_group(ranks, backend=self.backend)
            if self.rank in ranks:
                mine = pg
        return AxisGroup(axes, size, index, mine)

    def group(self, axes) -> AxisGroup:
        """The group of ``axes`` (a name or a tuple of distinct names) that
        holds this rank.  Its ranks and this rank's index follow mesh order
        whatever order ``axes`` names them in: ZeRO under context
        parallelism shards states over ``("data", "cp")`` on a mesh that
        puts ``cp`` first, and its shards and gathers use the one group."""
        axes = axes if isinstance(axes, tuple) else (axes,)
        key = tuple(a for a in self.axis_names if a in axes)
        if len(set(axes)) != len(axes) or len(key) != len(axes):
            raise KeyError(f"no group over {axes}: the axes must be distinct axes of "
                           f"{self.axis_names}")
        return self._groups[key]

    def hop(self, axis: str):
        """The point-to-point hop over ``axis``
        (``parallel.collectives.StageHop``), made on first use and kept:
        its pinned host buffers serve every later call."""
        if axis not in self._hops:
            from repro_torch.parallel.collectives import StageHop

            self._hops[axis] = StageHop(self, axis)
        return self._hops[axis]

    def __repr__(self) -> str:
        return (f"ProcessMesh({dict(self.shape)}, rank {self.rank}, {self.device}, "
                f"{self.backend})")


def make_mesh(shape, axes, *, device=None, backend: Optional[str] = None) -> ProcessMesh:
    """A mesh of the given shape over the default process group; ``device``
    defaults to card ``rank % device_count()``, or the CPU without one."""
    if device is None:
        if torch.cuda.is_available():
            device = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        else:
            device = torch.device("cpu")
    return ProcessMesh(shape, axes, device=device, backend=backend)


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         backend: Optional[str] = None) -> ProcessMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device, backend=backend)


def train_mesh_spec(n_devices: int, *, pp: int = 1, cp: int = 1) -> tuple[tuple, tuple]:
    """(shape, axes) for a training mesh with optional pipeline and
    context-parallel axes.  Raises when pp·cp does not tile the devices."""
    if pp < 1 or cp < 1:
        raise ValueError(f"pp/cp must be >= 1, got pp={pp}, cp={cp}")
    if n_devices % (pp * cp) != 0:
        raise ValueError(f"pp={pp} x cp={cp} does not tile {n_devices} devices")
    rest = n_devices // (pp * cp)
    inner = (rest // 2, 2) if rest % 2 == 0 else (rest, 1)
    shape: tuple = inner
    axes: tuple = ("data", "model")
    if cp > 1:
        shape, axes = (cp,) + shape, ("cp",) + axes
    if pp > 1:
        shape, axes = (pp,) + shape, ("pod",) + axes
    return shape, axes


def make_train_mesh(n_devices: int, *, pp: int = 1, cp: int = 1, device=None,
                    backend: Optional[str] = None) -> ProcessMesh:
    shape, axes = train_mesh_spec(n_devices, pp=pp, cp=cp)
    return make_mesh(shape, axes, device=device, backend=backend)
