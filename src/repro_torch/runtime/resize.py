"""Live elastic resize: state migration onto a replanned mesh (the port of
``repro.runtime.resize``).

``runtime/elastic.py`` re-searches the (pp × cp × schedule × strategy)
space for the surviving device count; this module moves the live training
state onto the new plan without a restart:

1. **Canonicalize** — ``checkpoint_state`` on the old mesh: every rank of
   it takes part in the gathers and holds the canonical (ungrouped,
   unstaged) params and AdamW ``m`` / ``v``, the trees checkpoints store.
2. **Share** — on a grow, a rank that joins holds no state: it receives the
   canonical trees by broadcast from rank 0 over the new mesh's group, into
   templates made from the model's parameter definitions (no host read).
3. **Re-layout** — the new trainer's ``place_params`` / ``place_opt_state``
   cut this rank's shards (regrouping or restaging for the new plan).  A
   rank outside the new mesh keeps nothing.
4. **Carry** — :class:`CarryState` moves the step counter, the data cursor
   and the host ``torch.Generator`` state across the swap, so training
   resumes at the step it stopped at.

Meshes are prefixes of the world's ranks (``launch.mesh.make_mesh(...,
ranks=n)``), so on a shrink every new member was an old one and on a grow
every old member is a new one; rank 0 is in both.  ``make_trainer`` gives a
rank outside its plan's mesh an :class:`OutsideMesh`, which holds the plan
and no state, so every rank calls ``migrate`` with the same two plans.

:func:`migrate_via_checkpoint` is the checkpoint round trip (rank 0 writes,
every rank of the new mesh reads, as the launcher's resume does): the path
for a real membership loss and the equivalence oracle the in-memory path is
held to — both give bitwise the same state on every rank.

``migrate`` consumes the old state: what it returns may share storage with
it (every leaf on one device, the step counter on a mesh), so a donated
step on the result writes through to the old trees.
"""
from __future__ import annotations

import dataclasses
import pathlib
import tempfile
import time
from typing import Any, Optional

import torch

from repro_torch.core.strategy import ExecutionPlan
from repro_torch.models.common import tree_map
from repro_torch.obs import span
from repro_torch.runtime import checkpoint as ckpt_lib
from repro_torch.runtime.optimizer import AdamWState
from repro_torch.runtime.train import construct_hybrid_parallel_model
from repro_torch.runtime.train_pp import PipelineTrainer


# --------------------------------------------------------------------------
# plan diff
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MigrationSpec:
    """Diff between two :class:`ExecutionPlan`s: which mesh axes resize,
    which parallelism degrees change, and whether the parameter layout
    (layer groups / pipeline stages) must be rebuilt rather than resharded."""

    old_mesh: tuple[tuple[int, ...], tuple[str, ...]]
    new_mesh: tuple[tuple[int, ...], tuple[str, ...]]
    axis_resize: dict[str, tuple[int, int]]   # axis -> (old, new), changed only
    tp: tuple[int, int]
    cp: tuple[int, int]
    pp: tuple[int, int]
    schedule: tuple[str, str]
    grad_accum: tuple[int, int]
    restage: bool      # pipeline stage layout differs (stage/unstage needed)
    regroup: bool      # layer-group boundaries or strategies differ

    @property
    def mesh_changed(self) -> bool:
        return self.old_mesh != self.new_mesh

    @property
    def devices(self) -> tuple[int, int]:
        old = 1
        for s in self.old_mesh[0]:
            old *= s
        new = 1
        for s in self.new_mesh[0]:
            new *= s
        return old, new

    def summary(self) -> str:
        o, n = self.devices
        bits = [f"{o}->{n} devices"]
        for axis, (a, b) in sorted(self.axis_resize.items()):
            bits.append(f"{axis} {a}->{b}")
        if self.tp[0] != self.tp[1]:
            bits.append(f"tp {self.tp[0]}->{self.tp[1]}")
        if self.cp[0] != self.cp[1]:
            bits.append(f"cp {self.cp[0]}->{self.cp[1]}")
        if self.restage:
            bits.append(f"pp {self.pp[0]}/{self.schedule[0]}"
                        f"->{self.pp[1]}/{self.schedule[1]} (restage)")
        if self.regroup:
            bits.append("regroup")
        if self.grad_accum[0] != self.grad_accum[1]:
            bits.append(f"ga {self.grad_accum[0]}->{self.grad_accum[1]}")
        return ", ".join(bits)


def _group_key(plan: ExecutionPlan) -> tuple:
    return tuple((g.start, g.stop, g.strategy) for g in plan.groups())


def diff_plans(old: ExecutionPlan, new: ExecutionPlan) -> MigrationSpec:
    """Pure plan diff — no state; drives logging and lets callers pick the
    cheap path (e.g. nothing to do when only grad_accum moved)."""
    sizes_old = dict(zip(old.mesh_axes, old.mesh_shape))
    sizes_new = dict(zip(new.mesh_axes, new.mesh_shape))
    axis_resize = {
        a: (sizes_old.get(a, 1), sizes_new.get(a, 1))
        for a in sorted(set(sizes_old) | set(sizes_new))
        if sizes_old.get(a, 1) != sizes_new.get(a, 1)
    }
    restage = (old.pp != new.pp
               or (new.pp > 1 and old.pp_interleave != new.pp_interleave))
    return MigrationSpec(
        old_mesh=(tuple(old.mesh_shape), tuple(old.mesh_axes)),
        new_mesh=(tuple(new.mesh_shape), tuple(new.mesh_axes)),
        axis_resize=axis_resize,
        tp=(old.default_strategy.tp, new.default_strategy.tp),
        cp=(old.default_strategy.cp, new.default_strategy.cp),
        pp=(old.pp, new.pp),
        schedule=(old.pp_schedule, new.pp_schedule),
        grad_accum=(old.grad_accum, new.grad_accum),
        restage=restage,
        regroup=_group_key(old) != _group_key(new),
    )


# --------------------------------------------------------------------------
# carried (non-tensor) training state
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CarryState:
    """Training state that rides along besides params/opt-state: the loop
    step, the data cursor (global samples drawn — SyntheticDataset is keyed
    by sample id, so this is the only iterator state), and the host RNG
    (a ``torch.Generator``).  All host-side, so carrying it over a mesh
    swap is a copy, never a collective."""

    step: int
    samples_seen: int = 0
    rng: Optional[Any] = None

    def carried(self) -> "CarryState":
        """A copy whose ``rng`` draws are its own: later draws on the old
        generator cannot reach it."""
        rng = self.rng
        if rng is not None:
            rng = torch.Generator(device=rng.device)
            rng.set_state(self.rng.get_state())
        return CarryState(step=self.step, samples_seen=self.samples_seen, rng=rng)


@dataclasses.dataclass
class MigrationReport:
    spec: MigrationSpec
    seconds: float
    bytes_moved: int
    path: str                           # "in-memory" | "checkpoint"

    def summary(self) -> str:
        return (f"{self.path} migration: {self.spec.summary()} | "
                f"{self.bytes_moved / 1e6:.1f} MB in {self.seconds * 1e3:.1f} ms")


# --------------------------------------------------------------------------
# trainers
# --------------------------------------------------------------------------

@dataclasses.dataclass
class OutsideMesh:
    """The trainer of a rank outside its plan's mesh (a prefix of the
    world's ranks that leaves this rank out): the model, the plan and the
    mesh, no state.  ``migrate`` reads its plan; the launcher skips its
    steps."""

    model: Any
    plan: ExecutionPlan
    mesh: Any


def make_trainer(model, plan: ExecutionPlan, mesh, opt_cfg=None):
    """The runtime that realizes ``plan``: PipelineTrainer when the plan
    stages the block stack, ``construct_hybrid_parallel_model`` otherwise;
    an :class:`OutsideMesh` on a rank ``mesh`` does not hold.  A plan the
    runtime refuses raises here (a mixed-cp plan: ``check_layout``)."""
    if mesh is not None and not mesh.member:
        return OutsideMesh(model, plan, mesh)
    if plan.pp > 1:
        return PipelineTrainer(model, plan, mesh, opt_cfg)
    return construct_hybrid_parallel_model(model, plan, mesh, opt_cfg=opt_cfg)


def holds_state(trainer) -> bool:
    """Whether this rank runs ``trainer``'s steps (one device, or a member
    of its mesh)."""
    return trainer.mesh is None or trainer.mesh.member


def canonical_state(trainer, params, opt_state):
    """Fold a trainer's layout back into the canonical (ungrouped, unstaged)
    trees — the form checkpoints store (``checkpoint_state``: on a mesh
    every rank of it takes part in the gathers)."""
    return ckpt_lib.canonical_checkpoint_state(trainer, params, opt_state)


def canonical_templates(trainer, with_opt: bool = True, device=None):
    """Empty canonical trees on ``device`` (``trainer``'s by default), from
    the model's parameter definitions: fp32 params (the trainers' masters)
    and, with ``with_opt``, an ``AdamWState`` whose m / v take the optimizer
    config's dtypes.  What a rank that joins on a grow receives into (on
    ``meta``: what a restore reads the structure of)."""
    dev = trainer.device if device is None else device
    defs = trainer.model.param_defs()
    empty = lambda dt: tree_map(lambda d: torch.empty(d.shape, dtype=dt, device=dev), defs)
    params = empty(torch.float32)
    if not with_opt:
        return params, None
    cfg = trainer.opt_cfg
    return params, AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                              m=empty(cfg.m_dtype), v=empty(cfg.v_dtype))


def _size(trainer) -> int:
    return 1 if trainer.mesh is None else trainer.mesh.size


def _union_group(old, new):
    """The process group of the larger of the two meshes (every rank either
    mesh holds), or None for a single process."""
    big = old if _size(old) >= _size(new) else new
    if big.mesh is None or not big.mesh.member:
        return None
    group = big.mesh.group(big.mesh.axis_names)
    return group if group.size > 1 else None


def _header(canon_p, canon_o) -> dict:
    return {"opt": canon_o is not None,
            "leaves": {k: (tuple(x.shape), str(x.dtype))
                       for k, x in ckpt_lib._flatten((canon_p, canon_o)).items()}}


def _share(old, new, canon_p, canon_o):
    """On a grow (the new mesh larger than the old), the canonical trees from
    rank 0 to every rank of the new mesh, broadcast over its group leaf by
    leaf as bytes; a rank that joins receives into ``canonical_templates``,
    which must match rank 0's leaves (names, shapes, dtypes) or this
    raises.  Anything else passes the trees through."""
    import torch.distributed as dist

    if _size(new) <= _size(old) or not holds_state(new):
        return canon_p, canon_o
    group = new.mesh.group(new.mesh.axis_names)
    box = [_header(canon_p, canon_o) if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0, group=group.pg)
    if not holds_state(old):
        canon_p, canon_o = canonical_templates(new, box[0]["opt"])
        if _header(canon_p, canon_o) != box[0]:
            raise ValueError(f"rank {dist.get_rank()}: the model's canonical trees "
                             f"{_header(canon_p, canon_o)['leaves']} are not rank 0's "
                             f"{box[0]['leaves']}")
    for x in ckpt_lib._flatten((canon_p, canon_o)).values():
        if not x.is_contiguous():
            raise ValueError(f"a canonical leaf of shape {tuple(x.shape)} is not contiguous")
        dist.broadcast(x.reshape(-1).view(torch.uint8), src=0, group=group.pg)
    return canon_p, canon_o


def _tree_bytes(*trees) -> int:
    """Bytes of every tensor leaf of ``trees`` (a canonical tree counts each
    leaf whole, once, as JAX's global arrays count)."""
    return sum(x.numel() * x.element_size()
               for x in ckpt_lib._flatten(tuple(t for t in trees if t is not None)).values()
               if isinstance(x, torch.Tensor))


def _block(trainer) -> None:
    if holds_state(trainer) and trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)


# --------------------------------------------------------------------------
# migration paths
# --------------------------------------------------------------------------

def migrate(old_trainer, new_trainer, params, opt_state=None,
            carry: Optional[CarryState] = None):
    """In-memory migration: old layout -> canonical -> new layout, through
    the trainers' gathers and the grow broadcast (no host serialization).
    Every rank of either mesh calls it with the same two plans (a rank
    outside a mesh passes that mesh's ``OutsideMesh``, and a rank that
    joins passes None state).  Returns ``(params, opt_state, carry,
    report)`` laid out for ``new_trainer`` (None state on a rank outside
    it); ``bytes_moved`` is the migrated state's bytes, every leaf whole
    (0 outside the new mesh).  See the module note: this consumes the old
    state."""
    t0 = time.perf_counter()
    spec = diff_plans(old_trainer.plan, new_trainer.plan)
    canon_p = canon_o = new_p = new_o = None
    if holds_state(old_trainer) or holds_state(new_trainer):
        with span("migrate_canonicalize"):
            if holds_state(old_trainer):
                canon_p, canon_o = canonical_state(old_trainer, params, opt_state)
        with span("migrate_place"):
            canon_p, canon_o = _share(old_trainer, new_trainer, canon_p, canon_o)
            if holds_state(new_trainer):
                new_p = new_trainer.place_params(canon_p)
                new_o = None if canon_o is None else new_trainer.place_opt_state(canon_o)
                _block(new_trainer)
    moved = _tree_bytes(canon_p, canon_o) if holds_state(new_trainer) else 0
    new_carry = carry.carried() if carry is not None else None
    report = MigrationReport(spec=spec, seconds=time.perf_counter() - t0,
                             bytes_moved=moved, path="in-memory")
    return new_p, new_o, new_carry, report


def migrate_via_checkpoint(old_trainer, new_trainer, params, opt_state=None,
                           carry: Optional[CarryState] = None, *,
                           directory: Optional[str] = None,
                           step: int = 0,
                           async_write: bool = True,
                           codec: Optional[str] = None):
    """Checkpoint round-trip migration: the path for a real membership loss
    (the old mesh's state is gone) and the equivalence oracle ``migrate`` is
    held to — both give bitwise the same state, this one at the price of a
    serialize / disk round trip.  The old mesh gathers the canonical state,
    rank 0 writes it into ``directory`` (a temporary directory by default,
    named to the other ranks by broadcast) through the async
    ``CheckpointWriter`` (``async_write=False``: the synchronous ``save``;
    byte-identical either way; ``codec`` as ``save``'s), the ranks of the
    larger mesh meet at a barrier, and every rank of the new mesh restores
    it and places it.  Called as ``migrate``."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    spec = diff_plans(old_trainer.plan, new_trainer.plan)
    new_p = new_o = None
    moved = 0
    if holds_state(old_trainer) or holds_state(new_trainer):
        canon_p = canon_o = None
        with span("migrate_canonicalize"):
            if holds_state(old_trainer):
                canon_p, canon_o = canonical_state(old_trainer, params, opt_state)
        group = _union_group(old_trainer, new_trainer)
        rank = 0 if group is None else dist.get_rank()
        tmp = None
        if rank == 0 and directory is None:
            tmp = tempfile.TemporaryDirectory(prefix="resize-ckpt-")
            directory = tmp.name
        try:
            box = [(directory, canon_o is not None)]
            if group is not None:
                dist.broadcast_object_list(box, src=0, group=group.pg)
            directory, with_opt = box[0]
            with span("migrate_ckpt_roundtrip"):
                if rank == 0:
                    if async_write:
                        with ckpt_lib.CheckpointWriter() as writer:
                            writer.save_async(pathlib.Path(directory), step, canon_p, canon_o,
                                              old_trainer.plan, codec=codec)
                            writer.wait()
                    else:
                        ckpt_lib.save(pathlib.Path(directory), step, canon_p, canon_o,
                                      old_trainer.plan, codec=codec)
                if group is not None:
                    dist.barrier(group=group.pg)
                if holds_state(new_trainer):
                    # the structure alone: the gathered trees go before the read
                    like_p, like_o = canonical_templates(new_trainer, with_opt, "meta")
                    canon_p = canon_o = None
                    restored = ckpt_lib.restore(pathlib.Path(directory), step,
                                                params_like=like_p, opt_like=like_o)
                    del like_p, like_o
            with span("migrate_place"):
                if holds_state(new_trainer):
                    moved = _tree_bytes(restored["params"], restored.get("opt"))
                    new_p = new_trainer.place_params(restored["params"])
                    if with_opt:
                        new_o = new_trainer.place_opt_state(restored["opt"])
                    restored = None
                    _block(new_trainer)
            if group is not None:        # every reader done before rank 0 cleans up
                dist.barrier(group=group.pg)
        finally:
            if tmp is not None:
                tmp.cleanup()
    new_carry = carry.carried() if carry is not None else None
    report = MigrationReport(spec=spec, seconds=time.perf_counter() - t0,
                             bytes_moved=moved, path="checkpoint")
    return new_p, new_o, new_carry, report
