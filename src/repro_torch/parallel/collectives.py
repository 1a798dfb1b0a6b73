"""Collectives and the tensor-parallel region operators.

JAX hands sharding constraints to GSPMD, which inserts the collectives.  The
port holds local shards as plain tensors and moves activations itself, in
the Megatron layout that Galvatron's own PyTorch runtime uses: explicit
process groups (``launch.mesh.AxisGroup``) and ``torch.autograd.Function``s
at the region boundaries.  Each pairs a forward collective with its adjoint:

================  ==============================  ===========================
operator          forward                         backward
================  ==============================  ===========================
``copy_to``       identity                        all-reduce
``reduce_from``   all-reduce                      identity
``gather``        all-gather along ``dim``        this rank's slice
``split``         this rank's slice               all-gather
``gather_sum``    all-gather along ``dim``        reduce-scatter
``scatter_sum``   reduce-scatter along ``dim``    all-gather
``exchange``      all-to-all of rows by splits    the reverse all-to-all
================  ==============================  ===========================

``gather_sum_many`` is ``gather_sum`` over several tensors in one message;
``exchange`` is expert parallelism's: rows sent to each rank of a group by
split sizes.

A group of one makes every operator the identity.  Every collective runs
in its tensor's dtype, as NCCL and XLA reduce: a bf16 partial sum is summed
in bf16, so two ranks round it once, as a single card rounds its matmul's
fp32 sum once.  The names used (``all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_to_all_single``) exist in every torch
this runs on, and gloo takes each of them on CUDA tensors in fp32 and
bf16, so nothing is staged through the host by hand.

``region_in`` / ``region_out`` are the tensor-parallel boundaries the
models call where JAX marks ``lc`` sites: entering a region whose weights
are sharded over the model axis (identity forward, all-reduced grad; under
sequence parallelism an all-gather of the sequence with a reduce-scattered
grad) and leaving it after ``wo`` / ``w_out`` (an all-reduce; under
sequence parallelism a reduce-scatter to sequence shards).  Where
``spec_for_shape`` left a weight whole (e.g. one KV head at tp 2), the
region is computed replicated and only the sequence moves.
``partial_grad`` marks a leaf that every rank holds whole but uses for part
of the work (the norm scales under sequence parallelism, qk-norm scales and
replicated K/V projections beside sharded query heads): identity forward,
grad all-reduced over the model axis.

``StageHop`` is the pipeline's stage hop: point-to-point between this rank
and the ranks that share its coordinates on the other stages of the pod
axis, the wrap from the last stage to the first included.  It is not an
autograd function: the pipeline's schedule drives each backward itself
(``torch.autograd.backward(out, grad)``) and moves the cotangents with the
same hop.  Its transport follows the mesh's backend and device, never a
caught error: NCCL and gloo on CPU tensors take ``batch_isend_irecv``
directly; gloo cannot send a CUDA tensor point to point (its ``writev``
of the device address fails and the pair's connection closes, or the
sending process dies: ``scripts/chip_parallel.py --probe`` on an H100), so
under gloo on CUDA each hop is copied through pinned host buffers and
those copies' bytes are counted.  The context-parallel ring
(``parallel.context``) goes round the ``cp`` axis on the same hop;
``ring_shift`` is the hop under autograd, whose backward shifts the grads
the other way.

Sequence parallelism nests inside a context-parallel shard: the rules give
``seq`` to ``("cp", "model")``, and the runtime hands each rank its cp
shard of the tokens, so ``lc``, ``region_in`` / ``region_out`` and
``relayout`` split and gather the sequence over the model axis alone.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.axes import current_rules

def _trivial(group) -> bool:
    return group is None or group.size == 1


# --------------------------------------------------------------------------
# plain collectives (out of place, no autograd)
# --------------------------------------------------------------------------

def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``x`` reduced over ``group``."""
    if _trivial(group):
        return x
    buf = x.clone()
    dist.all_reduce(buf, op=op, group=group.pg)
    return buf


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in shard order."""
    if _trivial(group):
        return x
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((group.size * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group.pg)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's shard along ``dim`` of the sum of the group's tensors."""
    if _trivial(group):
        return x
    src = x.movedim(dim, 0).contiguous()
    if src.shape[0] % group.size:
        raise ValueError(f"dim {dim} of size {src.shape[0]} does not split over "
                         f"{group.size} ranks")
    out = torch.empty((src.shape[0] // group.size,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group.pg)
    return out.movedim(0, dim).contiguous()


def all_to_all(x: torch.Tensor, send: list, recv: list, group, rows=None) -> torch.Tensor:
    """Rows of ``x`` to the ranks of ``group``: the first ``send[0]`` to its
    rank 0, the next ``send[1]`` to its rank 1, ...; the rows received,
    ``recv[i]`` from rank i, in rank order.  The result has ``rows`` rows
    (default ``max(sum(recv), 1)``), the ones past ``sum(recv)`` zeros, and
    ``x`` may hold rows past ``sum(send)``, which stay: so a rank that
    sends or receives nothing still passes and gets a tensor to gather
    from."""
    n_in, n_out = sum(send), sum(recv)
    rows = max(n_out, 1) if rows is None else rows
    out = x.new_empty((rows,) + tuple(x.shape[1:]))
    out[n_out:].zero_()
    if _trivial(group):
        out[:n_out] = x[:n_in]
    else:
        dist.all_to_all_single(out[:n_out], x[:n_in].contiguous(), list(recv), list(send),
                               group=group.pg)
    return out


def take_shard(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's contiguous shard of ``x`` along ``dim`` (a copy)."""
    if _trivial(group):
        return x
    n = x.shape[dim]
    if n % group.size:
        raise ValueError(f"dim {dim} of size {n} does not split over {group.size} ranks")
    size = n // group.size
    return x.narrow(dim, group.index * size, size).contiguous()


# --------------------------------------------------------------------------
# autograd operators
# --------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return take_shard(g, ctx.dim, ctx.group), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return take_shard(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, send, recv, group):
        ctx.send, ctx.recv, ctx.group, ctx.rows = send, recv, group, x.shape[0]
        return all_to_all(x, send, recv, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.recv, ctx.send, ctx.group, rows=ctx.rows), None, None, None


class _GatherSumMany(torch.autograd.Function):
    """``gather_sum`` of several tensors of one dtype over one group, in one
    all-gather forward and one reduce-scatter backward: each tensor's
    ``dim`` moved first and flattened into one buffer per rank."""

    @staticmethod
    def forward(ctx, dims, group, *xs):
        ctx.dims, ctx.group = dims, group
        moved = [x.movedim(d, 0) for x, d in zip(xs, dims)]
        ctx.shapes = [tuple(m.shape) for m in moved]
        flat = torch.cat([m.reshape(-1) for m in moved])
        out = all_gather(flat, 0, group).view(group.size, -1)
        outs, start = [], 0
        for (n0, *rest), d in zip(ctx.shapes, dims):
            size = n0 * int(np.prod(rest, dtype=np.int64))
            piece = out[:, start:start + size].reshape(group.size * n0, *rest)
            outs.append(piece.movedim(0, d).contiguous())
            start += size
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        n = ctx.group.size
        flat = torch.cat([g.movedim(d, 0).reshape(n, -1)
                          for g, d in zip(grads, ctx.dims)], dim=1)
        mine = reduce_scatter(flat.reshape(-1), 0, ctx.group)
        outs, start = [], 0
        for shape, d in zip(ctx.shapes, ctx.dims):
            size = int(np.prod(shape, dtype=np.int64))
            outs.append(mine[start:start + size].reshape(shape).movedim(0, d).contiguous())
            start += size
        return (None, None, *outs)


def gather_sum_many(xs: list, dims: list, group) -> list:
    """``[gather_sum(x, d, group) ...]`` in one collective each way (ZeRO-3's
    per-layer gather: one message a layer, not one a leaf)."""
    if _trivial(group) or not xs:
        return list(xs)
    if len({x.dtype for x in xs}) > 1:
        raise ValueError("gather_sum_many takes one dtype, got "
                         f"{sorted({str(x.dtype) for x in xs})}")
    return list(_GatherSumMany.apply(tuple(dims), group, *xs))


def exchange(x, send: list, recv: list, group):
    """``all_to_all`` under autograd: the grad of the rows received goes back
    to their senders by the reverse exchange.  The split sizes are host
    integers, read from the device by the caller: an eager step's reading,
    which a step captured as a CUDA graph could not make."""
    return _Exchange.apply(x, list(send), list(recv), group)


def copy_to(x, group):
    return x if _trivial(group) else _CopyTo.apply(x, group)


def reduce_from(x, group):
    return x if _trivial(group) else _ReduceFrom.apply(x, group)


def gather(x, dim: int, group):
    return x if _trivial(group) else _Gather.apply(x, dim, group)


def split(x, dim: int, group):
    return x if _trivial(group) else _Split.apply(x, dim, group)


def gather_sum(x, dim: int, group):
    return x if _trivial(group) else _GatherSum.apply(x, dim, group)


def scatter_sum(x, dim: int, group):
    return x if _trivial(group) else _ScatterSum.apply(x, dim, group)


# --------------------------------------------------------------------------
# tensor-parallel regions, read from the active rules
# --------------------------------------------------------------------------

SEQ_DIM = 1          # activations are (batch, seq, ...)


@dataclasses.dataclass(frozen=True)
class TPState:
    group: object        # launch.mesh.AxisGroup of the model axis
    sp: bool             # sequence parallelism: boundaries hold sequence shards


def tp_state() -> Optional[TPState]:
    """The active layer group's tensor parallelism, or None (no rules, an
    abstract mesh, tp 1, or a model axis of one rank)."""
    rules = current_rules()
    if rules is None or not hasattr(rules.mesh, "group"):
        return None
    target = rules.rules.get("q_heads")
    if target is None:
        return None
    group = rules.mesh.group(target)
    if group.size == 1:
        return None
    seq = rules.rules.get("seq")
    sp = seq is not None and target in (seq if isinstance(seq, tuple) else (seq,))
    return TPState(group, sp)


def batch_group():
    """The ranks the active layer group's batch is split over (its rules'
    ``batch`` axes), or None off a mesh; a layer's tokens are the global
    microbatch, these ranks' rows in their order."""
    rules = current_rules()
    if rules is None or not hasattr(rules.mesh, "group"):
        return None
    return rules.mesh.group(tuple(rules.rules.get("batch") or ()))


def experts_group():
    """The ranks the active rules shard the ``experts`` dim over (the data
    axis under expert parallelism), or None."""
    rules = current_rules()
    target = None if rules is None else rules.rules.get("experts")
    if target is None or not hasattr(rules.mesh, "group"):
        return None
    return rules.mesh.group(target if isinstance(target, tuple) else (target,))


def member_indices(sub, outer) -> list:
    """The index in ``outer`` (an ``AxisGroup`` whose axes hold ``sub``'s)
    of every rank of ``sub``, in ``sub``'s order: the ranks that share this
    rank's coordinates on every other axis."""
    mesh = current_rules().mesh
    coords = dict(mesh.coords)
    out = []
    for combo in itertools.product(*(range(mesh.shape[a]) for a in sub.axes)):
        c = dict(coords, **dict(zip(sub.axes, combo)))
        index = 0
        for a in outer.axes:
            index = index * mesh.shape[a] + c[a]
        out.append(index)
    return out


def region_in(x: torch.Tensor, sharded: bool = True) -> torch.Tensor:
    """Enter a tensor-parallel region from the boundary layout: the full
    sequence on every rank of the model axis (see the module note)."""
    tp = tp_state()
    if tp is None:
        return x
    if sharded:
        return gather_sum(x, SEQ_DIM, tp.group) if tp.sp else copy_to(x, tp.group)
    return gather(x, SEQ_DIM, tp.group) if tp.sp else x


def region_out(y: torch.Tensor, sharded: bool = True) -> torch.Tensor:
    """Leave a tensor-parallel region: ``y`` is this rank's partial sum when
    the region's weights are sharded, else the whole value."""
    tp = tp_state()
    if tp is None:
        return y
    if sharded:
        return scatter_sum(y, SEQ_DIM, tp.group) if tp.sp else reduce_from(y, tp.group)
    return split(y, SEQ_DIM, tp.group) if tp.sp else y


def partial_grad(w: torch.Tensor) -> torch.Tensor:
    """``w`` whole on every rank of the model axis, its grad summed over it."""
    tp = tp_state()
    return w if tp is None else copy_to(w, tp.group)


def seq_partial(params: dict) -> dict:
    """A norm's params, their grads summed over the model axis when the
    norm runs on sequence shards."""
    tp = tp_state()
    if tp is None or not tp.sp:
        return params
    return {k: copy_to(v, tp.group) for k, v in params.items()}


def relayout(x: torch.Tensor, src: str, dst: str, group) -> torch.Tensor:
    """The residual stream moved between two layouts over the model axis:
    ``"rep"`` (whole on every rank), ``"seq"`` (sequence shards) or
    ``"batch"`` (batch shards, where a tp 1 layer absorbs the model axis
    into data parallelism).  A pure change of layout: its backward is the
    inverse change, so grads stay those of the whole value."""
    if src == dst or _trivial(group):
        return x
    if src != "rep":
        x = gather(x, SEQ_DIM if src == "seq" else 0, group)
    if dst != "rep":
        x = split(x, SEQ_DIM if dst == "seq" else 0, group)
    return x


# --------------------------------------------------------------------------
# the pipeline's stage hop
# --------------------------------------------------------------------------

#: The mesh axis that holds the pipeline's stages (``core.strategy`` drops
#: it from the batch group when pp > 1; ``launch.mesh.train_mesh_spec``
#: puts it first).
PIPE_AXIS = "pod"


class StageHop:
    """Point-to-point over the ``axis`` group of ``mesh`` (a
    ``launch.mesh.ProcessMesh``; the pipe axis by default, the ``cp`` axis
    for the context-parallel ring, ``mesh.hop("cp")``): this rank is stage
    ``stage`` of ``stages``, and stage i is the rank at this rank's
    coordinates with ``axis`` at i.  ``bytes`` counts what ``exchange``
    sent and received and what it copied between the card and pinned host
    buffers."""

    def __init__(self, mesh, axis: str = PIPE_AXIS):
        group = mesh.group(axis)
        self.stage, self.stages = group.index, group.size
        at = list(mesh.axis_names).index(axis)
        coords = [mesh.coords[a] for a in mesh.axis_names]
        self._ranks = [mesh.rank_of(coords[:at] + [i] + coords[at + 1:])
                       for i in range(self.stages)]
        self.device = mesh.device
        # gloo sends host memory only (see the module note)
        self.through_host = mesh.backend == "gloo" and mesh.device.type == "cuda"
        self._pinned: dict = {}
        self.bytes = {"sent": 0, "received": 0, "host_copies": 0}

    def _host(self, key, like_shape, dtype) -> torch.Tensor:
        if key not in self._pinned:
            self._pinned[key] = torch.empty(like_shape, dtype=dtype, pin_memory=True)
        return self._pinned[key]

    def exchange(self, sends: list, recvs: list) -> list:
        """Post every send ``(stage, tensor)`` and every receive ``(stage,
        shape, dtype)`` together, wait for all of them, and return the
        tensors received, in ``recvs``' order, on this rank's device.  Both
        sides of a pair must post it in the same call: the pipeline's
        schedule makes every tick one such call on every rank."""
        ops, out, landed = [], [], []
        for i, (stage, x) in enumerate(sends):
            x = x.contiguous()
            if self.through_host:
                host = self._host(("send", i, tuple(x.shape), x.dtype), x.shape, x.dtype)
                host.copy_(x)
                self.bytes["host_copies"] += x.numel() * x.element_size()
                x = host
            ops.append(dist.P2POp(dist.isend, x, self._ranks[stage]))
            self.bytes["sent"] += x.numel() * x.element_size()
        for i, (stage, shape, dtype) in enumerate(recvs):
            if self.through_host:
                buf = self._host(("recv", i, tuple(shape), dtype), shape, dtype)
            else:
                buf = torch.empty(shape, dtype=dtype, device=self.device)
            ops.append(dist.P2POp(dist.irecv, buf, self._ranks[stage]))
            landed.append(buf)
            self.bytes["received"] += buf.numel() * buf.element_size()
        for req in (dist.batch_isend_irecv(ops) if ops else []):
            req.wait()
        for buf in landed:
            if self.through_host:
                self.bytes["host_copies"] += buf.numel() * buf.element_size()
                buf = buf.to(self.device, copy=True)
            out.append(buf)
        return out

    def rotate(self, xs, step: int = 1) -> list:
        """``step`` stages round the ring in one ``exchange``: every tensor
        of ``xs`` to the stage ``step`` on (the last stage's to the first),
        and those the stage ``step`` back sends here, of the same shapes and
        dtypes, received."""
        to, frm = (self.stage + step) % self.stages, (self.stage - step) % self.stages
        return self.exchange([(to, x) for x in xs], [(frm, x.shape, x.dtype) for x in xs])

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """One step round the ring: ``x`` to the next stage and the previous
        stage's tensor received (``rotate`` of one tensor)."""
        return self.rotate([x])[0]


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hop, *xs):
        ctx.hop = hop
        return tuple(hop.rotate(xs))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.hop.rotate([g.contiguous() for g in grads], -1))


def ring_shift(hop, *xs) -> tuple:
    """``hop.shift`` of several tensors in one exchange, under autograd: the
    grads go back the other way round the ring."""
    if hop.stages == 1:
        return xs
    return _RingShift.apply(hop, *xs)
