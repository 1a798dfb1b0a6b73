"""Trace one step on tensors that hold no data: what the dry run and
``launch.train --audit`` measure in place of a compiled program.

``trace_step(step, arguments, mesh)`` runs ``step()`` (a closure over its
inputs, built from the abstract trees by ``materialize`` inside
``tracing(device)``) under four recorders at once, and returns a
:class:`StepTrace`:

* the collective census (``analysis/comm_census.py``), labelled by
  ``mesh``'s axes;
* the aten ops (``analysis/op_audit.py``): dots, checkpointed forwards,
  host reads;
* the flops: ``torch.utils.flop_counter.FlopCounterMode`` over the aten
  ops, plus the kernels' own counts from their fake paths
  (``kernels/_fake.py``: a kernel does no aten op);
* the live bytes (:class:`LiveBytes`): every storage an op creates adds
  its ``nbytes`` and subtracts them when it is freed (``weakref.finalize``
  on the storage), starting from the arguments; the peak is the step's
  high-water mark.  ``memory_analysis()`` gives JAX's keys: ``argument``
  (the arguments' storages), ``temp`` (peak minus arguments), ``output``
  (the outputs' storages), ``alias`` (outputs that are arguments: a
  donated step's state), ``generated_code`` 0.

The traced tensors are fake (``FakeTensor``s under the caller's
``FakeTensorMode``, on any device) or plain ``meta`` tensors, which need no
mode and trace about twice as fast (``tracing(device)`` gives the context
for a device: a ``FakeTensorMode`` unless it is ``meta``).  ``memory_only``
leaves out the census, the op recorder and the flop counter.

A host read raises ``DataDependentOutputException`` on a fake tensor and
``op_audit.HostRead`` on a meta one: the op recorder has its ``file:line``
by then, and ``trace_step`` keeps what it recorded up to there and returns
with ``stopped`` set to the read's site.  No other error is caught.

Tracing runs no kernel and sends nothing: on the ``fake`` process-group
backend nothing exists to send to, and on a real gloo or NCCL group a
collective on a fake tensor returns at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from typing import Any, Callable, Optional

import torch
from torch._subclasses.fake_tensor import DataDependentOutputException
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.comm_census import CommCensus
from repro_torch.analysis.op_audit import HostRead, OpRecorder
from repro_torch.kernels import _fake
from repro_torch.models.common import tree_map


def _tensors(tree) -> list:
    """The tensors of a nested structure of dicts, lists, tuples and
    NamedTuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _storages(tree) -> dict:
    """{id(storage): nbytes} of the distinct storages under ``tree``."""
    out = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        out[id(st)] = st.nbytes()
    return out


def materialize(tree, device, dtype=None):
    """A tree of abstract tensors (``meta``; from ``abstract_params`` and
    kin) as empty tensors on ``device``, in ``dtype`` when given: call it
    inside a ``FakeTensorMode``, where they hold no data."""
    def one(t):
        return torch.empty(t.shape, dtype=dtype or t.dtype, device=device)

    if isinstance(tree, torch.Tensor):
        return one(tree)
    if isinstance(tree, dict):
        return {k: materialize(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(materialize(v, device, dtype) for v in tree))
    return tree_map(one, tree)


class LiveBytes(TorchDispatchMode):
    """Bytes of the live storages: the ``track``ed arguments and every
    storage an op dispatched inside the block creates, each until it is
    freed; ``peak`` is the most at once."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._held: dict = {}

    def track(self, tree) -> None:
        for t in _tensors(tree):
            self._add(t)

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t)
        return out


@dataclasses.dataclass
class StepTrace:
    """What one traced step did (see the module note)."""

    census: CommCensus
    ops: OpRecorder
    kernels: list
    aten_flops: int
    argument_bytes: int
    peak_bytes: int
    output_bytes: int
    alias_bytes: int
    seconds: float
    outputs: Any = None
    stopped: Optional[str] = None       # a host read's site when one stopped it

    @property
    def kernel_flops(self) -> float:
        return float(sum(e.flops for e in self.kernels))

    @property
    def flops(self) -> float:
        return float(self.aten_flops) + self.kernel_flops

    @property
    def temp_bytes(self) -> int:
        return max(self.peak_bytes - self.argument_bytes, 0)

    def memory_analysis(self) -> dict:
        return {"argument_size_in_bytes": self.argument_bytes,
                "output_size_in_bytes": self.output_bytes,
                "alias_size_in_bytes": self.alias_bytes,
                "temp_size_in_bytes": self.temp_bytes,
                "generated_code_size_in_bytes": 0}

    def kernel_counts(self) -> dict:
        counts: dict = {}
        for e in self.kernels:
            counts[e.name] = counts.get(e.name, 0) + 1
        return counts


def tracing(device):
    """The context a step on ``device`` is traced in: a ``FakeTensorMode``
    (tensors made inside hold no data), or nothing for ``meta``, whose
    tensors hold none already."""
    if torch.device(device).type == "meta":
        return contextlib.nullcontext()
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def trace_step(step: Callable[[], Any], arguments, mesh=None, *,
               memory_only: bool = False) -> StepTrace:
    """Run ``step()`` under the recorders; ``arguments`` are its input
    trees (counted as the argument bytes and live from the start)."""
    census, ops, mem = CommCensus(mesh), OpRecorder(), LiveBytes()
    flops = FlopCounterMode(display=False)
    kernels: list = []
    args_bytes = _storages(arguments)
    mem.track(arguments)

    def on_kernel(event) -> None:
        kernels.append(event)
        ops.kernel(event)

    outputs, stopped = None, None
    recorders = (contextlib.nullcontext(),) * 3 if memory_only else (flops, census, ops)
    t0 = time.perf_counter()
    with _fake.listen(on_kernel), recorders[0], recorders[1], recorders[2], mem:
        try:
            outputs = step()
        except (DataDependentOutputException, HostRead):
            if not ops.callbacks:
                raise
            stopped = ops.callbacks[-1].split(" at ", 1)[1]
    seconds = time.perf_counter() - t0
    out_bytes = _storages(outputs)
    alias = sum(n for k, n in out_bytes.items() if k in args_bytes)
    return StepTrace(census, ops, kernels, 0 if memory_only else flops.get_total_flops(),
                     sum(args_bytes.values()), mem.peak, sum(out_bytes.values()), alias,
                     seconds, outputs, stopped)
