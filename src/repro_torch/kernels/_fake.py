"""The kernels' entry on tensors without storage: a traced step's kernel
events.

The dry run (``launch/dryrun.py``) and ``launch.train --audit`` trace a
step on tensors that hold no data: ``FakeTensor``s under
``torch._subclasses.fake_tensor.FakeTensorMode``, or tensors on the
``meta`` device.  A kernel's ``ctypes`` launch needs a data pointer, which
such a tensor does not have, so each wrapper takes this path first when its
inputs are of that type (``is_fake``: the type of the tensor, never a
caught error).  It allocates the kernel's outputs and workspaces as the
launch path does, so a traced step's memory counts them, queries no device,
launches nothing, counts no launch, and reports one :class:`KernelEvent`
(the kernel's name, shapes, dtype, and the flops and bytes of its work,
counted as the bounds in ``PERF.md`` count them) to every listener
(``listen``).  Where the launch path reads the device (the SM count that
sizes K1's split-K workspace and K2's backward grid), the fake path takes
an H100 SXM's 132 SMs.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch._subclasses.fake_tensor import FakeTensor

#: SMs of an H100 SXM: what sizes a workspace that the launch path sizes
#: from the device's SM count
H100_SMS = 132


def is_fake(*tensors) -> bool:
    """True when any of ``tensors`` (None skipped) holds no data: a
    ``FakeTensor`` or a tensor on the ``meta`` device."""
    return any(isinstance(t, FakeTensor) or (isinstance(t, torch.Tensor)
                                             and t.device.type == "meta")
               for t in tensors if t is not None)


@dataclasses.dataclass(frozen=True)
class KernelEvent:
    """One kernel call of a traced step."""

    name: str
    shapes: tuple
    dtype: str
    flops: float
    bytes: float


_LISTENERS: list = []


@contextlib.contextmanager
def listen(fn):
    """Call ``fn(event)`` for every kernel event inside the block."""
    _LISTENERS.append(fn)
    try:
        yield
    finally:
        _LISTENERS.remove(fn)


def record(name: str, tensors, flops: float, nbytes: float) -> None:
    """Report one fake kernel call to the listeners."""
    tensors = [t for t in tensors if t is not None]
    event = KernelEvent(name, tuple(tuple(t.shape) for t in tensors),
                        str(tensors[0].dtype).replace("torch.", ""), float(flops),
                        float(nbytes))
    for fn in list(_LISTENERS):
        fn(event)


def active() -> bool:
    """Whether a ``FakeTensorMode`` is active: a tensor made now holds no
    data (what a buffer cache must not keep)."""
    from torch._guards import detect_fake_mode

    return detect_fake_mode() is not None


def nbytes(*tensors) -> int:
    """The bytes of ``tensors`` (None skipped), each read or written once."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)
