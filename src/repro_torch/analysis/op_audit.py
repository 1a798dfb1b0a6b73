"""The step's aten ops audited against its plan: the counterpart of
``repro.analysis.jaxpr_audit``.

JAX walks the staged jaxpr of its step.  The port's step is eager, so
:class:`OpRecorder` is a ``TorchDispatchMode`` that records the aten ops the
step dispatches (on real or fake tensors; ``analysis/step_trace.py``) and
gives JAX's ``JaxprSummary`` fields as :class:`OpSummary`:

* **dots** — ``aten.mm / addmm / bmm / baddbmm / convolution``, each with
  the dtypes of its two matrix operands (``dot_dtypes``), ``f32_dots`` when
  both are float32, ``total_dots``; a flash-attention kernel event (K1 on a
  fake tensor, ``kernels/_fake.py``) counts as a dot of its dtype;
* **remat** — ``remat_eqns`` the checkpointed forwards entered
  (``parallel/remat.py`` marks them), ``remat_dots`` the dots dispatched
  inside one;
* **host reads** — ``callbacks``: ``aten._local_scalar_dense`` (``.item()``,
  ``int(t)``, ``.tolist()``), ``aten.nonzero``, a copy off a device to the
  CPU (``_to_copy``/``copy_``), each with the ``file:line`` of the step's
  Python that asked for it (the innermost frame outside torch and this
  package's analysis).  On a fake tensor the read raises
  ``DataDependentOutputException`` after it is recorded, on a ``meta`` one
  the recorder raises :class:`HostRead`: either stops a traced step there.

``audit_ops(summary, plan, dtype="bf16")`` gives GALV091/092/093 under
``jaxpr_audit.audit_jaxpr``'s rules and messages.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.plan_check import Diagnostic
from repro_torch.parallel import remat

_aten = torch.ops.aten
#: matmul-class ops inspected for dtype drift: op -> (lhs, rhs) arg positions
DOT_OPS = {_aten.mm.default: (0, 1), _aten.addmm.default: (1, 2),
           _aten.bmm.default: (0, 1), _aten.baddbmm.default: (1, 2),
           _aten.convolution.default: (0, 1)}
#: kernel events counted as dots
DOT_KERNELS = ("flash_attention_fwd",)
_HOST_READS = (_aten._local_scalar_dense.default, _aten.nonzero.default)
_COPIES = (_aten._to_copy.default, _aten.copy_.default)

_TORCH_DIR = os.path.dirname(torch.__file__)
_ANALYSIS_DIR = os.path.dirname(os.path.abspath(__file__))


class HostRead(RuntimeError):
    """A host read of a ``meta`` tensor in a traced step (there is no value
    to read)."""


@dataclasses.dataclass
class OpSummary:
    """Op census of one step (``JaxprSummary``'s fields)."""

    prim_counts: Counter            # aten op name -> occurrences
    dot_dtypes: Counter             # (lhs_dtype, rhs_dtype) -> dot count
    f32_dots: int                   # dots with BOTH operands f32
    total_dots: int
    remat_eqns: int                 # checkpointed forwards entered
    remat_dots: int                 # matmuls inside checkpointed forwards
    callbacks: list                 # host reads: "op at file:line"


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def step_site() -> str:
    """``file:line`` of the innermost Python frame outside torch and this
    package's analysis: where the step asked for what is being recorded."""
    frame = sys._getframe(1)
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if not (path.startswith(_TORCH_DIR) or path.startswith(_ANALYSIS_DIR)
                or "<frozen" in path):
            return f"{os.path.relpath(path)}:{frame.f_lineno}"
        frame = frame.f_back
    return "?"


class OpRecorder(TorchDispatchMode):
    """Record the aten ops dispatched inside the block (see the module
    note); ``summary()`` gives the :class:`OpSummary`."""

    def __init__(self):
        super().__init__()
        self.prim_counts: Counter = Counter()
        self.dot_dtypes: Counter = Counter()
        self.f32_dots = self.total_dots = self.remat_dots = 0
        self.callbacks: list = []
        self._entered0 = remat.REGIONS.entered

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.prim_counts[str(func.overloadpacket)] += 1
        if func in DOT_OPS:
            a, b = DOT_OPS[func]
            self._dot(_dtype_name(args[a]), _dtype_name(args[b]))
        elif func in _HOST_READS:
            self.host_read(str(func.overloadpacket), args[0])
        elif func in _COPIES and self._to_host(func, args, kwargs):
            self.host_read(str(func.overloadpacket) + " to cpu",
                           args[1] if func is _aten.copy_.default else args[0])
        return func(*args, **kwargs)

    def _dot(self, lhs: str, rhs: str) -> None:
        self.dot_dtypes[(lhs, rhs)] += 1
        self.total_dots += 1
        if lhs == rhs == "float32":
            self.f32_dots += 1
        if remat.in_region():
            self.remat_dots += 1

    @staticmethod
    def _to_host(func, args, kwargs) -> bool:
        src = args[1] if func is _aten.copy_.default else args[0]
        dst = (args[0].device if func is _aten.copy_.default
               else kwargs.get("device") or src.device)
        return torch.device(dst).type == "cpu" and src.device.type != "cpu"

    def host_read(self, what: str, src=None) -> None:
        self.callbacks.append(f"{what} at {step_site()}")
        if isinstance(src, torch.Tensor) and src.device.type == "meta":
            raise HostRead(self.callbacks[-1])

    def kernel(self, event) -> None:
        """A kernel event (``kernels._fake.listen``): K1 counts as a dot."""
        if event.name in DOT_KERNELS:
            self._dot(event.dtype, event.dtype)

    def summary(self) -> OpSummary:
        return OpSummary(Counter(self.prim_counts), Counter(self.dot_dtypes), self.f32_dots,
                         self.total_dots, remat.REGIONS.entered - self._entered0,
                         self.remat_dots, list(self.callbacks))


def audit_ops(s: OpSummary, plan, *, dtype: str = "bf16") -> list[Diagnostic]:
    """GALV091/092/093 for one step's op summary against its plan (JAX's
    ``audit_jaxpr`` rules and messages; ``dtype`` the plan's compute
    dtype)."""
    diags: list[Diagnostic] = []
    if dtype in ("bf16", "bfloat16") and s.f32_dots > 0:
        diags.append(Diagnostic(
            "GALV091",
            f"{s.f32_dots}/{s.total_dots} matmuls run f32×f32 in a {dtype} "
            "plan — the forward pass ran at the wrong width (f32 "
            "rmsnorm/softmax/logit accumulators are elementwise or "
            "bf16-operand and never counted)",
            where="ops"))
    declared = [i for i, st in enumerate(plan.layer_strategies) if st.remat != "none"]
    if declared and s.remat_dots == 0:
        pol = sorted({plan.layer_strategies[i].remat for i in declared})
        diags.append(Diagnostic(
            "GALV092",
            f"plan declares remat={'/'.join(pol)} on {len(declared)} layer(s) but no "
            f"checkpointed forward in the step runs a matmul ({s.remat_eqns} "
            "dot-free checkpointed forward(s) found) — nothing will be recomputed in "
            "the backward",
            where="ops"))
    if s.callbacks:
        kinds = Counter(c.split(" at ")[0] for c in s.callbacks)
        desc = ", ".join(f"{k}×{n}" for k, n in sorted(kinds.items()))
        diags.append(Diagnostic(
            "GALV093",
            f"host read(s) inside the step: {desc} (first at "
            f"{s.callbacks[0].split(' at ', 1)[1]})",
            where="ops"))
    return diags
