"""RMSNorm entry points: the CUDA kernels on CUDA tensors, the plain versions
on CPU tensors.

Replaces the TPU kernel ``repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas``
(body ``_rmsnorm_kernel``) with ``csrc/rmsnorm.cu``, and gives it a backward,
``csrc/rmsnorm_bwd.cu`` (the counterpart of XLA's compiled backward of the
JAX norm).  What bounds both on the H100: bytes — one read and one write of
every element at 3.35 TB/s, a few flops each.  Entry points:

- ``rmsnorm(x, scale, eps)``: one read of each row in 16-byte packs kept in
  registers, the fp32 sum of squares reduced over the row's threads, one
  write;
- ``rmsnorm(x, scale, eps, gate=z)``: Mamba2's gate norm ``rmsnorm(x *
  silu(z))`` in the same pass (reads x and z, writes the output), rounding
  where the plain composition rounds;
- ``rmsnorm_backward(x, scale, g, eps)``, the backward of ``_RMSNorm``:
  dx and a deterministic dscale (fp32 partial rows per block, then a
  column sum; no atomics);
- the split-row form, for a row whose columns are split over the ranks of
  a tensor-parallel group (Mamba2's gate norm over ``d_inner``): each rank
  holds D of the row's ``width`` columns.  Forward: ``rmsnorm_split_sumsq``
  (each row's fp32 Σ x² over this rank's columns), an all-reduce, then
  ``rmsnorm_split`` (normalise with the whole row's mean, scale by this
  rank's slice).  Backward: ``rmsnorm_split_dot`` (each row's Σ gs·x̂), an
  all-reduce, then ``rmsnorm_split_backward`` (dx, and this slice's dscale
  through the whole-row backward's column sums).
  ``rmsnorm_split_autograd`` composes them under autograd.

The layout of a call — 16-byte packs or scalars, packs per thread, threads
per row — is the pure function ``_template``.  Counters (kernel launches on
CUDA tensors; plain-version calls on the CPU do not count):
``rmsnorm.launches`` (every forward, gated or not), ``rmsnorm.gated_launches``
(the gated forwards) and ``rmsnorm.backward_launches`` (backward calls, each
two launches: the rows, then the column sums), and each split pass's own
``launches`` (``rmsnorm_split_sumsq``, ``rmsnorm_split``,
``rmsnorm_split_dot``, ``rmsnorm_split_backward``: two launches a call, as
the whole-row backward).  ``COUNTERS`` lists the whole-row ones and
``SPLIT_COUNTERS`` the split passes' for ``runtime/compiled.py``, which
adds a captured graph's launches at each replay, so under a CUDA graph they
still count device launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, _fake
from repro_torch.kernels.rmsnorm.ref import (gated_rmsnorm_reference, rmsnorm_backward_reference,
                                             rmsnorm_reference, rmsnorm_split_backward_reference,
                                             rmsnorm_split_dot_reference,
                                             rmsnorm_split_reference,
                                             rmsnorm_split_sumsq_reference)
from repro_torch.parallel import collectives

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_FWD_ARGTYPES = (_P, _P, _P, _P, _LL, _I, _F, _I, _I, _I, _I, _I, _P)
_GRID_ARGTYPES = (_LL, _I, _I, _I, _I, _I, _I, ctypes.POINTER(_I))
_BWD_ARGTYPES = (_P, _P, _P, _P, _P, _P, _LL, _I, _F, _I, _I, _I, _I, _I, _I, _P)

PACK_BYTES = 16        # one vector access
MAX_TPR = 512          # threads per row, forward (csrc/rmsnorm.cuh: kMaxThreads)
BWD_MAX_TPR = 256      # and backward (csrc/rmsnorm_bwd.cu: kBlock)
MAX_NV = 8             # packs a thread keeps in registers: forward, vector template
PAIR_NV = 2            # scalar template, gated forward, backward


class Template(NamedTuple):
    """The layout of one call: ``vec`` elements per access (16 bytes' worth,
    or 1 — the scalar template), ``nv`` packs kept in registers per thread
    (0: the two-pass loop over rows wider than the registers hold), ``tpr``
    threads per row (a power of two up to 32, else a multiple of 32)."""
    vec: int
    nv: int
    tpr: int

    def describe(self) -> str:
        kind = "scalar" if self.vec == 1 else f"vec{self.vec}"
        return f"{kind} {'two-pass' if self.nv == 0 else f'nv{self.nv}'} tpr{self.tpr}"


def _template(D: int, dtype: torch.dtype, *ptrs: int, backward: bool = False,
              gated: bool = False) -> Template:
    """The template a row of ``D`` elements of ``dtype`` runs, given the data
    pointers of the call: 16-byte packs when every pointer is 16-byte aligned
    and D is a multiple of the pack, else the scalar template.  One or two
    packs a thread and as few lanes as hold the row (several rows a warp);
    wider rows over as many warps as hold them at two packs a thread (on the
    H100 two packs ran ahead of four and eight at the configs' widths), at
    four or eight only where 512 threads of two would not hold the row; past
    that, the two-pass loop.  The scalar template, the gated forward and the
    backward keep to two packs (the registers of x and z, or x, g and the
    next row's); the backward to 256 threads a row."""
    vec = PACK_BYTES // dtype.itemsize
    if D % vec or any(p % PACK_BYTES for p in ptrs):
        vec = 1
    nvec = D // vec
    choices = (2,) if vec == 1 else (1, 2) if backward or gated else (1, 2, 4, 8)
    for nv in choices[:2]:
        lanes = -(-nvec // nv)
        if lanes <= 32:
            return Template(vec, nv, 1 << (lanes - 1).bit_length())
    max_tpr = BWD_MAX_TPR if backward else MAX_TPR
    for nv in choices:
        tpr = 32 * -(-nvec // (32 * nv))
        if nv >= 2 and tpr <= max_tpr:
            return Template(vec, nv, tpr)
    return Template(vec, 0, max_tpr)


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check(name: str, x: torch.Tensor, scale: torch.Tensor, *like_x: torch.Tensor) -> int:
    """The kernels' input rules; returns D.  ``like_x``: tensors that must
    match x (the gate, the output grad)."""
    tensors = (x, scale, *like_x)
    on_card = x.device.type == "cuda" or _fake.is_fake(*tensors)
    if not on_card or any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in tensors]}; the kernel "
                         "takes them all on one CUDA device")
    if x.dtype not in _DTYPE_CODES or scale.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtypes x={x.dtype} scale={scale.dtype}")
    D = x.shape[-1]
    if scale.shape != (D,):
        raise ValueError(f"{name}: scale shape {tuple(scale.shape)} != ({D},)")
    for t in like_x:
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} does not match x "
                             f"{tuple(x.shape)} {x.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    return D


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
            gate: torch.Tensor | None = None) -> torch.Tensor:
    """x: (..., D); scale: (D,); ``gate``: None, or z of x's shape and dtype,
    and then the norm of ``x * silu(z)``.  Output in x's dtype."""
    extra = () if gate is None else (gate,)
    if _on_cpu(x, scale, *extra):
        if gate is None:
            return rmsnorm_reference(x, scale, eps)
        return gated_rmsnorm_reference(x, gate, scale, eps)
    D = _check("rmsnorm", x, scale, *extra)
    out = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out
    if _fake.is_fake(x, scale, *extra):
        flops = rows * D * (4.0 if gate is None else 9.0)
        _fake.record("rmsnorm", (x, scale, *extra), flops, _fake.nbytes(x, scale, out, *extra))
        return out
    ptrs = [t.data_ptr() for t in (x, scale, out, *extra)]
    tpl = _template(D, x.dtype, *ptrs, gated=gate is not None)
    fn = _build.function("repro_rmsnorm_fwd", _FWD_ARGTYPES)
    rc = fn(x.data_ptr(), gate.data_ptr() if gate is not None else None, scale.data_ptr(),
            out.data_ptr(), rows, D, float(eps), _DTYPE_CODES[x.dtype],
            _DTYPE_CODES[scale.dtype], tpl.vec, tpl.nv, tpl.tpr,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "rmsnorm")
    rmsnorm.launches += 1
    if gate is not None:
        rmsnorm.gated_launches += 1
    return out


rmsnorm.launches = 0
rmsnorm.gated_launches = 0
rmsnorm.backward_launches = 0
COUNTERS = ((rmsnorm, "launches"), (rmsnorm, "gated_launches"), (rmsnorm, "backward_launches"))


@functools.lru_cache(maxsize=256)
def _bwd_grid(device: int, rows: int, D: int, x_code: int, s_code: int, tpl: Template) -> int:
    """Blocks (= dscale partial rows) of one backward launch: the kernel's
    occupancy on ``device`` times its SMs, at most one per row group."""
    grid = ctypes.c_int(0)
    fn = _build.function("repro_rmsnorm_bwd_grid", _GRID_ARGTYPES)
    with torch.cuda.device(device):
        rc = fn(rows, D, x_code, s_code, tpl.vec, tpl.nv, tpl.tpr, ctypes.byref(grid))
    _build.check(rc, "rmsnorm backward grid")
    return grid.value


def rmsnorm_backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                     eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of ``rmsnorm(x, scale, eps)`` for its output grad ``g``
    (x's shape and dtype): dx in x's dtype, dscale in scale's, both from
    fp32 statistics recomputed from x."""
    if _on_cpu(x, scale, g):
        return rmsnorm_backward_reference(x, scale, g, eps)
    D = _check("rmsnorm backward", x, scale, g)
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return dx, dscale.zero_()
    x_code, s_code = _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype]
    if _fake.is_fake(x, scale, g):
        # the workspace, its grid from an H100's SMs at one block of 2048 /
        # tpr threads each (the launch asks the device's occupancy)
        tpl = _template(D, x.dtype, backward=True)
        torch.empty((_grid(rows, tpl.tpr, _fake.H100_SMS), D), dtype=torch.float32,
                    device=x.device)
        _fake.record("rmsnorm_backward", (x, scale, g), 8.0 * rows * D,
                     _fake.nbytes(x, scale, g, dx, dscale))
        return dx, dscale
    tpl = _template(D, x.dtype, *(t.data_ptr() for t in (x, scale, g, dx)), backward=True)
    grid = _bwd_grid(x.device.index, rows, D, x_code, s_code, tpl)
    partial = torch.empty((grid, D), dtype=torch.float32, device=x.device)
    fn = _build.function("repro_rmsnorm_bwd", _BWD_ARGTYPES)
    rc = fn(x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(), partial.data_ptr(),
            dscale.data_ptr(), rows, D, float(eps), x_code, s_code, tpl.vec, tpl.nv, tpl.tpr,
            grid, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "rmsnorm backward")
    rmsnorm.backward_launches += 1
    return dx, dscale


class _RMSNorm(torch.autograd.Function):
    """``rmsnorm`` under autograd.  The forward is the kernel (its plain
    version on CPU tensors) and saves only x and scale; the backward is
    ``rmsnorm_backward``, which recomputes the fp32 statistics from them —
    the counterpart of the JAX package's no-save ``jax.checkpoint`` around
    its jnp body."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_backward(x, scale, g.contiguous(), ctx.eps)
        return dx, dscale, None


def rmsnorm_autograd(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``rmsnorm`` with a recomputing backward: dx in x's dtype, dscale in
    scale's (fp32 for the fp32 master weights).  With nothing to
    differentiate (serving under ``no_grad``) it calls ``rmsnorm`` directly
    and spends no host time on the autograd function."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    return rmsnorm(x, scale, eps)


# --------------------------------------------------------------------------
# the split-row form (a row whose columns are split over a group of ranks)
# --------------------------------------------------------------------------

_SUMSQ_ARGTYPES = (_P, _P, _LL, _I, _I, _I, _I, _P)
_SPLIT_FWD_ARGTYPES = (_P, _P, _P, _P, _LL, _I, _I, _F, _I, _I, _I, _I, _P)
_SPLIT_DOT_ARGTYPES = (_P, _P, _P, _P, _P, _LL, _I, _I, _F, _I, _I, _I, _I, _I, _P)
_SPLIT_BWD_ARGTYPES = (_P,) * 8 + (_LL, _I, _I, _F, _I, _I, _I, _I, _I, _I, _P)


def _check_stat(name: str, x: torch.Tensor, *stats: torch.Tensor) -> None:
    for s in stats:
        if (s.shape != x.shape[:-1] or s.dtype != torch.float32 or s.device != x.device
                or not s.is_contiguous()):
            raise ValueError(f"{name}: a row statistic {tuple(s.shape)} {s.dtype} on "
                             f"{s.device}; the kernel takes contiguous fp32 "
                             f"{tuple(x.shape[:-1])} on {x.device}")


def _check_width(name: str, D: int, width: int) -> None:
    if width < D:
        raise ValueError(f"{name}: the whole row's width {width} is less than this "
                         f"rank's {D} columns")


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def rmsnorm_split_sumsq(x: torch.Tensor) -> torch.Tensor:
    """Pass 1 of the split forward: each row's fp32 Σ x² over x's columns,
    shape ``x.shape[:-1]``."""
    if _on_cpu(x):
        return rmsnorm_split_sumsq_reference(x)
    on_card = x.device.type == "cuda" or _fake.is_fake(x)
    if not on_card or x.dtype not in _DTYPE_CODES or not x.is_contiguous():
        raise ValueError(f"rmsnorm split sumsq: x {x.dtype} on {x.device}; the kernel takes "
                         "a contiguous float32, bfloat16 or float16 CUDA tensor")
    D = x.shape[-1]
    ss = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rows = ss.numel()
    if rows == 0 or D == 0:
        return ss.zero_()
    if _fake.is_fake(x):
        _fake.record("rmsnorm_split_sumsq", (x,), 2.0 * rows * D, _fake.nbytes(x, ss))
        return ss
    tpl = _template(D, x.dtype, x.data_ptr())
    fn = _build.function("repro_rmsnorm_split_sumsq", _SUMSQ_ARGTYPES)
    _build.check(fn(x.data_ptr(), ss.data_ptr(), rows, D, _DTYPE_CODES[x.dtype], tpl.vec,
                    tpl.tpr, _stream(x)), "rmsnorm split sumsq")
    rmsnorm_split_sumsq.launches += 1
    return ss


def rmsnorm_split(x: torch.Tensor, scale: torch.Tensor, stat: torch.Tensor, width: int,
                  eps: float = 1e-5) -> torch.Tensor:
    """Pass 2 of the split forward: x's D columns normalised with r =
    rsqrt(stat / width + eps) and scaled by ``scale`` (D,), this rank's
    slice; ``stat`` (``x.shape[:-1]``, fp32) is the row's Σ x² over all
    ``width`` columns.  Output in x's dtype."""
    if _on_cpu(x, scale, stat):
        return rmsnorm_split_reference(x, scale, stat, width, eps)
    D = _check("rmsnorm split", x, scale)
    _check_stat("rmsnorm split", x, stat)
    _check_width("rmsnorm split", D, width)
    out = torch.empty_like(x)
    rows = stat.numel()
    if rows == 0 or D == 0:
        return out
    if _fake.is_fake(x, scale, stat):
        _fake.record("rmsnorm_split", (x, scale, stat), 3.0 * rows * D,
                     _fake.nbytes(x, scale, stat, out))
        return out
    tpl = _template(D, x.dtype, x.data_ptr(), scale.data_ptr(), out.data_ptr())
    fn = _build.function("repro_rmsnorm_split_fwd", _SPLIT_FWD_ARGTYPES)
    _build.check(fn(x.data_ptr(), scale.data_ptr(), stat.data_ptr(), out.data_ptr(), rows, D,
                    width, float(eps), _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype],
                    tpl.vec, tpl.tpr, _stream(x)), "rmsnorm split")
    rmsnorm_split.launches += 1
    return out


def rmsnorm_split_dot(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                      stat: torch.Tensor, width: int, eps: float = 1e-5) -> torch.Tensor:
    """Pass 1 of the split backward: each row's fp32 Σ gs·x̂ over x's
    columns (x̂ = x·r with r from ``stat`` as the forward's, gs =
    g·scale), shape ``x.shape[:-1]``."""
    if _on_cpu(x, scale, g, stat):
        return rmsnorm_split_dot_reference(x, scale, g, stat, width, eps)
    D = _check("rmsnorm split dot", x, scale, g)
    _check_stat("rmsnorm split dot", x, stat)
    _check_width("rmsnorm split dot", D, width)
    dot = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rows = dot.numel()
    if rows == 0 or D == 0:
        return dot.zero_()
    if _fake.is_fake(x, scale, g, stat):
        _fake.record("rmsnorm_split_dot", (x, scale, g, stat), 4.0 * rows * D,
                     _fake.nbytes(x, scale, g, stat, dot))
        return dot
    tpl = _template(D, x.dtype, x.data_ptr(), scale.data_ptr(), g.data_ptr(), backward=True)
    fn = _build.function("repro_rmsnorm_split_dot", _SPLIT_DOT_ARGTYPES)
    _build.check(fn(x.data_ptr(), scale.data_ptr(), g.data_ptr(), stat.data_ptr(),
                    dot.data_ptr(), rows, D, width, float(eps), _DTYPE_CODES[x.dtype],
                    _DTYPE_CODES[scale.dtype], tpl.vec, tpl.nv, tpl.tpr, _stream(x)),
                 "rmsnorm split dot")
    rmsnorm_split_dot.launches += 1
    return dot


def _grid(rows: int, tpr: int, sms: int) -> int:
    """Blocks (= dscale partial rows) of one split backward launch: one row
    group of ``tpr`` threads a block, as many as fill ``sms`` SMs' 2048
    threads once, at most one a row."""
    return max(1, min(rows, sms * max(1, 2048 // tpr)))


def rmsnorm_split_backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                           stat: torch.Tensor, dot: torch.Tensor, width: int,
                           eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass 2 of the split backward: (dx, dscale) for x's D columns, with
    ``stat`` and ``dot`` the row's Σ x² and Σ gs·x̂ over all ``width``
    columns: dx = r·(gs − x̂·dot / width) in x's dtype, dscale = Σ_rows g·x̂
    in scale's (two launches: the rows, then the column sums)."""
    if _on_cpu(x, scale, g, stat, dot):
        return rmsnorm_split_backward_reference(x, scale, g, stat, dot, width, eps)
    D = _check("rmsnorm split backward", x, scale, g)
    _check_stat("rmsnorm split backward", x, stat, dot)
    _check_width("rmsnorm split backward", D, width)
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    rows = stat.numel()
    if rows == 0 or D == 0:
        return dx, dscale.zero_()
    if _fake.is_fake(x, scale, g, stat, dot):
        tpl = _template(D, x.dtype, backward=True)
        torch.empty((_grid(rows, tpl.tpr, _fake.H100_SMS), D), dtype=torch.float32,
                    device=x.device)
        _fake.record("rmsnorm_split_backward", (x, scale, g, stat, dot), 8.0 * rows * D,
                     _fake.nbytes(x, scale, g, stat, dot, dx, dscale))
        return dx, dscale
    tpl = _template(D, x.dtype, *(t.data_ptr() for t in (x, scale, g, dx)), backward=True)
    sms = torch.cuda.get_device_properties(x.device.index).multi_processor_count
    grid = _grid(rows, tpl.tpr, sms)
    partial = torch.empty((grid, D), dtype=torch.float32, device=x.device)
    fn = _build.function("repro_rmsnorm_split_bwd", _SPLIT_BWD_ARGTYPES)
    _build.check(fn(x.data_ptr(), scale.data_ptr(), g.data_ptr(), stat.data_ptr(),
                    dot.data_ptr(), dx.data_ptr(), partial.data_ptr(), dscale.data_ptr(), rows,
                    D, width, float(eps), _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype],
                    tpl.vec, tpl.nv, tpl.tpr, grid, _stream(x)), "rmsnorm split backward")
    rmsnorm_split_backward.launches += 1
    return dx, dscale


rmsnorm_split_sumsq.launches = 0
rmsnorm_split.launches = 0
rmsnorm_split_dot.launches = 0
rmsnorm_split_backward.launches = 0
SPLIT_COUNTERS = ((rmsnorm_split_sumsq, "launches"), (rmsnorm_split, "launches"),
                  (rmsnorm_split_dot, "launches"), (rmsnorm_split_backward, "launches"))


class _RMSNormSplit(torch.autograd.Function):
    """The split form under autograd: pass 1, an fp32 all-reduce of the row
    sums over ``group``, pass 2.  It saves x, the scale slice and the
    reduced (R,) statistic, so its backward makes one all-reduce (of the
    row dot), not two: it departs from the whole-row ``_RMSNorm``, and from
    the JAX package's no-save ``jax.checkpoint`` around its norm, only by
    those R floats.  ``plain`` runs the plain versions on any device."""

    @staticmethod
    def forward(ctx, x, scale, eps, width, group, plain):
        sumsq = rmsnorm_split_sumsq_reference if plain else rmsnorm_split_sumsq
        stat = collectives.all_reduce(sumsq(x), group)
        ctx.save_for_backward(x, scale, stat)
        ctx.args = (eps, width, group, plain)
        fwd = rmsnorm_split_reference if plain else rmsnorm_split
        return fwd(x, scale, stat, width, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, stat = ctx.saved_tensors
        eps, width, group, plain = ctx.args
        g = g.contiguous()
        dot_fn = rmsnorm_split_dot_reference if plain else rmsnorm_split_dot
        bwd = rmsnorm_split_backward_reference if plain else rmsnorm_split_backward
        dot = collectives.all_reduce(dot_fn(x, scale, g, stat, width, eps), group)
        dx, dscale = bwd(x, scale, g, stat, dot, width, eps)
        return dx, dscale, None, None, None, None


def rmsnorm_split_autograd(x: torch.Tensor, scale_cols: torch.Tensor, eps: float, width: int,
                           group, plain: bool = False) -> torch.Tensor:
    """RMSNorm of rows whose ``width`` columns are split over ``group``
    (``launch.mesh.AxisGroup``): x holds this rank's columns and
    ``scale_cols`` its slice of the scale; the statistics are the whole
    row's.  Differentiable in x and ``scale_cols`` (dscale is this rank's
    slice's, from its columns alone).  Off a mesh, or on a group of one, the
    caller runs the whole-row ``rmsnorm_autograd`` instead."""
    return _RMSNormSplit.apply(x.contiguous(), scale_cols.contiguous(), eps, width, group,
                               plain)
