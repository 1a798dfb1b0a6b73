"""RMSNorm entry point: the CUDA kernel on a CUDA tensor, the plain version
on a CPU tensor.

Replaces the TPU kernel ``repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas``
(body ``_rmsnorm_kernel``) with ``csrc/rmsnorm.cu``.  What bounds it on the
H100: bytes — one read and one write of every element at 3.35 TB/s, a few
flops each.  The design reads each row with coalesced strided loads, reduces
the fp32 sum of squares in registers and warp shuffles (one shared-memory
step for 256-thread rows), and re-reads the row from cache for the output,
so device memory sees one read and one write.

``rmsnorm.launches`` counts kernel launches (plain-version calls on the CPU
do not count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); scale: (D,).  Output in x's dtype."""
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return rmsnorm_reference(x, scale, eps)
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, scale on {scale.device}; "
                         "the kernel takes both on one CUDA device")
    if x.dtype not in _DTYPE_CODES or scale.dtype not in _DTYPE_CODES:
        raise TypeError(f"rmsnorm: unsupported dtypes x={x.dtype} scale={scale.dtype}")
    D = x.shape[-1]
    if scale.shape != (D,):
        raise ValueError(f"rmsnorm: scale shape {tuple(scale.shape)} != ({D},)")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: the kernel takes contiguous x and scale")
    out = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out
    fn = _build.function("repro_rmsnorm_fwd", _ARGTYPES)
    rc = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D, float(eps),
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0


class _RMSNorm(torch.autograd.Function):
    """``rmsnorm`` under autograd.  The forward is the kernel (its plain
    version on CPU tensors) and saves only x and scale; the backward
    recomputes the fp32 statistics in plain torch ops — the counterpart of
    the JAX package's no-save ``jax.checkpoint`` around its jnp body, whose
    backward is compiled jnp, not a Pallas kernel."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        xf = x.float()
        r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + ctx.eps)
        xhat = xf * r
        gs = g.float() * scale.float()
        dx = r * (gs - xhat * torch.mean(gs * xhat, dim=-1, keepdim=True))
        dscale = (g.float() * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def rmsnorm_autograd(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``rmsnorm`` with a recomputing backward: dx in x's dtype, dscale in
    scale's (fp32 for the fp32 master weights).  With nothing to
    differentiate (serving under ``no_grad``) it calls ``rmsnorm`` directly
    and spends no host time on the autograd function."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    return rmsnorm(x, scale, eps)
