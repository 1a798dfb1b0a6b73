"""Plain PyTorch versions of K2's kernels: the CPU path of ``ops.rmsnorm``
(gated or not) and of ``ops.rmsnorm_backward``, and the oracles the CUDA
kernels are held against on the card."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm_reference(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); scale: (D,).  fp32 statistics, output in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def gated_rmsnorm_reference(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                            eps: float = 1e-5) -> torch.Tensor:
    """Mamba2's gate norm ``rmsnorm(x * silu(z))``, z of x's shape and dtype:
    silu(z) and the product each rounded to x's dtype, as the eager
    composition rounds them, then fp32 statistics."""
    return rmsnorm_reference(x * F.silu(z), scale, eps)


def rmsnorm_backward_reference(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                               eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of ``rmsnorm_reference(x, scale, eps)`` for the output
    grad ``g``, recomputing the fp32 statistics from x: with r = rsqrt(mean
    x² + eps), x̂ = x·r and gs = g·scale, dx = r·(gs − x̂·mean(gs·x̂)) in x's
    dtype and dscale = Σ_rows g·x̂ in scale's."""
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * r
    gs = g.float() * scale.float()
    dx = r * (gs - xhat * torch.mean(gs * xhat, dim=-1, keepdim=True))
    dscale = (g.float() * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)
