"""Plain PyTorch versions of K2's kernels: the CPU path of ``ops.rmsnorm``
(gated or not), of ``ops.rmsnorm_backward`` and of the split-row form's four
passes, and the oracles the CUDA kernels are held against on the card."""
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


# --------------------------------------------------------------------------
# the split-row form: this rank's D of a row's ``width`` columns
# --------------------------------------------------------------------------

def rmsnorm_split_sumsq_reference(x: torch.Tensor) -> torch.Tensor:
    """Pass 1 of the split forward: each row's fp32 Σ x² over x's columns,
    shape ``x.shape[:-1]``."""
    xf = x.float()
    return (xf * xf).sum(dim=-1)


def rmsnorm_split_reference(x: torch.Tensor, scale: torch.Tensor, stat: torch.Tensor,
                            width: int, eps: float = 1e-5) -> torch.Tensor:
    """Pass 2 of the split forward: x's columns normalised with r =
    rsqrt(stat / width + eps), ``stat`` the row's Σ x² over all ``width``
    columns (the sum of every rank's pass 1), and scaled by ``scale``, this
    rank's slice of the scale; output in x's dtype."""
    r = torch.rsqrt(stat.float().unsqueeze(-1) / width + eps)
    return (x.float() * r * scale.float()).to(x.dtype)


def rmsnorm_split_dot_reference(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                                stat: torch.Tensor, width: int,
                                eps: float = 1e-5) -> torch.Tensor:
    """Pass 1 of the split backward: each row's fp32 Σ gs·x̂ over x's
    columns, with x̂ = x·r, r from ``stat`` as the forward's and gs =
    g·scale."""
    r = torch.rsqrt(stat.float().unsqueeze(-1) / width + eps)
    return (g.float() * scale.float() * (x.float() * r)).sum(dim=-1)


def rmsnorm_split_backward_reference(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                                     stat: torch.Tensor, dot: torch.Tensor, width: int,
                                     eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass 2 of the split backward: with ``dot`` the row's Σ gs·x̂ over all
    ``width`` columns, dx = r·(gs − x̂·dot / width) in x's dtype and dscale =
    Σ_rows g·x̂ for x's columns in scale's dtype (``rmsnorm_backward_reference``
    with the row's statistics taken over the whole row)."""
    xf = x.float()
    r = torch.rsqrt(stat.float().unsqueeze(-1) / width + eps)
    xhat = xf * r
    gs = g.float() * scale.float()
    dx = r * (gs - xhat * (dot.float().unsqueeze(-1) / width))
    dscale = (g.float() * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)
