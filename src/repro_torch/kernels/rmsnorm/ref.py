"""Plain PyTorch version of the fused RMSNorm kernel (the port's
``rmsnorm_reference``): the CPU path of ``ops.rmsnorm`` and the oracle the
CUDA kernel is held against on the card."""
from __future__ import annotations

import torch


def rmsnorm_reference(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); scale: (D,).  fp32 statistics, output in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
