"""Rotary position embeddings (computed on the fly from integer positions)."""
from __future__ import annotations

import torch


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions: (S,) or per-slot (B, S) ints -> cos/sin of shape
    (..., S, head_dim//2), fp32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B, S, hd//2) or (S, hd//2). Rotate-half convention."""
    dtype = x.dtype
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    if cos.dim() == x.dim() - 2:     # (S, hd/2) -> broadcast over batch+heads
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:                             # (B, S, hd/2) -> broadcast over heads
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(dtype)
