"""Plain PyTorch version of the flash-attention forward kernel.

Same semantics as ``repro/kernels/flash_attention/kernel.py::
flash_attention_fwd``: q (B, Sq, H, hd), k/v (B, Sk, KV, hd) with
``H % KV == 0`` (compact GQA heads, expanded here as ``repeat_interleave``
does: query head h reads kv head h // (H // KV); KV == H is the JAX
kernel's own case), upcast to fp32 before both products; the causal mask
comes from the row/column index or, when ``q_pos`` is given, from explicit
positions (``k_pos <= q_pos``); masked scores take the finite ``NEG_INF``,
so a fully masked row yields the mean of v; ``return_residuals`` adds the
softmax stats m (row max) and l (sum of exp(s - m)), both (B, H, Sq) fp32.
Scores are materialised in full: this is the CPU path of
``ops.flash_attention_fwd`` and the oracle the CUDA kernel is held against
on the card.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -0.7 * float(np.finfo(np.float32).max)


def _positions(pos, B: int, S: int, device) -> torch.Tensor:
    """(S,) or (B, S) int positions -> (B, S) int64."""
    pos = torch.as_tensor(pos, device=device).long()
    return pos.expand(B, S) if pos.dim() == 1 else pos


def expand_heads(k, v, num_heads: int):
    """k/v (B, S, KV, hd) -> (B, S, num_heads, hd), each kv head repeated
    num_heads // KV times in place."""
    KV = k.shape[2]
    if num_heads % KV:
        raise ValueError(f"{num_heads} query heads are not a multiple of {KV} kv heads")
    if KV == num_heads:
        return k, v
    g = num_heads // KV
    return k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)


def flash_attention_fwd(q, k, v, *, causal: bool = True, q_pos=None, k_pos=None,
                        return_residuals: bool = False):
    """q (B, Sq, H, hd), k/v (B, Sk, KV, hd) -> out (B, Sq, H, hd) in q's
    dtype, or (out, m, l) with ``return_residuals``."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    k, v = expand_heads(k, v, H)
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bqhd,bshd->bhqs", qf, kf) * (hd ** -0.5)
    if causal:
        if q_pos is not None:
            if k_pos is None:
                raise ValueError("q_pos requires k_pos")
            qp = _positions(q_pos, B, Sq, q.device)
            kp = _positions(k_pos, B, Sk, q.device)
        else:
            qp = torch.arange(Sq, device=q.device).expand(B, Sq)
            kp = torch.arange(Sk, device=q.device).expand(B, Sk)
        mask = kp[:, None, None, :] <= qp[:, None, :, None]          # (B,1,Sq,Sk)
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqs,bshd->bqhd", p, vf)
    out = (o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]).to(q.dtype)
    if return_residuals:
        return out, m, l
    return out
