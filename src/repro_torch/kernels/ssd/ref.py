"""Plain PyTorch versions of the Mamba2 SSD (state-space duality) scan: the
CPU path of ``ops.ssd`` and the oracles the CUDA kernel is held against on
the card.  Same formulas and fp32 upcasts as ``repro.kernels.ssd.ref``.

Semantics (per batch b, head h, state n, channel p):

    S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * B_t[n] * x_t[p]
    y_t[p] = sum_n C_t[n] * S_t[n, p]

Heads are grouped: head h reads B/C from group ``h // (H // G)``.

``ssd_naive`` steps through S in a Python loop (the ground truth, for small
shapes); ``ssd_chunked`` is the blocked algorithm the kernel computes.
Unlike the JAX oracle, ``ssd_chunked`` takes any S: the last chunk is padded
with dt = 0 and x = B = C = 0, whose decay is exp(0) = 1 and whose update is
0, so the final state is exact and the padded rows of y are dropped.  The
JAX entry point instead halves the chunk until it divides S (an odd S gives
chunk 1, a step-by-step recurrence).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _expand_groups(bc: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, G, N) -> (B, S, H, N) by repeating each group H//G times."""
    return torch.repeat_interleave(bc, num_heads // bc.shape[2], dim=2)


def ssd_step(state, x_t, dt_t, A, B_t, C_t):
    """One recurrent step (decode, and the naive oracle's body).

    state: (B, H, N, P); x_t: (B, H, P); dt_t: (B, H); A: (H,);
    B_t/C_t: (B, H, N) (already group-expanded).  Returns (new_state, y_t).
    """
    decay = torch.exp(dt_t * A[None, :])[..., None, None]            # (B,H,1,1)
    update = dt_t[..., None, None] * B_t[..., :, None] * x_t[..., None, :]
    new_state = decay * state + update                                # (B,H,N,P)
    y = torch.einsum("bhn,bhnp->bhp", C_t, new_state)
    return new_state, y


def _zero_state(x: torch.Tensor, N: int) -> torch.Tensor:
    Bsz, _, H, P = x.shape
    return torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)


def ssd_naive(x, dt, A, B, C, initial_state: Optional[torch.Tensor] = None):
    """x: (B,S,H,P) fp32; dt: (B,S,H) > 0; A: (H,) < 0; B/C: (B,S,G,N).
    Returns (y (B,S,H,P), final_state (B,H,N,P))."""
    H = x.shape[2]
    Bh, Ch = _expand_groups(B, H), _expand_groups(C, H)
    state = initial_state if initial_state is not None else _zero_state(x, B.shape[-1])
    ys = []
    for t in range(x.shape[1]):
        state, y = ssd_step(state, x[:, t], dt[:, t], A, Bh[:, t], Ch[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), state


def _segsum(da: torch.Tensor) -> torch.Tensor:
    """da: (..., Q) -> L[..., i, j] = sum_{j < m <= i} da_m (-inf above the
    diagonal)."""
    Q = da.shape[-1]
    cs = torch.cumsum(da, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=da.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B, C, chunk: int = 64,
                initial_state: Optional[torch.Tensor] = None):
    """Blocked SSD: intra-chunk quadratic form + inter-chunk recurrence.

    Shapes as in ``ssd_naive``; any S (the last chunk is padded, see the
    module note).  Returns (y (B,S,H,P) in x's dtype, final_state (B,H,N,P)
    fp32)."""
    Bsz, S, H, P = x.shape
    N = B.shape[-1]
    Q = chunk
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t: torch.Tensor) -> torch.Tensor:       # pad S, split into chunks
        t = t.float()
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(Bsz, nc, Q, *t.shape[2:])

    xc = chunks(x)                                                   # (B,nc,Q,H,P)
    dtc = chunks(dt)                                                 # (B,nc,Q,H)
    Bh = chunks(_expand_groups(B, H))                                # (B,nc,Q,H,N)
    Ch = chunks(_expand_groups(C, H))

    da = dtc * A[None, None, None, :]
    cum = torch.cumsum(da, dim=2)                                    # (B,nc,Q,H)
    total = cum[:, :, -1, :]                                         # (B,nc,H)

    # ---- intra-chunk (the "dual" quadratic form, masked by decay) -------
    L = _segsum(da.movedim(2, -1))                                   # (B,nc,H,Q,Q)
    CB = torch.einsum("bcihn,bcjhn->bchij", Ch, Bh)
    M = CB * torch.exp(L)
    M = M * dtc.movedim(2, -1)[:, :, :, None, :]                     # x dt_j
    y_intra = torch.einsum("bchij,bcjhp->bcihp", M, xc)

    # ---- chunk state contributions ----------------------------------------
    w = torch.exp(total[:, :, None, :] - cum) * dtc                  # (B,nc,Q,H)
    contrib = torch.einsum("bcjhn,bcjh,bcjhp->bchnp", Bh, w, xc)     # (B,nc,H,N,P)

    # ---- inter-chunk recurrence, in closed form ---------------------------
    # The state entering chunk z is sum_{c <= z} exp(sum_{c < m <= z} t_m) s_c
    # over s = (initial state, contrib_0, ..., contrib_{nc-1}) and t = (0,
    # total_0, ..., total_{nc-1}): one masked decay product over the chunks
    # in place of a loop of nc steps (a handful of launches, not ~6·nc).
    state = initial_state if initial_state is not None else _zero_state(x, N)
    states = torch.cat([state[:, None], contrib], dim=1)             # (B,nc+1,H,N,P)
    decay = torch.exp(_segsum(F.pad(total, (0, 0, 1, 0)).movedim(1, -1)))   # (B,H,nc+1,nc+1)
    states = torch.einsum("bhzc,bchnp->bzhnp", decay, states)       # entering each chunk
    y_inter = torch.einsum("bcihn,bchnp->bcihp", Ch * torch.exp(cum)[..., None], states[:, :-1])
    y = (y_intra + y_inter).reshape(Bsz, nc * Q, H, P)[:, :S]
    return y.to(x.dtype), states[:, -1]
