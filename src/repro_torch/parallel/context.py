"""Context parallelism: ring attention over the ``cp`` process group (the
port of ``repro.parallel.context``).

Megatron-SP shards the sequence only between blocks; context parallelism
shards it through attention.  Each of ``cp`` ranks holds an ``S / cp``
query shard, and the K/V blocks go round a ring while the online-softmax
partials ``(o, m, l)`` of every step merge into the rank's running ones
(:func:`merge_partials`), the merge the flash kernel performs across its
key tiles, lifted to the ranks.

The split is JAX's **zig-zag**: the sequence is cut into ``2·cp`` chunks
and rank ``r`` holds chunks ``r`` and ``2·cp-1-r``, so under causal masking
every rank holds one early and one late chunk and every ring step carries
work on every rank.  ``S % (2·cp) == 0`` is required (:func:`validate_cp`,
the verifier's GALV010).

Where JAX works on global arrays and lets GSPMD move each layer's q/k/v
into zig-zag order, the port holds local shards from the start: the
runtime hands each rank its zig-zag chunks of the tokens and labels
(:func:`zigzag_shard`), RoPE takes the rank's global positions
(:func:`zigzag_positions`), and attention runs
:func:`ring_attention_local` on the rank's shard with compact K/V.  Its
steps:

* step 0: the local q against the local K/V, causal over the zig-zag
  positions (one K1 call, ``q_pos = k_pos``);
* step t: the K/V of rank ``s = (r - t) mod cp`` arrive.  If ``s < r``
  every local query sees the block's early chunk and none of its late one:
  one non-causal call, (Sq, Sk) = (S/cp, S/2cp).  If ``s > r`` only the
  local late chunk sees anything, and it sees the whole block: one
  non-causal call, (S/2cp, S/cp).  What this skips is exactly what every
  position mask hides, whose weight in the merge is ``l·exp(NEG_INF - m) =
  0``, so the function is JAX's; K1 turns its tile skipping off for a block
  that holds a fully masked row, so the positional form would run a full,
  useless pass over half of each later step's rows.

The partials come from K1 (``kernels/flash_attention/ops.py::
flash_attention_fwd``, ``return_residuals=True``) on CUDA tensors under
``impl="kernel"``, from its plain version on CPU tensors and under
``impl="ref"``.  No positions travel the ring: the source rank of each step
is known.  Training wraps the ring in an autograd function whose forward
saves q, k, v, the output and the log-sum-exp, and whose backward goes
round the ring again, as JAX's ``jax.checkpoint(nothing_saveable)``
recomputes: each step's dq, dk and dv from the final log-sum-exp and
``D = rowsum(dO ∘ O)``, in plain torch one query block at a time, the dk/dv
accumulators travelling with their K/V and arriving back at their owner
after the last step.  No step's probabilities are saved.

The ring's hop is ``collectives.StageHop`` over the ``cp`` axis: each
tick's sends and receives in one ``batch_isend_irecv``, staged through
pinned host buffers under gloo on CUDA (gloo cannot send a CUDA tensor).
Each rank's ring is written once, as a generator that yields what it sends
and receives what the previous rank sent; :func:`_drive` runs it over a
hop, :func:`_lockstep` runs every rank's in one process.

The plain references, as JAX's:

* :func:`ring_attention` (``use_flash=False``): the serial positional ring
  on natural-order (B, S, H, hd) q and compact K/V, the counterpart of JAX's
  ``mesh=None`` path (its "numerical oracle"), differentiated by autograd;
* :func:`ring_attention` (``use_flash=True``): every rank's half-block ring
  on K1's partials (the plain version's on CPU tensors), run in one
  process, forward and backward (JAX's ``_serial_flash_ring`` is its
  forward);
* :func:`positional_ring_local`: JAX's per-rank ``_ring_local`` with plain
  partials over a hop, differentiated by autograd through
  ``collectives.ring_shift`` (it keeps every step's probabilities: an
  oracle, not a training path).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.parallel import collectives

NEG_INF = -0.7 * float(np.finfo(np.float32).max)
BLOCK_Q = 512                 # query rows a backward step recomputes at once


# --------------------------------------------------------------------------
# zig-zag layout
# --------------------------------------------------------------------------

def validate_cp(seq_len: int, cp: int) -> None:
    """A cp degree is realisable iff the sequence splits into 2·cp equal
    zig-zag chunks (the verifier's GALV010)."""
    from repro_torch.analysis.invariants import cp_seq_divisible

    if cp < 1:
        raise ValueError(f"cp must be >= 1, got {cp}")
    if not cp_seq_divisible(seq_len, cp):
        raise ValueError(
            f"context parallelism needs seq_len % (2*cp) == 0 for the "
            f"zig-zag split; got seq_len={seq_len}, cp={cp}")


def zigzag_permutation(seq_len: int, cp: int) -> np.ndarray:
    """Gather indices putting the sequence in zig-zag order: block ``r``
    (length S/cp) holds chunks ``r`` and ``2·cp-1-r`` of the natural order,
    so contiguous S/cp shards are the ranks' shards."""
    validate_cp(seq_len, cp)
    c = seq_len // (2 * cp)
    chunks = []
    for r in range(cp):
        chunks.append(np.arange(r * c, (r + 1) * c))
        chunks.append(np.arange((2 * cp - 1 - r) * c, (2 * cp - r) * c))
    return np.concatenate(chunks)


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


def zigzag_positions(seq_len: int, cp: int, index: int, device=None) -> torch.Tensor:
    """Rank ``index``'s global positions, (S/cp,) int32: its shard of the
    zig-zag order."""
    n = seq_len // cp
    pos = zigzag_permutation(seq_len, cp)[index * n:(index + 1) * n]
    return torch.from_numpy(pos.astype(np.int32)).to(device)


def zigzag_shard(x: torch.Tensor, dim: int, index: int, cp: int) -> torch.Tensor:
    """Rank ``index``'s zig-zag chunks of ``x`` along ``dim`` (which holds
    the whole sequence), chunk ``index`` then chunk ``2·cp-1-index``."""
    S = x.shape[dim]
    validate_cp(S, cp)
    c = S // (2 * cp)
    late = 2 * cp - 1 - index
    return torch.cat([x.narrow(dim, index * c, c), x.narrow(dim, late * c, c)], dim)


# --------------------------------------------------------------------------
# online-softmax partials
# --------------------------------------------------------------------------

def merge_partials(o1, m1, l1, o2, m2, l2):
    """Merge two normalised partials (o_i = acc_i / l_i, softmax stats m_i,
    l_i): o (..., hd), m / l (...)."""
    m = torch.maximum(m1, m2)
    a = l1 * torch.exp(m1 - m)
    b = l2 * torch.exp(m2 - m)
    l = a + b
    o = (o1 * a[..., None] + o2 * b[..., None]) / torch.clamp(l, min=1e-30)[..., None]
    return o, m, l


def _block_partial(q, k, v, q_pos, k_pos, *, causal: bool):
    """The normalised plain partial over one K/V block, differentiable:
    q/k/v (..., S, H, hd) with equal head counts, positions broadcastable to
    (..., S); returns fp32 (o (..., H, Sq, hd), m, l (..., H, Sq))."""
    hd = q.shape[-1]
    s = torch.einsum("...qhd,...shd->...hqs", q.float(), k.float()) * hd ** -0.5
    if causal:
        mask = k_pos[..., None, :] <= q_pos[..., :, None]            # (..., Sq, Sk)
        s = torch.where(mask[..., None, :, :], s, torch.full((), NEG_INF, device=s.device))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("...hqs,...shd->...hqd", p.to(v.dtype), v).float()
    return o / torch.clamp(l, min=1e-30)[..., None], m, l


def _flash_partial(impl: str):
    """Step partials from K1 (``impl="kernel"``: the kernel on CUDA tensors,
    its plain version on CPU tensors) or its plain version (``"ref"``):
    fp32 (o (B, H, Sq, hd), m, l (B, H, Sq)) over compact K/V."""
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    fwd = flash_ops.flash_attention_fwd if impl == "kernel" else flash_ref.flash_attention_fwd

    def partial(q, k, v, causal, pos=None):
        out, m, l = fwd(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
                        q_pos=pos, k_pos=pos, return_residuals=True)
        return out.float().transpose(1, 2), m, l

    return partial


# --------------------------------------------------------------------------
# one rank's ring, written once (see the module note)
# --------------------------------------------------------------------------

def _visible(index: int, source: int, causal: bool, c: int):
    """(local query rows, the source block's keys) that see each other at a
    later step: every row and key without a mask; every row and the early
    chunk from an earlier rank; the late rows and every key from a later
    one."""
    if not causal:
        return slice(None), slice(None)
    if source < index:
        return slice(None), slice(0, c)
    return slice(c, None), slice(None)


def _forward_ring(q, k, v, pos, *, causal: bool, index: int, cp: int, partial):
    """Generator of one rank's forward: yields the (k, v) it passes on,
    receives the previous rank's; returns (out (B, Sl, H, hd) in q's dtype,
    lse (B, H, Sl) fp32)."""
    c = q.shape[1] // 2
    o, m, l = partial(q, k, v, True, pos) if causal else partial(q, k, v, False)
    kb, vb = k, v
    for t in range(1, cp):
        kb, vb = yield (kb, vb)
        rows, cols = _visible(index, (index - t) % cp, causal, c)
        ob, mb, lb = partial(q[:, rows], kb[:, cols], vb[:, cols], False)
        o[:, :, rows], m[:, :, rows], l[:, :, rows] = merge_partials(
            o[:, :, rows], m[:, :, rows], l[:, :, rows], ob, mb, lb)
    out = o.transpose(1, 2).to(q.dtype).contiguous()
    return out, m + torch.log(l)


def _block_grads(q, k, v, dout, lse, delta, dq, *, pos=None, block_q: int = BLOCK_Q):
    """The grads of one step's block at the final softmax statistics: q /
    dout (B, Sq, H, hd), compact k / v (B, Sk, KV, hd), lse / delta (B, H,
    Sq); adds dq into ``dq`` (fp32, q's shape) and returns fp32 (dk, dv).
    ``pos`` (the causal step 0's positions, q's and k's alike) masks.  One
    block of ``block_q`` query rows of fp32 scores is live at a time."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = hd ** -0.5
    ke, ve = flash_ref.expand_heads(k.float(), v.float(), H)
    dk = torch.zeros((B, Sk, H, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for start in range(0, Sq, block_q):
        stop = min(start + block_q, Sq)
        qi, doi = q[:, start:stop].float(), dout[:, start:stop].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qi, ke) * scale
        if pos is not None:
            hidden = pos[None, :] > pos[start:stop, None]
            s = s.masked_fill(hidden, NEG_INF)
        p = torch.exp(s - lse[:, :, start:stop, None])
        dv += torch.einsum("bhqk,bqhd->bkhd", p, doi)
        ds = p * (torch.einsum("bqhd,bkhd->bhqk", doi, ve) - delta[:, :, start:stop, None])
        dq[:, start:stop] += torch.einsum("bhqk,bkhd->bqhd", ds, ke) * scale
        dk += torch.einsum("bhqk,bqhd->bkhd", ds, qi) * scale
    g = H // KV
    return dk.view(B, Sk, KV, g, hd).sum(3), dv.view(B, Sk, KV, g, hd).sum(3)


def _backward_ring(q, k, v, out, lse, dout, pos, *, causal: bool, index: int, cp: int):
    """Generator of one rank's backward: goes round the ring again, yields
    (k, v, dk, dv) and receives the previous rank's, then passes the last
    accumulators home; returns (dq, dk, dv) in q's, k's and v's dtypes."""
    c = q.shape[1] // 2
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)        # (B, H, Sl)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkb, dvb = _block_grads(q, k, v, dout, lse, delta, dq, pos=pos if causal else None)
    kb, vb = k, v
    for t in range(1, cp):
        kb, vb, dkb, dvb = yield (kb, vb, dkb, dvb)
        rows, cols = _visible(index, (index - t) % cp, causal, c)
        gk, gv = _block_grads(q[:, rows], kb[:, cols], vb[:, cols], dout[:, rows],
                              lse[:, :, rows], delta[:, :, rows], dq[:, rows])
        dkb[:, cols] += gk
        dvb[:, cols] += gv
    if cp > 1:                  # the block held last is the next rank's own
        dkb, dvb = yield (dkb, dvb)
    return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype)


def _step(gen, value):
    """(True, what ``gen`` returned) or (False, what it sends next)."""
    try:
        return False, gen.send(value)
    except StopIteration as stop:
        return True, stop.value


def _drive(gen, hop):
    """One rank's ring over ``hop``: each tick's tensors to the next rank,
    the previous rank's received in the same exchange (``hop.rotate``)."""
    done, out = _step(gen, None)
    while not done:
        done, out = _step(gen, hop.rotate(out))
    return out


def _lockstep(gens: list) -> list:
    """Every rank's ring in one process: at each tick rank r receives (a
    copy of) what rank r - 1 sent, as a hop's fresh buffers."""
    steps = [_step(g, None) for g in gens]
    while not all(done for done, _ in steps):
        if any(done for done, _ in steps):
            raise RuntimeError("the ranks' rings went out of step")
        sent = [out for _, out in steps]
        steps = [_step(g, [x.clone() for x in sent[(r - 1) % len(gens)]])
                 for r, g in enumerate(gens)]
    return [out for _, out in steps]


# --------------------------------------------------------------------------
# the training ring
# --------------------------------------------------------------------------

class _RingLocal(torch.autograd.Function):
    """:func:`ring_attention_local` under autograd (see the module note)."""

    @staticmethod
    def forward(ctx, q, k, v, pos, causal, hop, impl):
        out, lse = _drive(_forward_ring(q, k, v, pos, causal=causal, index=hop.stage,
                                        cp=hop.stages, partial=_flash_partial(impl)), hop)
        ctx.save_for_backward(q, k, v, pos, out, lse)
        ctx.causal, ctx.hop = causal, hop
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, pos, out, lse = ctx.saved_tensors
        hop = ctx.hop
        dq, dk, dv = _drive(_backward_ring(q, k, v, out, lse, g.contiguous(), pos,
                                           causal=ctx.causal, index=hop.stage,
                                           cp=hop.stages), hop)
        return dq, dk, dv, None, None, None, None


def ring_attention_local(q, k, v, q_pos, *, causal: bool = True, hop, impl: str = "kernel"):
    """Attention over the ring of ``hop`` (``collectives.StageHop`` over the
    cp axis; this rank is ``hop.stage`` of ``hop.stages``): q (B, Sl, H, hd)
    and compact k / v (B, Sl, KV, hd) this rank's zig-zag shard, ``q_pos``
    (Sl,) int32 its global positions (:func:`zigzag_positions`) ->
    (B, Sl, H, hd) in q's dtype, differentiable (see the module note).  The
    half-block steps hold only for the zig-zag layout."""
    if q.shape[1] % 2 or q.shape[1] != k.shape[1]:
        raise ValueError(f"a ring shard holds two equal chunks of queries and keys; got "
                         f"Sq {q.shape[1]}, Sk {k.shape[1]}")
    return _RingLocal.apply(q, k, v, q_pos, causal, hop, impl)


class _RingSerial(torch.autograd.Function):
    """Every rank's half-block ring in one process, on zig-zag-ordered
    (B, S, H, hd) q and compact k / v."""

    @staticmethod
    def forward(ctx, qz, kz, vz, causal, cp):
        S = qz.shape[1]
        q, k, v = (a.chunk(cp, 1) for a in (qz, kz, vz))
        partial = _flash_partial("kernel")
        res = _lockstep([_forward_ring(q[r], k[r], v[r], zigzag_positions(S, cp, r, qz.device),
                                       causal=causal, index=r, cp=cp, partial=partial)
                         for r in range(cp)])
        out = torch.cat([o for o, _ in res], 1)
        ctx.save_for_backward(qz, kz, vz, out, *[lse for _, lse in res])
        ctx.causal, ctx.cp = causal, cp
        return out

    @staticmethod
    def backward(ctx, g):
        qz, kz, vz, out, *lse = ctx.saved_tensors
        cp = ctx.cp
        S = qz.shape[1]
        cut = lambda a: a.chunk(cp, 1)
        q, k, v, o, d = cut(qz), cut(kz), cut(vz), cut(out), cut(g.contiguous())
        res = _lockstep([_backward_ring(q[r], k[r], v[r], o[r], lse[r], d[r],
                                        zigzag_positions(S, cp, r, qz.device),
                                        causal=ctx.causal, index=r, cp=cp)
                         for r in range(cp)])
        return (*(torch.cat([x[i] for x in res], 1) for i in range(3)), None, None)


def _ring_explicit(qz, kz, vz, pos, *, causal: bool):
    """JAX's explicit-cp-dim ring: leaves (cp, B, Sc, H, hd), positions
    (cp, Sc); ``torch.roll`` on dim 0 is the ring step."""
    cp = qz.shape[0]
    o = m = l = None
    k, v, kp = kz, vz, pos
    for t in range(cp):
        ob, mb, lb = _block_partial(qz, k, v, pos[:, None], kp[:, None], causal=causal)
        o, m, l = (ob, mb, lb) if o is None else merge_partials(o, m, l, ob, mb, lb)
        if t != cp - 1:
            k, v, kp = (torch.roll(a, 1, 0) for a in (k, v, kp))
    return o.transpose(2, 3).to(qz.dtype)                         # (cp, B, Sc, H, hd)


def ring_attention(q, k, v, *, causal: bool = True, cp: int, use_flash: bool = False):
    """Ring attention over ``cp`` sequence shards in one process: q (B, S,
    H, hd), compact k / v (B, S, KV, hd) in natural order -> (B, S, H, hd).
    ``use_flash=False``: JAX's serial positional ring on plain partials;
    ``use_flash=True``: every rank's half-block ring on K1's partials (the
    plain version's on CPU tensors; see the module note).  Both
    differentiable."""
    B, S, H, hd = q.shape
    validate_cp(S, cp)
    perm = zigzag_permutation(S, cp)
    idx = torch.from_numpy(perm).to(q.device)
    inv = torch.from_numpy(inverse_permutation(perm)).to(q.device)
    qz, kz, vz = (a.index_select(1, idx) for a in (q, k, v))
    if use_flash:
        out = _RingSerial.apply(qz, kz, vz, causal, cp)
    else:
        Sc = S // cp
        ke, ve = flash_ref.expand_heads(kz, vz, H)
        fold = lambda a: a.reshape(B, cp, Sc, H, hd).transpose(0, 1)
        pos = idx.reshape(cp, Sc)
        out = _ring_explicit(fold(qz), fold(ke), fold(ve), pos, causal=causal)
        out = out.transpose(0, 1).reshape(B, S, H, hd)
    return out.index_select(1, inv)


def positional_ring_local(q, k, v, q_pos, *, causal: bool = True, hop):
    """JAX's per-rank ``_ring_local`` with plain partials: every step masked
    by position, K/V moved by ``collectives.ring_shift``, the whole ring
    differentiated by autograd (see the module note)."""
    H = q.shape[2]
    S = q.shape[1] * hop.stages
    kb, vb = flash_ref.expand_heads(k, v, H)
    o = m = l = None
    for t in range(hop.stages):
        kp = zigzag_positions(S, hop.stages, (hop.stage - t) % hop.stages, q.device)
        ob, mb, lb = _block_partial(q, kb, vb, q_pos, kp, causal=causal)
        o, m, l = (ob, mb, lb) if o is None else merge_partials(o, m, l, ob, mb, lb)
        if t != hop.stages - 1:
            kb, vb = collectives.ring_shift(hop, kb, vb)
    return o.transpose(1, 2).to(q.dtype)
