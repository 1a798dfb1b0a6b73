"""Multi-head attention with GQA, qk-norm, optional bias, a KV cache and
cross-attention.

K/V are stored compact (``num_kv_heads``).  Query heads are never padded
for tensor parallelism: under it (``collectives.tp_state``: the training
modes, ``"train"`` self- and cross-attention and ``"encoder"``, and the
serving modes' self-attention, ``"prefill"`` and ``"decode"``) the head
counts are read from the shard shapes.  ``wq`` / ``wo`` hold this
rank's contiguous block of query heads and ``wk`` / ``wv`` its KV heads, or
every KV head where ``spec_for_shape`` left them whole (fewer KV heads than
ranks); then each rank keeps the KV heads its query heads map to, global
query head // g, which is the function JAX's expanded heads give.  The
block is a region (``collectives.region_in`` / ``region_out``), and the
leaves a rank holds whole but uses for its heads alone (qk-norm scales,
replicated K/V projections) get their grads summed over the model axis
(``collectives.partial_grad``).  A head count the model axis does not
divide keeps the block whole and replicated.  A cross-attention region
takes its K/V source (the encoder output, in the boundary layout) through
``region_in`` too, so under sequence parallelism every rank's keys are the
whole encoded sequence.

``attention_block`` takes JAX's modes: ``"train"``, ``"prefill"`` and
``"decode"`` (causal self-attention), ``"encoder"`` (non-causal
self-attention, no cache) and, with ``kv_source`` or ``cross=True``,
cross-attention (q from x, k/v from the encoder output, no RoPE,
non-causal; at decode the k/v come from the cache prefill filled).  It
dispatches:
  * ``impl="kernel"`` on CUDA tensors -> the flash-attention forward kernel
    (``kernels/flash_attention``) for every pass, on the compact K/V: the
    kernel maps query head h to kv head h // (H // KV) itself, so no head
    expansion runs.  Where a grad is wanted the kernel runs under its
    autograd function, whose backward recomputes through
    ``chunked_attention_vjp``.  A decode offset and per-slot valid lengths
    become explicit positions (``flash_positions``, built once per forward
    by ``forward_decode``): ``q_pos = q_offset + arange(Sq)`` per slot,
    ``k_pos = arange(Sk)`` with every key at or beyond ``kv_len[b]`` moved
    to ``INT32_MAX``, so the kernel's ``k_pos <= q_pos`` mask is exactly
    ``dense_attention``'s ``(k <= q_offset + i) & (k < kv_len)``.  A full
    pass (offset 0, no ``kv_len``) keeps the index mask, or none when it is
    non-causal, and needs no positions.
  * otherwise (CPU tensors, or ``impl="ref"``) -> ``expand_and_pad`` to the
    query-head count, then ``dense_attention`` up to ``DENSE_MAX_SEQ`` and
    ``chunked_attention`` beyond, as in the JAX package; the chunked form's
    backward recomputes it one query block at a time, as JAX recomputes it
    under ``jax.checkpoint``.

On a serving mesh (the step engine's rules, ``runtime/serve.py``) the KV
cache is laid out as ``sharding.cache_spec_tree`` says: every KV head on
every rank of the model axis (a K/V projection sharded over it is
all-gathered, ``collectives.gather_heads``), and its positions either whole
or split over the model axis (``collectives.cache_seq_group``).  A prefill
attends this rank's query heads as training does and returns that cache
(``forward_prefill`` keeps this rank's slice of the positions).  A decode
step over a whole cache writes every KV head and attends this rank's query
heads; over a sequence-sharded cache it is flash-decode: every rank
gathers every query head, writes the new token only where its slice holds
the position (``write_cache_shard``, per slot, never reading a tensor index
on the host), runs K1 with residuals over its slice at explicit positions
(``flash_positions(..., k_offset=...)``; K1's plain version on CPU tensors
and under ``impl="ref"``), gathers the group's ``(o, m, l)`` and folds them
in fp32 with ``context.merge_partials``, then keeps its own heads for the
row-parallel out-projection.  Cross-attention on a serving mesh is the
audio family's, which serves on one device.

Under context parallelism (``parallel.axes.ring_context``: the runtime's
rules under a cp > 1 plan) a train-mode self-attention block holds this
rank's zig-zag shard of the sequence: RoPE takes the shard's global
positions and the attention is the ring over the ``cp`` group
(``parallel.context.ring_attention_local``), whose every step is a K1
call on CUDA tensors under ``impl="kernel"`` and the plain version's
otherwise.  A shard that is not S / cp of a sequence splitting into 2·cp
chunks raises, and so does any other mode under a ring.

The q/k/v and output projections are 2-D matmuls on reshaped weights, so
they reach ``aten.mm`` (what the selective remat policy saves) while the
attention products stay batched ``bmm``.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.registry import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.models.common import ParamDef
from repro_torch.models.norms import head_rmsnorm
from repro_torch.models.rotary import apply_rope, rope_angles
from repro_torch.parallel import collectives, context
from repro_torch.parallel.axes import ring_context

NEG_INF = -0.7 * float(np.finfo(np.float32).max)
INT32_MAX = int(np.iinfo(np.int32).max)
DENSE_MAX_SEQ = 2048          # above this, the plain path goes chunked
CHUNK_Q = 1024
CHUNK_KV = 1024


def attn_defs(cfg: ModelConfig, cross: bool = False) -> dict:
    """A cross-attention block (``cross=True``) has no qkv bias and no
    qk-norm, as in JAX."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    # explicit stds: q/k/v contract over d_model and wo over h·hd, which the
    # fan-in heuristic (shape[-2]) gets wrong for these 3-D projections
    defs = {
        "wq": ParamDef((d, h, hd), ("embed", "q_heads", "head_dim"), scale=d ** -0.5,
                       cast=True),
        "wk": ParamDef((d, kv, hd), ("embed", "kv_heads", "head_dim"), scale=d ** -0.5,
                       cast=True),
        "wv": ParamDef((d, kv, hd), ("embed", "kv_heads", "head_dim"), scale=d ** -0.5,
                       cast=True),
        "wo": ParamDef((h, hd, d), ("q_heads", "head_dim", "embed"), scale=(h * hd) ** -0.5,
                       cast=True),
    }
    if cfg.qkv_bias and not cross:
        defs["bq"] = ParamDef((h, hd), ("q_heads", "head_dim"), init="zeros", cast=True)
        defs["bk"] = ParamDef((kv, hd), ("kv_heads", "head_dim"), init="zeros", cast=True)
        defs["bv"] = ParamDef((kv, hd), ("kv_heads", "head_dim"), init="zeros", cast=True)
    if cfg.qk_norm and not cross:
        defs["q_norm"] = ParamDef((hd,), ("head_dim",), init="ones")
        defs["k_norm"] = ParamDef((hd,), ("head_dim",), init="ones")
    return defs


def abstract_kv_cache(cfg: ModelConfig, batch: int, max_len: int, layers: int,
                      dtype=torch.bfloat16) -> dict:
    """The stacked KV cache {"k", "v": (layers, batch, max_len, KV, hd)} as
    tensors on the ``meta`` device: shapes and dtype, nothing allocated."""
    shape = (layers, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.empty(shape, dtype=dtype, device="meta"),
            "v": torch.empty(shape, dtype=dtype, device="meta")}


# --------------------------------------------------------------------------
# head expansion
# --------------------------------------------------------------------------

def _kv_expand_index(num_q: int, num_kv: int, padded: int) -> np.ndarray:
    """Map expanded/padded q-head index -> source kv head (pads map to 0)."""
    g = num_q // num_kv
    idx = np.arange(padded) // g
    idx[num_q:] = 0
    return np.minimum(idx, num_kv - 1)


def expand_and_pad(q, k, v):
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd) -> k/v expanded to H heads.  With
    ``H % KV == 0`` (every config) the gather of ``_kv_expand_index`` is a
    ``repeat_interleave``, as the kernel's plain version expands — no index
    tensor crosses to the device."""
    return (q, *flash_ref.expand_heads(k, v, q.shape[2]))


# --------------------------------------------------------------------------
# attention math (plain paths: heads already expanded, q/k/v all (B,S,H,hd))
# --------------------------------------------------------------------------

def _q_positions(q_offset, Sq: int, device) -> torch.Tensor:
    """q_offset (int, 0-d or (B,) tensor) + arange(Sq) -> (Sq,) or (B, Sq)."""
    ar = torch.arange(Sq, device=device)
    if isinstance(q_offset, torch.Tensor):
        return q_offset.to(device).long().reshape(-1, 1) + ar
    return ar + int(q_offset)


def dense_attention(q, k, v, *, causal, q_offset=0, kv_len=None):
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    scale = hd ** -0.5
    logits = torch.einsum("bqhd,bshd->bhqs", q, k).float() * scale
    mask = torch.ones((1, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        qpos = _q_positions(q_offset, Sq, q.device)
        mask = torch.arange(Sk, device=q.device) <= qpos.reshape(-1, Sq, 1)
    mask = mask.expand(B, Sq, Sk)[:, None]
    if kv_len is not None:
        valid = torch.arange(Sk, device=q.device)[None, :] < kv_len.to(q.device)[:, None]
        mask = mask & valid[:, None, None, :]
    logits = torch.where(mask, logits, torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, v)


def blocks(n: int, size: int) -> list[tuple[int, int]]:
    """``[start, stop)`` of the ``ceil(n / size)`` blocks of ``size`` that
    cover ``range(n)``, the last one ragged."""
    return [(start, min(start + size, n)) for start in range(0, n, size)]


def chunked_attention(q, k, v, *, causal, q_offset=0, kv_len=None,
                      chunk_q: int = CHUNK_Q, chunk_kv: int = CHUNK_KV):
    """Flash-style online softmax over (q, kv) blocks; O(chunk_q·chunk_kv)
    live scores.  The plain path for sequences beyond ``DENSE_MAX_SEQ``, and
    the recompute of K1's backward.  It walks ``ceil(S / chunk)`` blocks of
    each side, the last one shorter, where JAX's halves the chunk until it
    divides S (an Sk of 1 500 would walk 375 blocks of 4 keys)."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    scale = hd ** -0.5
    qpos_all = _q_positions(q_offset, Sq, q.device).reshape(-1, Sq)   # (1|B, Sq)
    neg = torch.full((), NEG_INF, device=q.device)
    outs = []
    for q0, q1 in blocks(Sq, chunk_q):
        cq = q1 - q0
        qi = q[:, q0:q1]
        qpos = qpos_all[:, q0:q1]
        o = torch.zeros((B, H, cq, hd), dtype=torch.float32, device=q.device)
        m = torch.full((B, H, cq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, cq), dtype=torch.float32, device=q.device)
        for k0, k1 in blocks(Sk, chunk_kv):
            ck = k1 - k0
            kj, vj = k[:, k0:k1], v[:, k0:k1]
            s = torch.einsum("bqhd,bshd->bhqs", qi, kj).float() * scale
            kpos = torch.arange(k0, k1, device=q.device)
            mask = torch.ones((1, cq, ck), dtype=torch.bool, device=q.device)
            if causal:
                mask = kpos[None, None, :] <= qpos[:, :, None]
            mask = mask.expand(B, cq, ck)[:, None]
            if kv_len is not None:
                mask = mask & (kpos[None, :] < kv_len[:, None])[:, None, None, :]
            s = torch.where(mask, s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum(
                "bhqs,bshd->bhqd", p.to(vj.dtype), vj).float()
            m = m_new
        outs.append((o / torch.clamp(l[..., None], min=1e-30)).transpose(1, 2))
    return torch.cat(outs, dim=1).to(q.dtype)


def chunked_attention_vjp(q, k, v, g, *, causal, q_offset=0, kv_len=None,
                          block_q: int = CHUNK_Q):
    """(dq, dk, dv) of ``chunked_attention(q, k, v)`` at cotangent ``g``,
    with k/v compact (KV heads dividing H, expanded here as the kernel maps
    them) or already expanded.  Recomputed one query block of ``block_q``
    rows at a time under ``torch.enable_grad()``, so only one block's graph
    of fp32 scores is live; dk/dv accumulate in fp32 over the blocks.  A
    causal block at an int offset sees no key past its last row, so those
    keys (which weigh exactly 0) are left out of its recompute.  Runs inside
    the profiler span ``attention_vjp``."""
    Sq, H = q.shape[1], q.shape[2]
    Sk = k.shape[1]
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    with record_function("attention_vjp"):
        for start, stop in blocks(Sq, block_q):
            end = Sk
            if causal and not isinstance(q_offset, torch.Tensor):
                end = min(Sk, int(q_offset) + stop)
            with torch.enable_grad():
                qi = q[:, start:stop].detach().requires_grad_()
                ki = k[:, :end].detach().requires_grad_()
                vi = v[:, :end].detach().requires_grad_()
                ke, ve = flash_ref.expand_heads(ki, vi, H)
                out = chunked_attention(qi, ke, ve, causal=causal, q_offset=q_offset + start,
                                        kv_len=kv_len)
                gq, gk, gv = torch.autograd.grad(out, (qi, ki, vi), g[:, start:stop])
            dq[:, start:stop] = gq
            dk[:, :end] += gk
            dv[:, :end] += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _ChunkedAttention(torch.autograd.Function):
    """``chunked_attention`` whose backward recomputes it block by block
    (``chunked_attention_vjp``) from the saved q, k, v: the counterpart of
    the JAX package's ``jax.checkpoint`` (nothing saveable) around it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, kv_len):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, q_offset, kv_len)
        return chunked_attention(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)

    @staticmethod
    def backward(ctx, g):
        causal, q_offset, kv_len = ctx.args
        dq, dk, dv = chunked_attention_vjp(*ctx.saved_tensors, g, causal=causal,
                                           q_offset=q_offset, kv_len=kv_len)
        return dq, dk, dv, None, None, None


def uses_kernel(impl: str, x: torch.Tensor) -> bool:
    """Whether attention goes to the flash kernel: ``impl="kernel"`` on a
    CUDA tensor, or on a ``meta`` one (the dry run's stand-in for a CUDA
    tensor on a torch without CUDA; the kernel's fake path takes it)."""
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    return impl == "kernel" and (x.is_cuda or x.device.type == "meta")


def valid_lengths(cache_index, Sq: int, B: int, kv_len, device) -> torch.Tensor:
    """Per-slot valid cache lengths of a decode step: ``kv_len`` if given,
    else ``cache_index + Sq`` (an int, or a 0-d or (B,) device tensor, never
    read on the host)."""
    if kv_len is not None:
        return kv_len
    if isinstance(cache_index, torch.Tensor):
        return (cache_index.to(device).long() + Sq).expand(B)
    return torch.full((B,), int(cache_index) + Sq, device=device)


def flash_positions(q_offset, Sq: int, Sk: int, kv_len, B: int, device, *,
                    causal: bool = True, k_offset: int = 0):
    """The kernel's explicit ``(q_pos, k_pos)`` int32 for a query offset and
    valid lengths, or None where the plain index mask is already exact
    (offsets 0, no ``kv_len``).  Non-causal calls with ``kv_len`` see every
    in-range key: their ``q_pos`` is ``INT32_MAX - 1``.  ``k_offset`` is the
    global position of the first key (a rank's slice of a sequence-sharded
    cache): ``k_pos = k_offset + arange(Sk)``, each at or past ``kv_len[b]``
    moved to ``INT32_MAX``."""
    if (kv_len is None and not isinstance(q_offset, torch.Tensor) and q_offset == 0
            and k_offset == 0):
        return None
    if causal:
        q_pos = _q_positions(q_offset, Sq, device).to(torch.int32)
        if q_pos.dim() == 2 and q_pos.shape[0] != B:
            q_pos = q_pos.expand(B, Sq)
        q_pos = q_pos.contiguous()
    else:
        q_pos = torch.full((Sq,), INT32_MAX - 1, dtype=torch.int32, device=device)
    k_pos = torch.arange(k_offset, k_offset + Sk, dtype=torch.int32, device=device)
    if kv_len is not None:
        k_pos = torch.where(k_pos[None, :] < kv_len.to(device)[:, None], k_pos, INT32_MAX)
    return q_pos, k_pos.contiguous()


def _flash(q, k, v, *, causal, q_offset=0, kv_len=None, positions=None):
    """The kernel on q (B, Sq, H, hd) and compact or expanded k/v (B, Sk,
    KV, hd), with a decode offset / valid lengths as explicit positions
    (``positions`` from ``flash_positions``, or built here)."""
    if positions is None:
        positions = flash_positions(q_offset, q.shape[1], k.shape[1], kv_len, q.shape[0],
                                    q.device, causal=causal)
    if positions is None:
        return flash_ops.flash_attention_fwd(q, k, v, causal=causal)
    q_pos, k_pos = positions
    return flash_ops.flash_attention_fwd(q, k, v, causal=True, q_pos=q_pos, k_pos=k_pos)


def attention_math(q, k, v, *, causal, q_offset=0, kv_len=None):
    """The plain path on expanded heads: dense up to ``DENSE_MAX_SEQ``,
    chunked beyond (differentiable with a block-by-block recompute)."""
    if max(q.shape[1], k.shape[1]) <= DENSE_MAX_SEQ:
        return dense_attention(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
    return _ChunkedAttention.apply(q, k, v, causal, q_offset, kv_len)


# --------------------------------------------------------------------------
# block-level entry point
# --------------------------------------------------------------------------

def _project(x, w):
    """x (B, S, D) @ w (D, H, hd) -> (B, S, H, hd), as one 2-D matrix product
    (``aten.mm``, which the selective remat policy saves)."""
    D, H, hd = w.shape
    return torch.matmul(x, w.to(x.dtype).reshape(D, H * hd)).view(*x.shape[:-1], H, hd)


def _project_qkv(params, x, kv_x, cfg: ModelConfig, impl: str):
    """q from x, k/v from ``kv_x`` (x itself, or the encoder output of a
    cross-attention block)."""
    q = _project(x, params["wq"])
    k = _project(kv_x, params["wk"])
    v = _project(kv_x, params["wv"])
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    if "q_norm" in params:
        q = head_rmsnorm(params["q_norm"], q, cfg.norm_eps, impl)
        k = head_rmsnorm(params["k_norm"], k, cfg.norm_eps, impl)
    return q, k, v


def _out_proj(params, out, x_dtype):
    H, hd, D = params["wo"].shape
    return torch.matmul(out.reshape(*out.shape[:-2], H * hd),
                        params["wo"].to(x_dtype).reshape(H * hd, D))


def write_cache(cache: torch.Tensor, new: torch.Tensor, cache_index) -> None:
    """Write new (B, Sq, KV, hd) into cache (B, S_max, KV, hd) at
    ``cache_index`` (int, or a 0-d or (B,) per-slot start tensor), in place.
    Unlike JAX's ``dynamic_update_slice`` nothing is clamped: callers leave
    room (the scheduler pads its gathered views).  An int write out of range
    raises; a tensor start is never read on the host (a CUDA graph captures
    the write), so it goes through index tensors and is checked by the
    indexing itself."""
    B, Sq = new.shape[:2]
    new = new.to(cache.dtype)
    if isinstance(cache_index, torch.Tensor):
        pos = _q_positions(cache_index, Sq, cache.device).reshape(-1, Sq).expand(B, Sq)
        rows = torch.arange(B, device=cache.device)[:, None]
        cache[rows, pos] = new
        return
    ci = int(cache_index)
    if ci < 0 or ci + Sq > cache.shape[1]:
        raise IndexError(f"cache write [{ci}, {ci + Sq}) outside [0, {cache.shape[1]})")
    cache[:, ci:ci + Sq] = new


def write_cache_shard(cache: torch.Tensor, new: torch.Tensor, cache_index,
                      offset: int) -> None:
    """Write new (B, Sq, KV, hd) at global positions ``cache_index + i`` into
    this rank's slice (B, S_l, KV, hd) of a sequence-sharded cache, which
    holds positions ``[offset, offset + S_l)``; positions outside it are not
    written.  An int ``cache_index`` writes the overlap; a 0-d or (B,) tensor
    is never read on the host: each of the Sq positions is one write a slot,
    of the new row inside the slice and of the row already there outside it
    (one index a slot, so no two writes of a call meet)."""
    B, Sq = new.shape[:2]
    S_l = cache.shape[1]
    new = new.to(cache.dtype)
    if not isinstance(cache_index, torch.Tensor):
        ci = int(cache_index)
        lo, hi = max(ci, offset), min(ci + Sq, offset + S_l)
        if lo < hi:
            cache[:, lo - offset:hi - offset] = new[:, lo - ci:hi - ci]
        return
    pos = _q_positions(cache_index, Sq, cache.device).reshape(-1, Sq).expand(B, Sq) - offset
    rows = torch.arange(B, device=cache.device)
    for i in range(Sq):
        inside = ((pos[:, i] >= 0) & (pos[:, i] < S_l))[:, None, None]
        at = pos[:, i].clamp(0, S_l - 1)
        cache[rows, at] = torch.where(inside, new[:, i], cache[rows, at])


def _flash_decode(q, k, v, cache: dict, cache_index, kv_len, positions, group,
                  impl: str) -> torch.Tensor:
    """A decode step over a cache whose sequence is sharded over ``group``
    (flash-decode): q holds every query head, k/v the new token's every KV
    head.  The new k/v go into this rank's slice where it holds their
    position; K1 (its plain version on CPU tensors or under ``impl="ref"``)
    attends every query head over the slice at explicit positions (keys at
    ``offset + arange(S_l)``, those at or past ``kv_len`` at ``INT32_MAX``)
    and returns its online-softmax partial; the group's partials are
    gathered and folded in fp32 by ``context.merge_partials``.  A rank whose
    slice holds no visible key returns the mean of v with the finite
    ``m = NEG_INF``: its weight vanishes beside rank 0's, which holds
    position 0.  Returns (B, Sq, H, hd) in q's dtype."""
    ck, cv = cache["k"], cache["v"]
    B, Sq = q.shape[:2]
    offset = group.index * ck.shape[1]
    write_cache_shard(ck, k, cache_index, offset)
    write_cache_shard(cv, v, cache_index, offset)
    if positions is None:
        positions = flash_positions(cache_index, Sq, ck.shape[1],
                                    valid_lengths(cache_index, Sq, B, kv_len, q.device), B,
                                    q.device, k_offset=offset)
    q_pos, k_pos = positions
    fwd = flash_ops.flash_attention_fwd if impl == "kernel" else flash_ref.flash_attention_fwd
    o, m, l = fwd(q.contiguous(), ck.to(q.dtype).contiguous(), cv.to(q.dtype).contiguous(),
                  causal=True, q_pos=q_pos, k_pos=k_pos, return_residuals=True)
    o, m, l = collectives.gather_stacked([o.float(), m, l], group)
    out, _, _ = functools.reduce(lambda a, b: context.merge_partials(*a, *b),
                                 zip(o, m.transpose(-1, -2), l.transpose(-1, -2)))
    return out.to(q.dtype)


def _tp_params(params: dict, cfg: ModelConfig) -> dict:
    """The attention params of a head-sharded region: leaves held whole and
    used for this rank's heads alone get their grads summed over the model
    axis."""
    out = dict(params)
    whole = ["q_norm", "k_norm"]
    if params["wk"].shape[1] == cfg.num_kv_heads:
        whole += ["wk", "wv", "bk", "bv"]
    for name in whole:
        if name in out:
            out[name] = collectives.partial_grad(out[name])
    return out


def local_kv_heads(num_heads: int, num_kv: int, first_q: int, local_q: int) -> list[int]:
    """The KV heads (of ``num_kv``) that query heads ``first_q`` ..
    ``first_q + local_q - 1`` read, one per query head (global head // g),
    collapsed to each distinct head once where every one serves the same
    number of consecutive query heads (a compact GQA layout the kernel
    takes as it is)."""
    g = num_heads // num_kv
    idx = [(first_q + i) // g for i in range(local_q)]
    distinct = sorted(set(idx))
    per = local_q // len(distinct)
    if per * len(distinct) == local_q and idx == [h for h in distinct for _ in range(per)]:
        return distinct
    return idx


def _select_kv(k, v, heads: list[int]):
    if heads == list(range(heads[0], heads[0] + len(heads))):
        return k[:, :, heads[0]:heads[0] + len(heads)], v[:, :, heads[0]:heads[0] + len(heads)]
    idx = torch.tensor(heads, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _flash_full(q, k, v, *, causal, kv_len=None):
    """K1 on a full pass (offset 0): under its autograd function where a grad
    is wanted, else the forward alone (with ``kv_len`` as positions)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if kv_len is not None:
            raise NotImplementedError("K1 under autograd takes no kv_len")
        return flash_ops.flash_attention(q, k, v, causal=causal)
    return _flash(q, k, v, causal=causal, kv_len=kv_len)


def attention_block(
    params: dict,
    x: torch.Tensor,                # (B, Sq, D)
    *,
    cfg: ModelConfig,
    mode: str,                      # "train" | "prefill" | "decode" | "encoder"
    cache: Optional[dict] = None,   # {"k","v": (B, S_max, KV, hd)}
    cache_index=None,               # decode write offset: int, 0-d or (B,) tensor
    kv_len: Optional[torch.Tensor] = None,
    kv_source: Optional[torch.Tensor] = None,   # encoder output for cross-attention
    cross: bool = False,
    impl: str = "kernel",
    positions=None,                 # the kernel's (q_pos, k_pos) of a decode step
) -> tuple[torch.Tensor, Optional[dict]]:
    """One attention layer.  Self-attention: in decode mode the new k/v are
    written into ``cache`` in place and the same dict is returned as the
    new cache; prefill returns the pass's {"k", "v"}; train and encoder
    modes return None and are differentiable (train causal, encoder not).
    Cross-attention (``kv_source`` given, or ``cross``): no RoPE and no
    mask; prefill returns the encoder output's {"k", "v"}, and decode
    projects q alone, reads k/v from ``cache`` and returns it unchanged.
    ``positions`` (``flash_positions`` of this step, shared by every layer)
    is read only on the kernel path of a self-attention decode step;
    without it the positions are built here."""
    B, Sq, _ = x.shape
    if mode not in ("train", "prefill", "decode", "encoder"):
        raise ValueError(f"unknown attention mode {mode!r}")
    cross = cross or kv_source is not None
    kernel = uses_kernel(impl, x)
    if mode == "decode" and cross:
        q = _project(x, params["wq"])
        if "q_norm" in params:
            q = head_rmsnorm(params["q_norm"], q, cfg.norm_eps, impl)
        ck, cv = cache["k"].to(q.dtype), cache["v"].to(q.dtype)
        if kernel:
            out = _flash(q.contiguous(), ck.contiguous(), cv.contiguous(), causal=False,
                         kv_len=kv_len)
        else:
            q, ke, ve = expand_and_pad(q, ck, cv)
            out = attention_math(q, ke, ve, causal=False, kv_len=kv_len)
        return _out_proj(params, out, x.dtype), cache

    ring = ring_context()
    if ring is not None and (mode != "train" or cross):
        raise NotImplementedError(f"context parallelism runs train-mode self-attention "
                                  f"alone, not {'cross-attention' if cross else mode!r}")
    # the serving passes run self-attention under TP too; cross-attention on
    # a serving mesh is the audio family's, which serves on one device
    tp = collectives.tp_state() if mode in ("train", "encoder") or not cross else None
    serving = tp is not None and mode in ("prefill", "decode")
    sharded = False
    if tp is not None:
        sharded = params["wq"].shape[1] < cfg.num_heads
        x = collectives.region_in(x, sharded)
        if cross:                   # the encoder output enters the region too
            kv_source = collectives.region_in(kv_source, sharded)
        B, Sq, _ = x.shape
        if sharded:
            params = _tp_params(params, cfg)
    q, k, v = _project_qkv(params, x, kv_source if cross else x, cfg, impl)
    local_q = q.shape[2]
    if sharded and not serving and k.shape[2] == cfg.num_kv_heads:
        # KV heads held whole: this rank's query heads read their own
        k, v = _select_kv(k, v, local_kv_heads(cfg.num_heads, cfg.num_kv_heads,
                                               tp.group.index * local_q, local_q))
    if ring is not None:
        context.validate_cp(ring.seq_len, ring.cp)
        if Sq * ring.cp != ring.seq_len:
            raise ValueError(f"a ring shard of {Sq} tokens is not 1/{ring.cp} of the "
                             f"microbatch's {ring.seq_len}")
    if not cross:                   # RoPE on self-attention only
        if mode == "decode":
            pos_q = _q_positions(cache_index, Sq, x.device)
        elif ring is not None:      # the shard's global positions
            pos_q = context.zigzag_positions(ring.seq_len, ring.cp, ring.index, x.device)
        else:
            pos_q = torch.arange(Sq, device=x.device)
        cos_q, sin_q = rope_angles(pos_q, cfg.resolved_head_dim, cfg.rope_theta)
        q = apply_rope(q, cos_q, sin_q)
        k = apply_rope(k, cos_q, sin_q)

    seq = collectives.cache_seq_group() if serving and mode == "decode" else None
    new_cache = {"k": k, "v": v} if mode == "prefill" else None
    if serving:
        # the cache holds every KV head on every rank of the model axis, and
        # a flash-decode step attends every query head over its slice
        gather_q = seq is not None and sharded
        parts = ([q] if gather_q else []) + ([k, v] if k.shape[2] < cfg.num_kv_heads else [])
        if parts:
            got = collectives.gather_heads(parts, tp.group)
            if gather_q:
                q, got = got[0], got[1:]
            if got:
                k, v = got
        if mode == "prefill":
            new_cache = {"k": k, "v": v}
            if sharded:             # this rank's query heads read their own KV heads
                k, v = _select_kv(k, v, local_kv_heads(cfg.num_heads, cfg.num_kv_heads,
                                                       tp.group.index * local_q, local_q))

    if mode == "decode":
        ck, cv = cache["k"], cache["v"]
        new_cache = cache
        if seq is not None:
            out = _flash_decode(q, k, v, cache, cache_index, kv_len, positions, seq, impl)
            if sharded:             # this rank's query heads
                first = tp.group.index * local_q
                out = out[:, :, first:first + local_q]
        else:
            write_cache(ck, k, cache_index)
            write_cache(cv, v, cache_index)
            if sharded:             # a whole cache: this rank's heads, as training
                ck, cv = _select_kv(ck, cv, local_kv_heads(cfg.num_heads, cfg.num_kv_heads,
                                                           tp.group.index * local_q, local_q))
            if kernel:
                if positions is None:
                    positions = flash_positions(
                        cache_index, Sq, ck.shape[1],
                        valid_lengths(cache_index, Sq, B, kv_len, x.device), B, x.device)
                out = _flash(q.contiguous(), ck.to(q.dtype).contiguous(),
                             cv.to(q.dtype).contiguous(), causal=True, positions=positions)
            else:
                valid = valid_lengths(cache_index, Sq, B, kv_len, x.device)
                q, ke, ve = expand_and_pad(q, ck.to(q.dtype), cv.to(q.dtype))
                out = attention_math(q, ke, ve, causal=True, q_offset=cache_index,
                                     kv_len=valid)
    else:
        causal = mode != "encoder" and not cross
        if ring is not None:
            out = context.ring_attention_local(q, k, v, pos_q, causal=True, hop=ring.hop,
                                               impl="kernel" if kernel else "ref")
        elif kernel:
            out = _flash_full(q, k, v, causal=causal, kv_len=kv_len)
        else:
            q, ke, ve = expand_and_pad(q, k, v)
            out = attention_math(q, ke, ve, causal=causal, kv_len=kv_len)
    y = _out_proj(params, out, x.dtype)
    if tp is not None:
        y = collectives.region_out(y, sharded)
    return y, new_cache
