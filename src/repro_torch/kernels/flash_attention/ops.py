"""Flash-attention entry points: the CUDA kernel on CUDA tensors, the plain
version on CPU tensors.

Replaces the TPU kernel ``repro/kernels/flash_attention/kernel.py::
flash_attention_fwd`` (body ``_flash_fwd_kernel``) with
``csrc/flash_attention.cu``.  What bounds it on the H100: a decode step is
bytes-bound (each compact K/V byte feeds the query heads of its group for
~1 flop each), a prefill chunk operations-bound.  The kernel reads compact
GQA K/V once per (batch, kv head) block, with the group's query heads packed
as rows; its bf16 products run on tensor cores (``mma.sync``), fp32 on CUDA
cores; K/V tiles stream through a ring of ``cp.async`` stages; tiles that no
row of a block sees are skipped, and tiles that every row sees in full skip
the mask; a decode-sized call splits its keys over blocks, merged by a
second small kernel (see the source's head).

``flash_attention`` is the forward under autograd, for training: its
backward recomputes through the plain chunked attention, one query block at
a time (no backward kernel yet).

``flash_attention_fwd.launches`` counts calls that launch the kernel, one
per call (plain-version calls on the CPU do not count).  ``COUNTERS`` lists
it for ``runtime/compiled.py``, which adds a captured graph's launches at
each replay, so under a CUDA graph it still counts device launches.  The C
entry point sets the kernel's dynamic shared memory
(``cudaFuncSetAttribute``) at every launch; that call is no stream work and
is legal while a stream is captured.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _fake
from repro_torch.kernels.flash_attention import ref as _ref

NEG_INF = _ref.NEG_INF
HEAD_DIMS = (32, 64, 112, 128)
TILE_K = 64                     # keys per K/V tile of the kernel
MAX_TILES = 256                 # tiles one block may walk (the kernel's kMaxTiles)
DECODE_ROWS = 16                # packed rows (query heads x Sq) of a decode block
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_longlong, ctypes.c_longlong) \
    + (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 7 + (ctypes.c_float,) \
    + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)


def _check_positions(pos, B: int, S: int, device, name: str) -> tuple[torch.Tensor, int]:
    """Validate (S,) or (B, S) int32 positions; returns (tensor, batch stride)."""
    if pos.dtype != torch.int32 or pos.device != device or not pos.is_contiguous():
        raise ValueError(f"{name}: contiguous int32 on {device} required, got "
                         f"{pos.dtype} on {pos.device}")
    if pos.dim() == 1 and pos.shape == (S,):
        return pos, 0
    if pos.dim() == 2 and pos.shape == (B, S):
        return pos, S
    raise ValueError(f"{name}: shape {tuple(pos.shape)}, expected ({S},) or ({B}, {S})")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def num_splits(B: int, KV: int, rows: int, Sk: int, sms: int) -> int:
    """Blocks the kernel splits each (batch, kv head)'s keys over.  A block
    walks at most ``MAX_TILES`` tiles; a decode-sized call (``rows`` packed
    rows <= 16) also splits until there are about two blocks per SM."""
    tiles = -(-Sk // TILE_K)
    n = -(-tiles // MAX_TILES)
    if rows <= DECODE_ROWS:
        n = max(n, min(tiles, -(-2 * sms // (B * KV))))
    per = -(-tiles // n)
    return -(-tiles // per)


def fake_work(q, k, causal: bool, q_pos=None, k_pos=None) -> tuple[float, float]:
    """(flops, bytes) of one call as the bound counts them: 4·hd per
    (row, key) pair a query head attends to, and q, out, the compact K/V
    and the positions once each.  Under positions the pairs are data the
    trace does not hold, so every pair counts (the most the call could
    need); causal without them, row i sees keys 0 .. i."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if causal and q_pos is None:
        inside = min(Sq, Sk)
        pairs = inside * (inside + 1) // 2 + (Sq - inside) * Sk
    else:
        pairs = Sq * Sk
    e = q.element_size()
    nbytes = 2 * B * Sq * H * hd * e + 2 * B * Sk * KV * hd * e + _fake.nbytes(q_pos, k_pos)
    return 4.0 * hd * H * B * pairs, float(nbytes)


def flash_attention_fwd(q, k, v, *, causal: bool = True, q_pos=None, k_pos=None,
                        return_residuals: bool = False):
    """q (B, Sq, H, hd), k/v (B, Sk, KV, hd) with ``H % KV == 0`` (query
    head h reads kv head h // (H // KV)) -> out (B, Sq, H, hd) in q's dtype,
    or (out, m, l) with m/l (B, H, Sq) fp32.

    ``q_pos``/``k_pos`` ((S,) or (B, S) int32) replace the row/column index
    in the causal mask (``k_pos <= q_pos``); they are ignored when
    ``causal`` is False, as in the TPU kernel."""
    tensors = (q, k, v)
    if all(t.device.type == "cpu" for t in tensors):
        return _ref.flash_attention_fwd(q, k, v, causal=causal, q_pos=q_pos, k_pos=k_pos,
                                        return_residuals=return_residuals)
    dev = q.device
    fake = _fake.is_fake(*tensors)          # no data: allocate and record, no launch
    if (dev.type != "cuda" and not fake) or any(t.device != dev for t in tensors):
        raise ValueError("flash_attention_fwd: q, k, v must share one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd: float32 or bfloat16 q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_fwd: bad shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV < 1 or H % KV:
        raise ValueError(f"flash_attention_fwd: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (kv heads must divide the query heads)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {hd} not in {HEAD_DIMS}")
    if min(B, Sq, Sk, H) < 1:
        raise ValueError("flash_attention_fwd: empty input")
    if not all(t.is_contiguous() and (fake or t.data_ptr() % 16 == 0) for t in tensors):
        raise ValueError("flash_attention_fwd: the kernel takes contiguous, 16-byte "
                         "aligned q/k/v")
    positional = causal and q_pos is not None
    qp = kp = None
    qs = ks = 0
    if positional:
        if k_pos is None:
            raise ValueError("q_pos requires k_pos")
        qp, qs = _check_positions(q_pos, B, Sq, dev, "q_pos")
        kp, ks = _check_positions(k_pos, B, Sk, dev, "k_pos")
    out = torch.empty_like(q)
    m = l = None
    if return_residuals:
        m = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
        l = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    sms = _fake.H100_SMS if fake else _sm_count(dev.index or 0)
    nsplit = num_splits(B, KV, (H // KV) * Sq, Sk, sms)
    part_o = part_m = part_l = None
    if nsplit > 1:
        rows = B * H * Sq
        part = torch.empty(nsplit * rows * (hd + 2), dtype=torch.float32, device=dev)
        part_o, part_m, part_l = part.split([nsplit * rows * hd, nsplit * rows, nsplit * rows])
    if fake:
        _fake.record("flash_attention_fwd", (q, k, v), *fake_work(q, k, causal, qp, kp))
        return (out, m, l) if return_residuals else out
    fn = _build.function("repro_flash_attention_fwd", _ARGTYPES)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ptr(qp), ptr(kp),
            qs, ks, ptr(m), ptr(l), ptr(part_o), ptr(part_m), ptr(part_l),
            B, H, KV, Sq, Sk, hd, int(causal), float(hd ** -0.5), nsplit, sms,
            _DTYPE_CODES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    if return_residuals:
        return out, m, l
    return out


flash_attention_fwd.launches = 0
COUNTERS = ((flash_attention_fwd, "launches"),)


class _FlashAttention(torch.autograd.Function):
    """K1 under autograd (the port of ``repro/kernels/flash_attention/ops.py
    ::flash_attention``'s custom VJP).  The forward is the kernel on CUDA
    tensors (its plain version on CPU tensors) and saves only q, k, v; the
    backward recomputes through the port's ``chunked_attention`` one query
    block at a time (``models.attention.chunked_attention_vjp``), as the
    JAX VJP recomputes through jnp."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return flash_attention_fwd(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.models.attention import chunked_attention_vjp

        q, k, v = ctx.saved_tensors
        dq, dk, dv = chunked_attention_vjp(q, k, v, g, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True):
    """q (B, S, H, hd), compact k/v (B, S, KV, hd) -> out (B, S, H, hd),
    differentiable: dq in q's dtype, dk/dv summed over each kv head's query
    heads."""
    return _FlashAttention.apply(q, k, v, causal)
