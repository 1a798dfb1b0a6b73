"""Flash-attention forward entry point: the CUDA kernel on CUDA tensors, the
plain version on CPU tensors.

Replaces the TPU kernel ``repro/kernels/flash_attention/kernel.py::
flash_attention_fwd`` (body ``_flash_fwd_kernel``) with
``csrc/flash_attention.cu``.  What bounds it on the H100: at decode (one q
row per slot against the whole gathered cache view) bytes — each K/V element
is read once for ~4 flops; at a prefill chunk the arithmetic grows with the
chunk length.  The design stages K/V tiles in shared memory once per block
and reuses each tile for every q row of the block (16 rows at prefill); at
decode, where a block has a single row, its four warps split each tile's
keys instead so the loads are spread over more threads.  It computes with
fp32 FMAs on CUDA cores — tensor cores (``wgmma``), TMA pipelining and
reading compact GQA heads are later work.

``flash_attention_fwd.launches`` counts kernel launches (plain-version calls
on the CPU do not count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref as _ref

NEG_INF = _ref.NEG_INF
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_longlong, ctypes.c_longlong) \
    + (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 6 + (ctypes.c_float, ctypes.c_int,
                                                       ctypes.c_void_p)


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


def flash_attention_fwd(q, k, v, *, causal: bool = True, q_pos=None, k_pos=None,
                        return_residuals: bool = False):
    """q (B, Sq, H, hd), k/v (B, Sk, H, hd) with equal head counts ->
    out (B, Sq, H, hd) in q's dtype, or (out, m, l) with m/l (B, H, Sq) fp32.

    ``q_pos``/``k_pos`` ((S,) or (B, S) int32) replace the row/column index
    in the causal mask (``k_pos <= q_pos``); they are ignored when
    ``causal`` is False, as in the TPU kernel."""
    tensors = (q, k, v)
    if all(t.device.type == "cpu" for t in tensors):
        return _ref.flash_attention_fwd(q, k, v, causal=causal, q_pos=q_pos, k_pos=k_pos,
                                        return_residuals=return_residuals)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("flash_attention_fwd: q, k, v must share one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd: float32 or bfloat16 q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_fwd: bad shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    if k.shape[0] != B or k.shape[2:] != (H, hd):
        raise ValueError(f"flash_attention_fwd: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (expand GQA heads first)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {hd} not in {HEAD_DIMS}")
    if min(B, Sq, Sk, H) < 1:
        raise ValueError("flash_attention_fwd: empty input")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
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
    fn = _build.function("repro_flash_attention_fwd", _ARGTYPES)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ptr(qp), ptr(kp),
            qs, ks, ptr(m), ptr(l), B, H, Sq, Sk, hd, int(causal), float(hd ** -0.5),
            _DTYPE_CODES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    if return_residuals:
        return out, m, l
    return out


flash_attention_fwd.launches = 0
