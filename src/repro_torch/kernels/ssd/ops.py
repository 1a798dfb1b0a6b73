"""SSD scan entry point: the CUDA kernel on CUDA tensors, the plain version
on CPU tensors.

Replaces the TPU kernel ``repro/kernels/ssd/kernel.py::ssd_pallas`` (body
``_ssd_kernel``) with ``csrc/ssd.cu``.  What bounds it on the H100:
operations — per (batch, head) the inter-chunk product and the state update
are 2·S·N·P FMAs each against one read of x and one write of y (at the
serving shape ~24 GFLOP for ~357 MB).  The design keeps the (N, P) fp32
state of one (batch, head) in shared memory across a loop over chunks of
64, stages each chunk's x, dt and B/C group there, and forms every product
from 4×4 register tiles of fp32 FMAs.  Tensor cores, one C·Bᵀ per group
shared by its heads, and splitting chunks across blocks are later work.

``impl``:
  - ``"kernel"`` (default): the CUDA kernel on CUDA tensors, ``ssd_chunked``
    on CPU tensors;
  - ``"ref"``: ``ssd_chunked`` (the blocked plain version) on any device;
  - ``"naive"``: ``ssd_naive`` (step by step) on any device.

``ssd.launches`` counts kernel launches (plain-version calls do not count).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd import ref as _ref

CHUNK = 64                                  # the kernel's chunk length (kQ)
SMEM_LIMIT = 232_448                        # dynamic shared memory a block may use
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)


def _smem_bytes(N: int, P: int) -> int:
    """Shared memory of one block (mirrors ``smem_bytes`` in ``ssd.cu``)."""
    qs = CHUNK + 4
    return 4 * (N * P + CHUNK * P + 2 * N * qs + CHUNK * qs + 4 * CHUNK)


def ssd(x, dt, A, B, C, *, chunk: int = CHUNK, impl: str = "kernel",
        initial_state: Optional[torch.Tensor] = None):
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); B/C: (B,S,G,N) -> (y (B,S,H,P) in
    x's dtype, final_state (B,H,N,P) fp32)."""
    if impl == "naive":
        return _ref.ssd_naive(x, dt, A, B, C, initial_state=initial_state)
    if impl == "ref":
        return _ref.ssd_chunked(x, dt, A, B, C, chunk=chunk, initial_state=initial_state)
    if impl != "kernel":
        raise ValueError(f"unknown ssd impl {impl!r}")
    tensors = (x, dt, A, B, C)
    if all(t.device.type == "cpu" for t in tensors):
        return _ref.ssd_chunked(x, dt, A, B, C, chunk=chunk, initial_state=initial_state)
    return _ssd_kernel(x, dt, A, B, C, chunk=chunk, initial_state=initial_state)


def _ssd_kernel(x, dt, A, B, C, *, chunk, initial_state):
    tensors = (x, dt, A, B, C)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("ssd: x, dt, A, B, C must share one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if initial_state is not None:
        raise ValueError("ssd: the kernel starts from a zero state (decode uses ssd_step)")
    if chunk != CHUNK:
        raise ValueError(f"ssd: the kernel's chunk is {CHUNK}, got {chunk}")
    if x.dtype not in _DTYPE_CODES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd: float32 or bfloat16 x/B/C of one dtype, got "
                        f"{x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd: float32 dt and A, got {dt.dtype}, {A.dtype}")
    if x.dim() != 4 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError(f"ssd: bad shapes x {tuple(x.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)}")
    Bs, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if (dt.shape != (Bs, S, H) or A.shape != (H,) or B.shape[:2] != (Bs, S)
            or G < 1 or H % G):
        raise ValueError(f"ssd: shapes do not agree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B/C {tuple(B.shape)}")
    if min(Bs, S, H, P, N) < 1 or P % 4 or N % 4:
        raise ValueError(f"ssd: the kernel takes P and N that are positive multiples "
                         f"of 4, got P {P}, N {N}")
    if _smem_bytes(N, P) > SMEM_LIMIT:
        raise ValueError(f"ssd: N {N} x P {P} needs {_smem_bytes(N, P)} bytes of shared "
                         f"memory, more than {SMEM_LIMIT}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd: the kernel takes contiguous inputs")
    y = torch.empty_like(x)
    final = torch.empty((Bs, H, N, P), dtype=torch.float32, device=dev)
    fn = _build.function("repro_ssd_fwd", _ARGTYPES)
    rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), final.data_ptr(), Bs, S, H, G, N, P, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "ssd")
    ssd.launches += 1
    return y, final


ssd.launches = 0


def ssd_step(state, x_t, dt_t, A, B_t, C_t):
    """Single recurrent decode step (plain torch on every device, as the
    JAX package's ``ssd_step`` is jnp, not a kernel)."""
    return _ref.ssd_step(state, x_t, dt_t, A, B_t, C_t)
