"""SSD scan entry point: the CUDA kernel on CUDA tensors, the plain version
on CPU tensors.

Replaces the TPU kernel ``repro/kernels/ssd/kernel.py::ssd_pallas`` (body
``_ssd_kernel``) with ``csrc/ssd.cu``, which holds two templates.  Both keep
the (N, P) fp32 state of one (batch, head) in shared memory across a loop
over chunks of 64 and stage each chunk's x, dt and B/C group there.

- bfloat16 x/B/C (what the Mamba2 model passes): the four products run on
  the tensor cores (``mma.sync`` m16n8k16, bf16 in, fp32 accumulate); an
  fp32 operand (the intra-chunk matrix M, the state, w∘x) is split into two
  bf16 terms (hi + lo, residual ≤ 2⁻¹⁸|v|), so the result stays fp32-class.
  Bound by bytes at the serving shape (~185 MB against ~24 GFLOP), it runs
  latency-bound at ~12× that (one block walks its chunks in order); ~96 KB
  of shared memory at N 128, P 64, two blocks per SM.  N and P must be
  multiples of 16.
- float32 x/B/C: fp32 FMAs on CUDA cores (no TF32), bound by operations;
  N and P multiples of 4.

One C·Bᵀ per group shared by its heads, splitting chunks across blocks and
``wgmma``/TMA are later work.

``ssd_autograd`` is the scan under autograd, for training: its forward is
the kernel on CUDA tensors (``ssd_chunked`` on CPU tensors), and its
backward recomputes through the plain ``ssd_chunked`` in fp32 and
differentiates that (no backward kernel yet).  JAX's SSD has no VJP: JAX
trains through its jnp ``ssd_chunked`` on fp32 casts of x, B and C, which
is the function this backward differentiates.  ``ssd`` takes this route
when a grad is wanted.

``impl``:
  - ``"kernel"`` (default): the CUDA kernel on CUDA tensors, ``ssd_chunked``
    on CPU tensors;
  - ``"ref"``: ``ssd_chunked`` (the blocked plain version) on any device;
  - ``"naive"``: ``ssd_naive`` (step by step) on any device.

``ssd.launches`` counts kernel launches (plain-version calls do not count);
``ssd_autograd.launches`` counts those made by ``ssd_autograd``'s forward,
which count on ``ssd.launches`` too.  ``COUNTERS`` lists both for
``runtime/compiled.py``, which adds a captured graph's launches at each
replay, so under a CUDA graph they still count device launches.  The C
entry point sets the kernel's shared memory and carveout
(``cudaFuncSetAttribute``) at every launch, which is legal while a stream is
captured.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.profiler import record_function

from repro_torch.kernels import _build
from repro_torch.kernels.ssd import ref as _ref

CHUNK = 64                                  # the kernel's chunk length (kQ)
SMEM_LIMIT = 232_448                        # dynamic shared memory a block may use
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SHAPE_MULTIPLE = {torch.float32: 4, torch.bfloat16: 16}   # of N and P
_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)


def _smem_bytes(N: int, P: int, dtype: torch.dtype) -> int:
    """Shared memory of one block (mirrors ``smem_bytes`` in ``ssd.cu``)."""
    if dtype == torch.bfloat16:
        # fp32 state (N rows of P + 4); bf16 x, B, C and the hi/lo terms of
        # M (Q x Q), later of w∘x (Q x P), rows padded by 8; dt, cum,
        # exp(cum) and w
        mp = max(CHUNK, P) + 8
        return 4 * N * (P + 4) + 2 * CHUNK * ((P + 8) + 2 * (N + 8) + 2 * mp) + 16 * CHUNK
    qs = CHUNK + 4
    return 4 * (N * P + CHUNK * P + 2 * N * qs + CHUNK * qs + 4 * CHUNK)


def check_shape(dtype: torch.dtype, N: int, P: int) -> None:
    """Raise ``ValueError`` unless the kernel takes state size N and head
    dim P in ``dtype``: positive multiples of 16 in bfloat16 (the tensor-core
    tiles), of 4 in float32, within one block's shared memory."""
    m = _SHAPE_MULTIPLE[dtype]
    if min(N, P) < 1 or N % m or P % m:
        raise ValueError(f"ssd: in {str(dtype).replace('torch.', '')} the kernel takes N and P "
                         f"that are positive multiples of {m}, got N {N}, P {P}")
    if _smem_bytes(N, P, dtype) > SMEM_LIMIT:
        raise ValueError(f"ssd: N {N} x P {P} needs {_smem_bytes(N, P, dtype)} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")


def occupancy(dtype: torch.dtype, N: int, P: int) -> tuple[int, int]:
    """(shared memory per block in bytes, blocks per SM) of the kernel for
    (dtype, N, P) on the current CUDA device, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    check_shape(dtype, N, P)
    smem, blocks = ctypes.c_longlong(), ctypes.c_int()
    fn = _build.function("repro_ssd_occupancy", (ctypes.c_int,) * 3 + (ctypes.c_void_p,) * 2)
    _build.check(fn(N, P, _DTYPE_CODES[dtype], ctypes.addressof(smem),
                    ctypes.addressof(blocks)), "ssd occupancy")
    return smem.value, blocks.value


def ssd(x, dt, A, B, C, *, chunk: int = CHUNK, impl: str = "kernel",
        initial_state: Optional[torch.Tensor] = None):
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); B/C: (B,S,G,N) -> (y (B,S,H,P) in
    x's dtype, final_state (B,H,N,P) fp32).  On the kernel route a call
    that needs a grad (grad mode on, an input requiring one) goes through
    ``ssd_autograd``."""
    if impl == "naive":
        return _ref.ssd_naive(x, dt, A, B, C, initial_state=initial_state)
    if impl == "ref":
        return _ref.ssd_chunked(x, dt, A, B, C, chunk=chunk, initial_state=initial_state)
    if impl != "kernel":
        raise ValueError(f"unknown ssd impl {impl!r}")
    tensors = (x, dt, A, B, C)
    if (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
            and initial_state is None and chunk == CHUNK):
        return ssd_autograd(x, dt, A, B, C)
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
    if min(Bs, S, H) < 1:
        raise ValueError(f"ssd: empty input x {tuple(x.shape)}")
    check_shape(x.dtype, N, P)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd: the kernel takes contiguous inputs")
    if x.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("ssd: the bf16 kernel copies x, B and C in 16-byte pieces; their "
                         "data must start on a 16-byte boundary")
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


class _SSD(torch.autograd.Function):
    """K3 under autograd.  The forward saves x, dt, A, B, C and runs the
    kernel on CUDA tensors (``ssd_chunked`` on CPU tensors); the backward
    recomputes ``ssd_chunked`` on fp32 copies of them under the profiler
    span ``ssd_vjp`` and differentiates it, as K1's backward recomputes
    through ``chunked_attention`` under ``attention_vjp``."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.set_materialize_grads(False)
        if all(t.device.type == "cpu" for t in (x, dt, A, B, C)):
            return _ref.ssd_chunked(x, dt, A, B, C, chunk=CHUNK)
        out = _ssd_kernel(x, dt, A, B, C, chunk=CHUNK, initial_state=None)
        ssd_autograd.launches += 1
        return out

    @staticmethod
    def backward(ctx, dy, dfinal):
        saved = ctx.saved_tensors
        with record_function("ssd_vjp"), torch.enable_grad():
            ins = [t.detach().float().requires_grad_() for t in saved]
            y, final = _ref.ssd_chunked(*ins, chunk=CHUNK)
            outs, cots = [], []
            for out, cot in ((y, dy), (final, dfinal)):
                if cot is not None:
                    outs.append(out)
                    cots.append(cot.float())
            grads = torch.autograd.grad(outs, ins, cots)
        return tuple(g.to(t.dtype) for g, t in zip(grads, saved))


def ssd_autograd(x, dt, A, B, C):
    """``ssd`` (zero initial state, chunk ``CHUNK``) under autograd: (y in
    x's dtype, final_state fp32); dx, dB, dC come back in their inputs'
    dtype, ddt and dA in fp32.  The final state's grad may be None (unused)
    or a tensor."""
    return _SSD.apply(x, dt, A, B, C)


ssd_autograd.launches = 0
COUNTERS = ((ssd, "launches"), (ssd_autograd, "launches"))


def ssd_step(state, x_t, dt_t, A, B_t, C_t):
    """Single recurrent decode step (plain torch on every device, as the
    JAX package's ``ssd_step`` is jnp, not a kernel)."""
    return _ref.ssd_step(state, x_t, dt_t, A, B_t, C_t)
