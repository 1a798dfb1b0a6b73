"""The port's SSD scan on the CPU: its plain versions (the route a CPU tensor
takes through ``ops.ssd``) against the JAX package's Pallas kernel in
interpret mode and its naive scan, on the same numpy inputs, at the JAX SSD
tests' tolerance (1e-3); a ragged S (no chunk halving); the decode step and
its hand-off from the prefill state (1e-4).  The CUDA kernel itself is held
against these plain versions on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ref as jref
from repro.kernels.ssd.kernel import ssd_pallas
from repro_torch.kernels.ssd import ops, ref

# tests/test_kernels_ssd.py: (B, S, H, P, G, N)
SHAPES = [
    (2, 128, 4, 32, 1, 16),
    (1, 256, 4, 64, 2, 32),
    (1, 64, 2, 16, 1, 8),
]
TOL = 1e-3
TOL_STEP = 1e-4


def _inputs(seed, B, S, H, P, G, N):
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    x = normal(B, S, H, P)
    dt = np.log1p(np.exp(normal(B, S, H))).astype(np.float32)        # softplus
    A = -np.exp(normal(H, scale=0.3)).astype(np.float32)
    return x, dt, A, normal(B, S, G, N, scale=0.3), normal(B, S, G, N, scale=0.3)


def _jax(arrs):
    return [jnp.asarray(a) for a in arrs]


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _close(a, b, tol):
    a = a.numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(a, np.asarray(b), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_ssd_matches_pallas_kernel(shape):
    """``ops.ssd`` on CPU tensors (``ssd_chunked``) and ``impl="ref"``
    against ``ssd_pallas(interpret=True)``, y and final state."""
    arrs = _inputs(0, *shape)
    jy, js = ssd_pallas(*_jax(arrs), chunk=64, interpret=True)
    for impl in ("kernel", "ref"):
        y, st = ops.ssd(*_torch(arrs), impl=impl)
        assert y.dtype == torch.float32 and st.shape == js.shape
        _close(y, jy, TOL)
        _close(st, js, TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_naive_matches_jax_naive(shape):
    arrs = _inputs(1, *shape)
    jy, js = jref.ssd_naive(*_jax(arrs))
    y, st = ops.ssd(*_torch(arrs), impl="naive")
    _close(y, jy, TOL)
    _close(st, js, TOL)


@pytest.mark.parametrize("S,chunk", [(100, 64), (1, 64), (37, 16)])
def test_ragged_s_is_padded_not_halved(S, chunk):
    """An S that no chunk divides: the padded last chunk gives the naive
    scan's y and final state (JAX would halve the chunk to 4, 1 or 1)."""
    arrs = _inputs(2, 2, S, 4, 16, 2, 8)
    jy, js = jref.ssd_naive(*_jax(arrs))
    y, st = ref.ssd_chunked(*_torch(arrs), chunk=chunk)
    assert y.shape == (2, S, 4, 16)
    _close(y, jy, TOL)
    _close(st, js, TOL)


def test_plain_versions_take_an_initial_state():
    arrs = _inputs(3, 1, 96, 4, 16, 1, 8)
    s0 = np.random.default_rng(4).standard_normal((1, 4, 8, 16)).astype(np.float32)
    jy, js = jref.ssd_chunked(*_jax(arrs), chunk=32, initial_state=jnp.asarray(s0))
    for impl in ("ref", "naive", "kernel"):
        y, st = ops.ssd(*_torch(arrs), chunk=32, impl=impl, initial_state=torch.from_numpy(s0))
        _close(y, jy, TOL)
        _close(st, js, TOL)


def test_bf16_inputs_upcast_and_return_x_dtype():
    arrs = _inputs(5, 1, 64, 2, 16, 1, 8)
    x, dt, A, B, C = _torch(arrs)
    y, st = ops.ssd(x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16())
    ry, rs = ops.ssd(x.bfloat16().float(), dt, A, B.bfloat16().float(), C.bfloat16().float())
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    torch.testing.assert_close(y, ry.bfloat16())
    torch.testing.assert_close(st, rs)


def test_ssd_step_matches_jax_step():
    rng = np.random.default_rng(6)
    B, H, N, P = 2, 4, 8, 16
    state = rng.standard_normal((B, H, N, P)).astype(np.float32)
    x_t = rng.standard_normal((B, H, P)).astype(np.float32)
    dt_t = np.log1p(np.exp(rng.standard_normal((B, H)))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32)
    B_t = (0.3 * rng.standard_normal((B, H, N))).astype(np.float32)
    C_t = (0.3 * rng.standard_normal((B, H, N))).astype(np.float32)
    arrs = (state, x_t, dt_t, A, B_t, C_t)
    js, jy = jref.ssd_step(*_jax(arrs))
    st, y = ops.ssd_step(*_torch(arrs))
    _close(st, js, TOL_STEP)
    _close(y, jy, TOL_STEP)


def test_decode_step_matches_scan_tail():
    """``ssd_step`` continues exactly from the chunked prefill's final state
    (the port of ``tests/test_kernels_ssd.py::test_decode_step_matches_scan_tail``)."""
    B, S, H, P, G, N = 1, 64, 2, 16, 1, 8
    arrs = _inputs(7, B, S + 1, H, P, G, N)
    jy_all, _ = jref.ssd_naive(*_jax(arrs))
    x, dt, A, Bm, Cm = _torch(arrs)
    _, state = ops.ssd(x[:, :S], dt[:, :S], A, Bm[:, :S], Cm[:, :S])
    Bh, Ch = ref._expand_groups(Bm, H), ref._expand_groups(Cm, H)
    _, y_last = ops.ssd_step(state, x[:, S], dt[:, S], A, Bh[:, S], Ch[:, S])
    _close(y_last, jy_all[:, S], TOL_STEP)


def test_ssd_wrapper_rejects_an_unknown_impl():
    arrs = _torch(_inputs(8, 1, 8, 2, 4, 1, 4))
    with pytest.raises(ValueError, match="impl"):
        ops.ssd(*arrs, impl="pallas")
    assert ops.ssd.launches == 0            # CPU tensors never launch the kernel


def test_bf16_kernel_leaves_room_for_two_blocks_per_sm():
    """The bf16 template's shared memory at the serving shape (N 128, P 64)
    is at most half of what an SM gives blocks, so two blocks share an SM;
    the fp32 template's stays as it was (one block per SM)."""
    assert ops._smem_bytes(128, 64, torch.bfloat16) <= ops.SMEM_LIMIT // 2
    assert ops._smem_bytes(128, 64, torch.float32) == 137_216 > ops.SMEM_LIMIT // 2
    for N, P in ((128, 64), (64, 64), (16, 32)):      # mamba2, zamba2, reduced
        ops.check_shape(torch.bfloat16, N, P)
    ops.check_shape(torch.float32, 24, 64)            # fp32 keeps multiples of 4


@pytest.mark.parametrize("dtype,N,P", [
    (torch.bfloat16, 24, 64),          # N not a multiple of 16
    (torch.bfloat16, 128, 40),         # P not a multiple of 16
    (torch.bfloat16, 8, 16),
    (torch.float32, 6, 64),            # fp32 keeps multiples of 4
    (torch.float32, 0, 64),
    (torch.bfloat16, 1024, 64),        # beyond one block's shared memory
])
def test_kernel_shape_rule_rejects_before_any_launch(dtype, N, P):
    """``check_shape`` is the rule the wrapper applies before it launches:
    N and P positive multiples of 16 in bf16 (the tensor-core tiles), of 4
    in fp32, and a block's shared memory within the SM's limit."""
    with pytest.raises(ValueError, match="multiples of|shared memory"):
        ops.check_shape(dtype, N, P)
