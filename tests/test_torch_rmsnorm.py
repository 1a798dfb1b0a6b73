"""K2's three entry points on the CPU against the JAX package, on the same
numpy inputs:

* the gated forward — ``gated_rmsnorm_reference`` and ``ops.rmsnorm(...,
  gate=z)`` (the route a CPU tensor takes) — against JAX's
  ``rmsnorm(params, y * jax.nn.silu(z), eps)`` as ``repro.models.mamba2``
  calls it: fp32 1e-5, bf16 2e-2 (the JAX kernel tests' tolerances);
* ``rmsnorm_backward_reference`` (the backward's CPU route and its oracle on
  the card) against ``jax.grad`` of JAX's ``_rmsnorm``: fp32 1e-5;
* ``models.norms.gated_rmsnorm`` with a grad to take and without one;
* ``ops._template``, the layout rule the wrappers give the CUDA kernels.

The CUDA kernels are held against these plain versions on the card
(``chip_smoke.py`` phase 3, ``tests/test_torch_cuda.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.norms import _rmsnorm as jax_rmsnorm
from repro.models.norms import rmsnorm as jax_model_rmsnorm
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm import ref as rms_ref
from repro_torch.models import norms

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# a prefill block, an odd width, a decode row (B 4, S 1) and the qk-norm width
GATED_SHAPES = [(2, 16, 256), (3, 333), (4, 1, 512), (5, 128)]


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a.astype(jnp.float32))


@pytest.mark.parametrize("route", ["plain", "wrapper"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GATED_SHAPES)
def test_gated_rmsnorm_matches_jax_gate_norm(shape, dtype, route):
    jd, td = DTYPES[dtype]
    y, z = _normal(30, shape, 2.0), _normal(31, shape, 2.0)
    scale = 1 + 0.3 * _normal(32, shape[-1:])
    jy, jz = jnp.asarray(y, jd), jnp.asarray(z, jd)
    ref = jax_model_rmsnorm({"scale": jnp.asarray(scale)}, jy * jax.nn.silu(jz), 1e-5)
    ty, tz, ts = torch.from_numpy(y).to(td), torch.from_numpy(z).to(td), torch.from_numpy(scale)
    before = (rms_ops.rmsnorm.launches, rms_ops.rmsnorm.gated_launches)
    if route == "plain":
        out = rms_ref.gated_rmsnorm_reference(ty, tz, ts, 1e-5)
    else:
        out = rms_ops.rmsnorm(ty, ts, 1e-5, gate=tz)
    assert out.dtype == td and out.shape == ty.shape
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=TOL[dtype], rtol=TOL[dtype])
    assert (rms_ops.rmsnorm.launches, rms_ops.rmsnorm.gated_launches) == before


def test_gated_reference_rounds_as_the_eager_composition():
    """bf16: silu(z) and the product are each rounded to bf16 before the
    fp32 statistics, so the plain version is the eager composition exactly."""
    y = torch.from_numpy(_normal(33, (6, 96), 2.0)).bfloat16()
    z = torch.from_numpy(_normal(34, (6, 96), 2.0)).bfloat16()
    s = torch.from_numpy(1 + 0.3 * _normal(35, (96,)))
    composed = rms_ref.rmsnorm_reference(y * torch.nn.functional.silu(z), s, 1e-5)
    assert torch.equal(rms_ref.gated_rmsnorm_reference(y, z, s, 1e-5), composed)


@pytest.mark.parametrize("shape", [(4, 6, 128), (512, 128), (3, 333), (2, 3, 2048)])
@pytest.mark.parametrize("route", ["plain", "wrapper"])
def test_rmsnorm_backward_reference_matches_jax_grad(shape, route):
    x = _normal(40, shape, 3.0)
    scale = 1 + 0.3 * _normal(41, shape[-1:])
    w = _normal(42, shape)
    jdx, jds = jax.grad(lambda x_, s_: jnp.sum(jax_rmsnorm(s_, x_, 1e-5) * w), (0, 1))(
        jnp.asarray(x), jnp.asarray(scale))
    tx, ts, tg = (torch.from_numpy(a) for a in (x, scale, w))
    fn = rms_ref.rmsnorm_backward_reference if route == "plain" else rms_ops.rmsnorm_backward
    before = rms_ops.rmsnorm.backward_launches
    dx, ds = fn(tx, ts, tg, 1e-5)
    assert dx.dtype == ds.dtype == torch.float32
    assert dx.shape == tx.shape and ds.shape == ts.shape
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), atol=1e-5, rtol=1e-5)
    assert rms_ops.rmsnorm.backward_launches == before


def test_rmsnorm_backward_keeps_the_input_dtypes():
    """bf16 x with an fp32 master scale (the training forward): dx in bf16,
    dscale in fp32, the fp32 math on the bf16 values."""
    x = torch.from_numpy(_normal(43, (5, 64), 3.0)).bfloat16()
    s = torch.from_numpy(1 + 0.1 * _normal(44, (64,)))
    g = torch.from_numpy(_normal(45, (5, 64))).bfloat16()
    dx, ds = rms_ref.rmsnorm_backward_reference(x, s, g, 1e-5)
    assert dx.dtype == torch.bfloat16 and ds.dtype == torch.float32
    x32 = x.float().requires_grad_()
    s32 = s.clone().requires_grad_()
    rdx, rds = torch.autograd.grad(rms_ref.rmsnorm_reference(x32, s32, 1e-5), (x32, s32),
                                   g.float())
    torch.testing.assert_close(dx.float(), rdx, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(ds, rds, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_rmsnorm_with_and_without_a_grad_to_take(dtype):
    """The model's gate norm: the gated wrapper without a grad, the
    composition through ``rmsnorm_autograd`` with one — equal values, and
    the grads of the second are the composition's."""
    y = torch.from_numpy(_normal(50, (3, 5, 64), 2.0)).to(dtype)
    z = torch.from_numpy(_normal(51, (3, 5, 64), 2.0)).to(dtype)
    params = {"scale": torch.from_numpy(1 + 0.3 * _normal(52, (64,)))}
    with torch.no_grad():
        plain = norms.gated_rmsnorm(params, y, z, 1e-5)
    ty, tz = y.clone().requires_grad_(), z.clone().requires_grad_()
    graded = norms.gated_rmsnorm(params, ty, tz, 1e-5)
    assert plain.grad_fn is None and graded.grad_fn is not None
    assert torch.equal(plain, graded.detach())
    assert torch.equal(plain, norms.gated_rmsnorm(params, y, z, 1e-5, impl="ref"))
    graded.float().sum().backward()
    assert ty.grad is not None and tz.grad is not None


# ---------------------------------------------------------------- templates

def _capacity_holds(tpl, D, max_nv, max_tpr):
    if tpl.tpr > 32:
        assert tpl.tpr % 32 == 0 and tpl.tpr <= max_tpr
    else:
        assert tpl.tpr & (tpl.tpr - 1) == 0
    assert D % tpl.vec == 0
    if tpl.vec == 1:
        max_nv = rms_ops.PAIR_NV
    if tpl.nv:
        assert tpl.nv <= max_nv and tpl.nv * tpl.tpr * tpl.vec >= D
        assert tpl.vec > 1 or tpl.nv == rms_ops.PAIR_NV             # scalar: two a thread
    else:
        assert tpl.tpr == max_tpr and D > max_nv * max_tpr * tpl.vec


def test_template_vector_and_scalar_layouts():
    bf16, f32 = torch.bfloat16, torch.float32
    T = rms_ops.Template
    assert rms_ops._template(3584, bf16, 0, 256, 4096) == T(8, 2, 224)
    assert rms_ops._template(3584, f32, 0, 256) == T(4, 2, 448)
    assert rms_ops._template(333, bf16, 0, 256).vec == 1                  # odd width
    assert rms_ops._template(3584, bf16, 2, 256).vec == 1                 # offset pointer
    assert rms_ops._template(3584, bf16, 0, 8).vec == 1                   # 8 bytes off
    assert rms_ops._template(128, bf16, 0) == T(8, 1, 16)                 # qk-norm
    assert rms_ops._template(64, bf16, 0) == T(8, 1, 8)                   # 4 rows a warp
    assert rms_ops._template(512, bf16, 0) == T(8, 2, 32)                 # a warp a row
    assert rms_ops._template(2048, bf16, 0) == T(8, 2, 128)
    assert rms_ops._template(2048, bf16, 0, backward=True) == T(8, 2, 128)
    assert rms_ops._template(2048, f32, 0, backward=True) == T(4, 2, 256)
    assert rms_ops._template(5120, bf16, 0, backward=True) == T(8, 0, 256)  # > 2 x 256 packs
    assert rms_ops._template(7168, f32, 0) == T(4, 4, 448)                # 2 x 512 too few
    assert rms_ops._template(7168, f32, 0, backward=True).nv == 0
    assert rms_ops._template(7168, bf16, 0, gated=True) == T(8, 2, 448)  # zamba2's gate
    assert rms_ops._template(7168, f32, 0, gated=True).nv == 0          # two-pass
    assert rms_ops._template(7, f32, 0) == T(1, 2, 4)                    # 2 elements a lane
    assert rms_ops._template(333, f32, 0) == T(1, 2, 192)
    assert rms_ops._template(40000, bf16, 0).nv == 0                     # two-pass loop
    assert rms_ops._template(2048, bf16, 2).nv == 0                      # scalar, wide
    assert T(8, 0, 512).describe() == "vec8 two-pass tpr512"
    assert T(1, 2, 64).describe() == "scalar nv2 tpr64"


@pytest.mark.parametrize("kind", ["forward", "gated", "backward"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_template_covers_every_width(dtype, kind):
    """Every width 1..9000 and a few wider get a template the kernels take:
    packs x threads hold the row, or the two-pass loop where they cannot."""
    max_nv = rms_ops.MAX_NV if kind == "forward" else rms_ops.PAIR_NV
    max_tpr = rms_ops.BWD_MAX_TPR if kind == "backward" else rms_ops.MAX_TPR
    kw = {"backward": kind == "backward", "gated": kind == "gated"}
    for D in list(range(1, 9001)) + [14336, 40000]:
        for ptr in (0, 2):
            _capacity_holds(rms_ops._template(D, dtype, ptr, **kw), D, max_nv, max_tpr)
