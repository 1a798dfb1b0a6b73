"""The port on a CUDA GPU: each hand-written kernel against its plain
version (K1, K2 and K3 also under autograd), the wrappers' input checks,
and the serving paths (paged dense, step-engine mamba2, zamba2, the MoE
family, whisper and the VLM) and the training steps of every family with
``impl="kernel"`` against ``impl="ref"``; the compiled serving steps (CUDA
graphs) of every family against their eager steps;
the planner's block measurement (its forward, grad and full-remat grad
graphed, against the eager steps) and a calibration fitted from it; the
parallel runtime on a one-rank NCCL mesh (bitwise the single-device step:
dense, MoE, mamba2, whisper) and on gloo ranks sharing the card (tp 2
+ sp against one rank; two pipeline stages against one rank; two ranks of
the cp ring against one rank; two stages of two cp ranks each against one
rank); K2's split-row form against its plain
passes and the whole-row K2; the cp ring's K1 partials at zig-zag shapes
(phase 29's and, at llama3.2-1b-long's S 8 192, the ``pipeline_context``
rows of a ring inside a pipeline stage) and its hand-written backward
against autograd through the plain ring; the checkpoint writer's snapshot
of CUDA leaves (pinned host copies fenced by an event, ahead of an
in-place update) and a bf16 state through the card; a serving-mesh rank's
K1 decode partial (g = 8, a key offset, residuals, split-K) and K1
partials over cache slices merged into the whole call; the ssm and hybrid
serving mesh's kernel rows (K1 at zamba2's hd 112 and g = 1 over a cache
slice with residuals, K2's split-row forward at a tp 2 rank's prefill and
decode rows, K3 on a rank's heads and the group they read) and reduced
mamba2 and zamba2 served by two gloo ranks sharing the card, the kernel
path against one device's plain path.

Every test here needs the card (``cuda`` marker) and skips without one.
This file imports no JAX, so on a GPU machine without JAX it runs with::

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import serving
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.models import attention as t_attn
from repro_torch.configs.registry import get_config
from repro_torch.models import build_model
from repro_torch.models.common import tree_paths

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_cuda_kernels_match_plain_versions(cuda_device):
    """Both kernels against their plain versions at decode, prefill-chunk and
    ragged shapes (fp32 1e-4, bf16 3e-2); the launch counters move."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    n_flash, n_rms = flash_ops.flash_attention_fwd.launches, rms_ops.rmsnorm.launches
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        for B, Sq, Sk in ((8, 1, 1025), (1, 256, 1280), (2, 37, 37)):
            q, k, v = (torch.randn((B, S, 32, 64), generator=g, device=cuda_device)
                       .to(dtype) for S in (Sq, Sk, Sk))
            off = torch.randint(0, Sk - Sq + 1, (B,), generator=g, device=cuda_device)
            kw = dict(causal=True, q_offset=off, kv_len=off + Sq)
            out = t_attn._flash(q, k, v, **kw)
            ref = t_attn.dense_attention(q.float(), k.float(), v.float(), **kw)
            torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)
        x = torch.randn((256, 2048), generator=g, device=cuda_device).to(dtype)
        s = torch.randn((2048,), generator=g, device=cuda_device)
        torch.testing.assert_close(rms_ops.rmsnorm(x, s).float(),
                                   rms_ops.rmsnorm_reference(x, s).float(),
                                   atol=tol, rtol=tol)
    assert flash_ops.flash_attention_fwd.launches > n_flash
    assert rms_ops.rmsnorm.launches > n_rms


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("width", [3584, 7168])
def test_cuda_rmsnorm_at_zamba2_widths(cuda_device, width, dtype, tol):
    """K2 at zamba2-7b's prefill rows: 8192 x d_model 3584 (the layer and
    shared-block norms) and 8192 x d_inner 7168 (the gate norm)."""
    g = torch.Generator(device=cuda_device).manual_seed(width)
    x = (3.0 * torch.randn((8192, width), generator=g, device=cuda_device)).to(dtype)
    s = torch.randn((width,), generator=g, device=cuda_device).to(dtype)
    n = rms_ops.rmsnorm.launches
    out = rms_ops.rmsnorm(x, s, 1e-5)
    assert rms_ops.rmsnorm.launches == n + 1
    torch.testing.assert_close(out.float(), rms_ops.rmsnorm_reference(x, s, 1e-5).float(),
                               atol=tol, rtol=tol)


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a view one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.flatten()
    return buf[1:].view(t.shape)


# (rows, D, dtype, misaligned, the template's description) — every layout K2 has
RMS_TEMPLATE_CASES = [
    (4096, 64, torch.bfloat16, False, "vec8 nv1 tpr8"),          # qk-norm, 4 rows a warp
    (4096, 64, torch.float32, False, "vec4 nv1 tpr16"),
    (4096, 128, torch.bfloat16, False, "vec8 nv1 tpr16"),
    (300, 512, torch.bfloat16, False, "vec8 nv2 tpr32"),
    (300, 1024, torch.float32, False, "vec4 nv2 tpr128"),
    (8, 2048, torch.bfloat16, False, "vec8 nv2 tpr128"),          # llama decode
    (4, 2560, torch.bfloat16, False, "vec8 nv2 tpr160"),          # mamba2 decode
    (512, 3584, torch.bfloat16, False, "vec8 nv2 tpr224"),
    (512, 7168, torch.float32, False, "vec4 nv4 tpr448"),
    (64, 14336, torch.float32, False, "vec4 nv8 tpr448"),
    (6, 40000, torch.bfloat16, False, "vec8 two-pass tpr512"),
    (7, 333, torch.float32, False, "scalar nv2 tpr192"),
    (300, 1000, torch.float32, True, "scalar nv2 tpr512"),
    (512, 3584, torch.bfloat16, True, "scalar two-pass tpr512"),
]


@pytest.mark.parametrize("rows,D,dtype,misaligned,template", RMS_TEMPLATE_CASES)
def test_cuda_rmsnorm_every_template_matches_plain_version(cuda_device, rows, D, dtype,
                                                           misaligned, template):
    """K2's forward at each of its templates (vector packs, scalar, two-pass;
    rows per warp to rows over warps), aligned and misaligned views: fp32
    1e-5, bf16 2e-2; one launch per call."""
    g = torch.Generator(device=cuda_device).manual_seed(D)
    x = (3.0 * torch.randn((rows, D), generator=g, device=cuda_device)).to(dtype)
    s = torch.randn((D,), generator=g, device=cuda_device).to(dtype)
    if misaligned:
        x = _misaligned(x)
    out_ptr = 0                                  # a fresh allocation is aligned
    assert rms_ops._template(D, dtype, x.data_ptr(), s.data_ptr(), out_ptr).describe() \
        == template
    n = rms_ops.rmsnorm.launches
    out = rms_ops.rmsnorm(x, s, 1e-5)
    assert rms_ops.rmsnorm.launches == n + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), rms_ops.rmsnorm_reference(x, s, 1e-5).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rows,D,misaligned", [(8192, 5120, False), (4, 7168, False),
                                               (1024, 7168, False), (7, 333, False),
                                               (256, 5120, True)])
def test_cuda_gated_rmsnorm_matches_plain_version(cuda_device, rows, D, misaligned, dtype,
                                                  tol):
    """The gated forward ``rmsnorm(x * silu(z))`` against
    ``gated_rmsnorm_reference`` at the Mamba2 gate norm's widths (mamba2 5120,
    zamba2 7168; prefill and decode rows), an odd width and a misaligned
    gate; it counts on ``launches`` and ``gated_launches``."""
    g = torch.Generator(device=cuda_device).manual_seed(rows + D)
    x = (2.0 * torch.randn((rows, D), generator=g, device=cuda_device)).to(dtype)
    z = (2.0 * torch.randn((rows, D), generator=g, device=cuda_device)).to(dtype)
    s = (1 + 0.3 * torch.randn((D,), generator=g, device=cuda_device)).to(dtype)
    if misaligned:
        z = _misaligned(z)
    n = (rms_ops.rmsnorm.launches, rms_ops.rmsnorm.gated_launches)
    out = rms_ops.rmsnorm(x, s, 1e-5, gate=z)
    assert (rms_ops.rmsnorm.launches, rms_ops.rmsnorm.gated_launches) == (n[0] + 1, n[1] + 1)
    ref = rms_ops.gated_rmsnorm_reference(x, z, s, 1e-5)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


RMS_BWD_CASES = [  # rows, D, x dtype, scale dtype, misaligned
    (8192, 2048, torch.bfloat16, torch.float32, False),     # the training shape
    (2048, 2048, torch.float32, torch.float32, False),
    (4096, 3584, torch.bfloat16, torch.float32, False),
    (20000, 128, torch.bfloat16, torch.float32, False),     # qk-norm rows
    (300, 333, torch.float32, torch.float32, False),        # odd width: scalar
    (1000, 2048, torch.bfloat16, torch.float32, True),      # scalar two-pass
    (64, 6000, torch.float32, torch.float32, False),        # vector two-pass
    (512, 2048, torch.bfloat16, torch.bfloat16, False),
]


@pytest.mark.parametrize("rows,D,dtype,sdtype,misaligned", RMS_BWD_CASES)
def test_cuda_rmsnorm_backward_matches_plain_version(cuda_device, rows, D, dtype, sdtype,
                                                     misaligned):
    """The backward kernel against ``rmsnorm_backward_reference`` on the same
    inputs: dx at the forward's tolerances (fp32 1e-5, bf16 2e-2) of its
    scale; an fp32 dscale within 1e-4 of its scale (a bf16 one 2e-2); dscale
    bitwise equal over two calls (no atomics); one count per call."""
    g = torch.Generator(device=cuda_device).manual_seed(rows * 7 + D)
    x = (3.0 * torch.randn((rows, D), generator=g, device=cuda_device)).to(dtype)
    s = (1 + 0.3 * torch.randn((D,), generator=g, device=cuda_device)).to(sdtype)
    gy = torch.randn((rows, D), generator=g, device=cuda_device).to(dtype)
    if misaligned:
        x, gy = _misaligned(x), _misaligned(gy)
    n = rms_ops.rmsnorm.backward_launches
    dx, ds = rms_ops.rmsnorm_backward(x, s, gy, 1e-5)
    dx2, ds2 = rms_ops.rmsnorm_backward(x, s, gy, 1e-5)
    assert rms_ops.rmsnorm.backward_launches == n + 2
    assert dx.dtype == dtype and ds.dtype == sdtype
    rdx, rds = rms_ops.rmsnorm_backward_reference(x, s, gy, 1e-5)
    dx_tol = 1e-5 if dtype == torch.float32 else 2e-2
    ds_tol = 1e-4 if sdtype == torch.float32 else 2e-2
    err_dx = float((dx.float() - rdx.float()).abs().max())
    err_ds = float((ds.float() - rds.float()).abs().max())
    assert err_dx <= dx_tol * max(1.0, float(rdx.float().abs().max())), err_dx
    assert err_ds <= ds_tol * float(rds.float().abs().max()), err_ds
    assert torch.equal(ds, ds2) and torch.equal(dx, dx2)


def test_cuda_rmsnorm_autograd_runs_the_backward_kernel(cuda_device):
    """Under autograd the forward launches K2 once and the backward runs the
    backward kernel once; the plain version launches neither."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    x = torch.randn((64, 2048), generator=g, device=cuda_device).bfloat16().requires_grad_()
    s = torch.ones(2048, device=cuda_device, requires_grad=True)
    n = (rms_ops.rmsnorm.launches, rms_ops.rmsnorm.backward_launches)
    y = rms_ops.rmsnorm_autograd(x, s, 1e-5)
    torch.autograd.grad(y, (x, s), torch.ones_like(y))
    assert (rms_ops.rmsnorm.launches, rms_ops.rmsnorm.backward_launches) == (n[0] + 1, n[1] + 1)
    y = rms_ops.rmsnorm_reference(x, s, 1e-5)
    torch.autograd.grad(y, (x, s), torch.ones_like(y))
    assert (rms_ops.rmsnorm.launches, rms_ops.rmsnorm.backward_launches) == (n[0] + 1, n[1] + 1)


def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.randn((1, 4, 2, 64), device=cuda_device)
    with pytest.raises(TypeError):
        flash_ops.flash_attention_fwd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):                     # head_dim 48 is not taken
        flash_ops.flash_attention_fwd(q[..., :48].contiguous(), q[..., :48].contiguous(),
                                      q[..., :48].contiguous())
    with pytest.raises(ValueError):                     # not contiguous
        t = q.transpose(1, 2)
        flash_ops.flash_attention_fwd(t, t, t)
    with pytest.raises(ValueError):                     # positions of the wrong dtype
        pos = torch.arange(4, device=cuda_device)
        flash_ops.flash_attention_fwd(q, q, q, q_pos=pos, k_pos=pos)
    with pytest.raises(ValueError):                     # mixed devices
        flash_ops.flash_attention_fwd(q, q.cpu(), q)
    with pytest.raises(ValueError):                     # H % KV != 0: 6 query heads, 4 kv
        q6 = torch.randn((1, 4, 6, 64), device=cuda_device)
        kv4 = torch.randn((1, 4, 4, 64), device=cuda_device)
        flash_ops.flash_attention_fwd(q6, kv4, kv4)
    with pytest.raises(ValueError):
        rms_ops.rmsnorm(torch.randn((2, 64), device=cuda_device), torch.ones(32, device=cuda_device))


INT32_MAX = 2**31 - 1


def _kv_len_positions(off, kv_len, Sq, Sk, dev):
    """The dispatch's decode positions: q_pos = off + arange(Sq), k_pos =
    arange(Sk) with keys at or past kv_len moved to INT32_MAX."""
    q_pos = (off.reshape(-1, 1) + torch.arange(Sq, device=dev)).to(torch.int32).contiguous()
    ar = torch.arange(Sk, device=dev)
    k_pos = torch.where(ar[None] < kv_len[:, None], ar[None],
                        torch.full((), INT32_MAX, device=dev)).to(torch.int32).contiguous()
    return q_pos, k_pos


@pytest.mark.parametrize("case", [
    # (B, Sq, Sk, H, KV, hd, kind, kv_lens)
    (8, 1, 1025, 32, 8, 64, "decode", None),          # llama decode, GQA g = 4
    (1, 256, 1280, 32, 8, 64, "chunk", (768,)),       # llama prefill chunk, g = 4
    (2, 1, 300, 40, 8, 128, "decode", None),          # g = 5, hd 128
    (2, 37, 100, 40, 8, 128, "causal", None),         # g = 5, index mask, Sk % 64 != 0
    (2, 50, 77, 4, 4, 112, "causal", None),           # hd 112, H = KV
    (1, 3, 200, 4, 4, 112, "noncausal", None),        # hd 112, non-causal
    (4, 1, 130, 32, 8, 64, "decode", (1, 63, 64, 65)),    # kv_len 1 and a tile edge +-1
    (3, 1, 200, 32, 8, 64, "decode", (127, 128, 129)),
    (1, 1, 8192, 32, 8, 64, "decode", (8192,)),       # long decode: many key splits
    (1, 1, 8192, 32, 8, 64, "decode", (5000,)),
    (2, 16, 90, 8, 2, 32, "masked", None),            # fully masked rows
    (2, 1, 300, 8, 2, 64, "decode", (0, 150)),        # kv_len 0: a fully masked decode row
    # zamba2-7b's shared attention (hd 112, one query head per KV head): a
    # decode step with kv_len at and around the 2048-key tile edge, a prefill
    (4, 1, 2080, 32, 32, 112, "decode", (2048, 2049, 2079, 2080)),
    (4, 2048, 2048, 32, 32, 112, "causal", None),
    # moonshot-v1-16b-a3b (hd 128, one query head per KV head): its decode
    # step over 2080 keys and its causal prefill
    (4, 1, 2080, 16, 16, 128, "decode", (2048, 2049, 2079, 2080)),
    (4, 2048, 2048, 16, 16, 128, "causal", None),
    # internvl2-26b (48 query heads over 8 KV heads, g = 6, hd 128): its
    # prefill of 256 prefix + 1 024 text positions and a decode step over
    # its 1 344-row cache
    (2, 1280, 1280, 48, 8, 128, "causal", None),
    (8, 1, 1344, 48, 8, 128, "decode", (1281, 1300, 1343, 1344, 1282, 1290, 1310, 1330)),
], ids=lambda c: f"B{c[0]}-Sq{c[1]}-Sk{c[2]}-H{c[3]}-KV{c[4]}-hd{c[5]}-{c[6]}")
def test_cuda_flash_compact_heads_match_plain_version(cuda_device, case):
    """K1 on compact GQA K/V against its plain version (which expands the
    heads): fp32 1e-4, bf16 3e-2, residuals 1e-5; one launch counted per
    call, including calls that split keys and merge in a second kernel."""
    _check_flash_case(cuda_device, case)


@pytest.mark.parametrize("case", [
    # (B, Sq, Sk, H, KV, hd, kind, kv_lens): 64-row blocks, keys split
    (1, 64, 20000, 32, 8, 64, "causal", None),        # index mask: late splits see no key
    (1, 256, 20000, 32, 8, 64, "causal", None),
    (1, 256, 20000, 32, 8, 64, "chunk", (20000,)),    # q offset 19744: rows see ~all keys
    (1, 64, 20000, 32, 8, 64, "noncausal", None),
], ids=lambda c: f"B{c[0]}-Sq{c[1]}-Sk{c[2]}-{c[6]}")
def test_cuda_flash_many_row_split_path_matches_plain_version(cuda_device, case):
    """Past 256 key tiles (16 384 keys) K1 splits the keys of blocks of
    more than 16 packed rows too, and merges the splits in a second kernel:
    that path against the plain version at the same tolerances."""
    B, Sq, Sk, H, KV = case[:5]
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert (H // KV) * Sq > flash_ops.DECODE_ROWS
    assert flash_ops.num_splits(B, KV, (H // KV) * Sq, Sk, sms) > 1
    _check_flash_case(cuda_device, case)


def _check_flash_case(dev, case):
    B, Sq, Sk, H, KV, hd, kind, lens = case
    g = torch.Generator(device=dev).manual_seed(Sk + H + hd)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dtype)
        k, v = (torch.randn((B, Sk, KV, hd), generator=g, device=dev).to(dtype)
                for _ in range(2))
        kw = dict(causal=kind != "noncausal")
        if kind in ("decode", "chunk"):
            kv_len = (torch.tensor(lens, device=dev) if lens is not None
                      else torch.randint(1, Sk + 1, (B,), generator=g, device=dev))
            kw["q_pos"], kw["k_pos"] = _kv_len_positions(kv_len - Sq, kv_len, Sq, Sk, dev)
        elif kind == "masked":          # rows 0..4 of each batch see no key
            kw["q_pos"] = torch.arange(Sq, dtype=torch.int32, device=dev)
            kw["k_pos"] = (torch.arange(Sk, dtype=torch.int32, device=dev) + 5).contiguous()
        n = flash_ops.flash_attention_fwd.launches
        out, m, l = flash_ops.flash_attention_fwd(q, k, v, return_residuals=True, **kw)
        torch.cuda.synchronize()
        assert flash_ops.flash_attention_fwd.launches == n + 1
        ref, rm, rl = flash_ref.flash_attention_fwd(q, k, v, return_residuals=True, **kw)
        assert out.dtype == dtype and out.shape == q.shape
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
        # per (b, s, h) row against the fp32 plain version, relative to the
        # row's largest |value| (rows over many keys hold values ~1e-2):
        # 1e-4 in fp32, 2 bf16 epsilons in bf16
        ref32 = ref.float() if dtype == torch.float32 else flash_ref.flash_attention_fwd(
            q.float(), k.float(), v.float(), **kw)
        row_err = (out.float() - ref32).abs().amax(-1) / ref32.abs().amax(-1).clamp_min(1e-30)
        assert float(row_err.max()) <= (1e-4 if dtype == torch.float32 else 2.0 ** -6)
        torch.testing.assert_close(m, rm, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(l, rl, atol=1e-5, rtol=1e-5)
        if kind == "masked":            # a fully masked row is the mean of v
            mean = flash_ref.expand_heads(k, v, H)[1].float().mean(dim=1)
            torch.testing.assert_close(out[:, 0].float(), mean, atol=tol, rtol=tol)


@pytest.mark.parametrize("S,H,KV,dtype", [
    (1024, 32, 8, torch.float32),
    (20000, 2, 1, torch.float32),      # the many-row split path
    (1024, 32, 8, torch.bfloat16),
])
def test_cuda_flash_attention_autograd_matches_plain_version(cuda_device, S, H, KV, dtype):
    """``flash_attention`` (K1 forward, block-by-block recompute backward)
    against autograd through K1's plain version: out and dq/dk/dv within
    2e-3 of their scale in fp32, 3e-2 in bf16; one K1 launch per call."""
    g = torch.Generator(device=cuda_device).manual_seed(S + H)
    q, k, v = (torch.randn((1, S, n, 64), generator=g, device=cuda_device).to(dtype)
               for n in (H, KV, KV))
    cot = torch.randn((1, S, H, 64), generator=g, device=cuda_device).to(dtype)
    tol = 2e-3 if dtype == torch.float32 else 3e-2
    results = []
    for fn in (flash_ops.flash_attention, flash_ref.flash_attention_fwd):
        tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
        n = flash_ops.flash_attention_fwd.launches
        out = fn(tq, tk, tv, causal=True)
        results.append((out, *torch.autograd.grad(out, (tq, tk, tv), cot)))
        assert flash_ops.flash_attention_fwd.launches == n + (fn is flash_ops.flash_attention)
    for a, b in zip(*results):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape
        a, b = a.detach().float(), b.detach().float()
        err = float((a - b).abs().max())
        assert err <= tol * float(b.abs().max()), err


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_cuda_rmsnorm_autograd_matches_plain_version(cuda_device, dtype, tol):
    """K2 forward with the recomputing backward against autograd through
    the plain version: y, dx (x's dtype) and dscale (fp32)."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    x = (3 * torch.randn((512, 2048), generator=g, device=cuda_device)).to(dtype)
    scale = 1 + 0.1 * torch.randn((2048,), generator=g, device=cuda_device)
    cot = torch.randn((512, 2048), generator=g, device=cuda_device).to(dtype)
    results = []
    for fn in (rms_ops.rmsnorm_autograd, rms_ops.rmsnorm_reference):
        tx, ts = x.clone().requires_grad_(), scale.clone().requires_grad_()
        n = rms_ops.rmsnorm.launches
        y = fn(tx, ts, 1e-5)
        results.append((y, *torch.autograd.grad(y, (tx, ts), cot)))
        assert rms_ops.rmsnorm.launches == n + (fn is rms_ops.rmsnorm_autograd)
    for a, b in zip(*results):
        assert a.dtype == b.dtype
        a, b = a.detach().float(), b.detach().float()
        err = float((a - b).abs().max())
        assert err <= tol * max(1.0, float(b.abs().max())), err


@pytest.mark.parametrize("policy", ["none", "selective", "full"])
def test_cuda_train_kernel_path_matches_ref_path(cuda_device, policy):
    """Reduced llama3.2-1b on the card under each remat policy: the kernel
    path's fp32 loss and grads are the plain path's (grads within 2e-3 of
    each leaf's scale); K1 launches once per layer and K2 2L + 1 times per
    forward, and a recomputing policy relaunches both in the backward; a bf16
    train step with grad accumulation runs and gives finite numbers."""
    from repro_torch.core.strategy import LayerStrategy, uniform_plan
    from repro_torch.runtime import train as ttrain
    from repro_torch.runtime.data import SyntheticDataset
    from repro_torch.models.common import tree_leaves as leaves

    cfg = get_config("llama3.2-1b").reduced()
    L = cfg.num_layers
    plan = uniform_plan(cfg.name, "train_4k", (1,), ("data",), L,
                        LayerStrategy(remat=policy), grad_accum=2)
    params = build_model(cfg, device=cuda_device).init(
        torch.Generator(device=cuda_device).manual_seed(8))
    batch = SyntheticDataset(cfg, 256, 4, seed=8).batch(0)
    out = {}
    for impl in ("kernel", "ref"):
        hp = ttrain.construct_hybrid_parallel_model(build_model(cfg, impl=impl), plan)
        counts = (flash_ops.flash_attention_fwd.launches, rms_ops.rmsnorm.launches)
        out[impl] = hp.value_and_grad(params, batch, torch.float32)
        torch.cuda.synchronize()
        launched = (flash_ops.flash_attention_fwd.launches - counts[0],
                    rms_ops.rmsnorm.launches - counts[1])
        if impl == "kernel":
            again = policy != "none"
            assert launched == (L * (1 + again), 2 * L + 1 + 2 * L * again), launched
        else:
            assert launched == (0, 0)
    (lk, _, gk), (lr, _, gr) = out["kernel"], out["ref"]
    assert abs(float(lk) - float(lr)) <= 1e-5 * abs(float(lr))
    for a, b in zip(leaves(gk), leaves(gr)):
        assert float((a - b).abs().max()) <= 2e-3 * float(b.abs().max())
    hp = ttrain.construct_hybrid_parallel_model(build_model(cfg), plan)
    p, s, m = hp.train_step(params, hp.init_opt_state(params), batch)
    assert all(bool(torch.isfinite(x).all()) for x in leaves(p))
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))


def test_cuda_serving_kernel_path_matches_ref_path(cuda_device):
    """Reduced llama3.2-1b served in fp32 on the card: the kernel path emits
    the plain path's greedy tokens, and both kernels ran."""
    config = serving.ServeConfig(
        arch="llama3.2-1b", reduced=True, device="cuda",
        cache=serving.CacheConfig(max_context=48, page_size=8),
        scheduler=serving.SchedulerConfig(num_slots=2, prefill_chunk=8))
    cfg = config.model_config()
    params = build_model(cfg, device=cuda_device).init(
        torch.Generator(device=cuda_device).manual_seed(5))
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 19), dtype=np.int32)
    tokens = {}
    counts = (flash_ops.flash_attention_fwd.launches, rms_ops.rmsnorm.launches)
    for impl in ("kernel", "ref"):
        s = serving.build(config, model=build_model(cfg, impl=impl, device=cuda_device),
                          params=params, dtype=torch.float32)
        streams = [s.submit(serving.Request(prompt=p, max_new=9)) for p in prompts]
        s.run_until_drained()
        tokens[impl] = [st.request.tokens for st in streams]
        if impl == "kernel":
            after = (flash_ops.flash_attention_fwd.launches, rms_ops.rmsnorm.launches)
            assert all(a > c for a, c in zip(after, counts))
    assert tokens["kernel"] == tokens["ref"]


def _ssd_inputs(g, dev, Bs, S, H, P, G, N, dtype=torch.float32):
    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    x = rn(Bs, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(rn(Bs, S, H))
    A = -torch.exp(0.3 * rn(H))
    return x, dt, A, (0.3 * rn(Bs, S, G, N)).to(dtype), (0.3 * rn(Bs, S, G, N)).to(dtype)


@pytest.mark.parametrize("Bs,S,H,P,G,N,dtype", [
    (2, 128, 4, 32, 1, 16, torch.float32),
    (1, 256, 4, 64, 2, 32, torch.float32),
    (1, 100, 4, 64, 2, 64, torch.float32),           # ragged S: no chunk halving
    (2, 1, 8, 32, 1, 16, torch.float32),             # one position
    (1, 300, 8, 64, 1, 128, torch.bfloat16),         # ragged, bf16 x/B/C
    # the bf16 template (tensor cores)
    (2, 128, 4, 32, 1, 16, torch.bfloat16),
    (1, 256, 4, 64, 2, 32, torch.bfloat16),
    (1, 100, 4, 64, 2, 64, torch.bfloat16),          # ragged S
    (2, 1, 8, 32, 1, 16, torch.bfloat16),            # one position
    (1, 2048, 80, 64, 1, 128, torch.bfloat16),       # mamba2-2.7b heads, one row
    (4, 2048, 112, 64, 2, 64, torch.bfloat16),       # zamba2-7b prefill: 56 heads a group
    (4, 2048, 112, 64, 2, 64, torch.float32),
])
def test_cuda_ssd_matches_plain_versions(cuda_device, Bs, S, H, P, G, N, dtype):
    """K3 against ``ssd_chunked`` (and ``ssd_naive``) at 1e-3 of the plain
    version's scale, the JAX SSD tests' tolerance, for y and the final state;
    a bf16 y may also differ by one bf16 step of the element (both sides
    round an fp32 sum once)."""
    g = torch.Generator(device=cuda_device).manual_seed(S)
    x, dt, A, B, C = _ssd_inputs(g, cuda_device, Bs, S, H, P, G, N, dtype)
    n = ssd_ops.ssd.launches
    y, st = ssd_ops.ssd(x, dt, A, B, C)
    torch.cuda.synchronize()
    assert ssd_ops.ssd.launches == n + 1
    assert y.dtype == dtype and st.dtype == torch.float32 and st.shape == (Bs, H, N, P)
    plain = [ssd_ref.ssd_chunked(x, dt, A, B, C)]
    if S <= 128:
        plain.append(ssd_ref.ssd_naive(x.float(), dt, A, B.float(), C.float()))
    rtol_y = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    for ry, rs in plain:
        for a, b, rtol in ((y.float(), ry.float(), rtol_y), (st, rs, 0.0)):
            tol = 1e-3 * max(1.0, float(b.abs().max()))
            assert bool(((a - b).abs() <= tol + rtol * b.abs()).all())


def test_cuda_ssd_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x, dt, A, B, C = _ssd_inputs(g, cuda_device, 1, 64, 4, 32, 1, 16)
    with pytest.raises(ValueError):                     # the kernel starts from zero
        ssd_ops.ssd(x, dt, A, B, C, initial_state=torch.zeros((1, 4, 16, 32), device=cuda_device))
    with pytest.raises(TypeError):                      # dt must be fp32
        ssd_ops.ssd(x, dt.bfloat16(), A, B, C)
    with pytest.raises(TypeError):                      # mixed x/B dtypes
        ssd_ops.ssd(x, dt, A, B.bfloat16(), C)
    with pytest.raises(ValueError):                     # N not a multiple of 4
        ssd_ops.ssd(x, dt, A, B[..., :6].contiguous(), C[..., :6].contiguous())
    xb, _, _, Bb, Cb = _ssd_inputs(g, cuda_device, 1, 64, 4, 32, 1, 24, torch.bfloat16)
    n = ssd_ops.ssd.launches
    with pytest.raises(ValueError, match="multiples of 16"):   # bf16 N 24
        ssd_ops.ssd(xb, dt, A, Bb, Cb)
    assert ssd_ops.ssd.launches == n
    with pytest.raises(ValueError):                     # mixed devices
        ssd_ops.ssd(x, dt.cpu(), A, B, C)


def test_cuda_mamba2_step_engine_kernel_path_matches_ref_path(cuda_device):
    """Reduced mamba2 in fp32 through ``step_engine(...).greedy_generate``:
    the kernel path emits the plain path's greedy tokens; K2 and K3 ran."""
    cfg = get_config("mamba2-2.7b").reduced()
    params = build_model(cfg, device=cuda_device).init(
        torch.Generator(device=cuda_device).manual_seed(6))
    prompts = torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab_size, (3, 77))).to(cuda_device)
    tokens = {}
    counts = (ssd_ops.ssd.launches, rms_ops.rmsnorm.launches)
    for impl in ("kernel", "ref"):
        model = build_model(cfg, impl=impl, device=cuda_device)
        engine = serving.step_engine(model, serving.single_device_plan(cfg),
                                     dtype=torch.float32)
        tokens[impl] = engine.greedy_generate(params, prompts, 10, 96).tolist()
        if impl == "kernel":
            assert ssd_ops.ssd.launches == counts[0] + cfg.num_layers
            assert rms_ops.rmsnorm.launches == counts[1] + 10 * (2 * cfg.num_layers + 1)
    assert tokens["kernel"] == tokens["ref"]


def test_cuda_measure_block_times_the_block_on_the_kernels(cuda_device):
    """``measure_block`` at reduced width on the card: finite, positive
    forward and backward times, a peak above the parameters' bytes; K1 and
    K2 launched during it."""
    import math

    from repro_torch.core import profiler_model as pm

    cfg = get_config("llama3.2-1b").reduced()
    counts = (flash_ops.flash_attention_fwd.launches, rms_ops.rmsnorm.launches)
    m = pm.measure_block(cfg, 256, batch=2, iters=3)
    for t in (m.fwd_time_s, m.bwd_time_s):
        assert math.isfinite(t) and t > 0.0
    assert math.isfinite(m.remat_extra_s) and m.remat_extra_s >= 0.0
    param_bytes = 2.0 * pm.profile_model(cfg, 256).layers[0].param_count     # bf16
    assert m.peak_bytes > param_bytes
    assert flash_ops.flash_attention_fwd.launches > counts[0]
    assert rms_ops.rmsnorm.launches > counts[1]


def test_cuda_profile_cells_calibrate_a_measured_throughput(cuda_device, tmp_path):
    """``run_profile_cells`` on the card into a fresh cache, then
    ``calibrate``: a measured calibration with a positive bf16 throughput."""
    from repro_torch.core import calibrate as cal
    from repro_torch.core import profile_cache as pcache

    cfg = get_config("llama3.2-1b").reduced()
    cells = [(cfg, pcache.ProfileKey("cuda", pcache.model_key(cfg), "bf16", 1, 1, seq, 2))
             for seq in (128, 256)]
    cache = pcache.ProfileCache.load_or_create(tmp_path / "cuda.json")
    assert cal.run_profile_cells(cells, cache) == (2, 0)
    calibration = cal.calibrate(cache)
    assert calibration.source == "measured"
    assert calibration.throughput["bf16"] > 0.0


def test_cuda_hybrid_step_engine_kernel_path_matches_ref_path(cuda_device):
    """A reduced zamba2 with a trailing Mamba layer (7 layers: 3 sites of
    the shared attention block, then 1) in fp32 through
    ``step_engine(...).greedy_generate``: the kernel path emits the plain
    path's greedy tokens, with K3 once per layer, K1 once per site and
    forward, K2 twice per layer and site plus once per forward."""
    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(), num_layers=7)
    params = build_model(cfg, device=cuda_device).init(
        torch.Generator(device=cuda_device).manual_seed(9))
    prompts = torch.from_numpy(
        np.random.default_rng(9).integers(0, cfg.vocab_size, (3, 77))).to(cuda_device)
    tokens = {}
    counts = (ssd_ops.ssd.launches, flash_ops.flash_attention_fwd.launches,
              rms_ops.rmsnorm.launches)
    for impl in ("kernel", "ref"):
        model = build_model(cfg, impl=impl, device=cuda_device)
        engine = serving.step_engine(model, serving.single_device_plan(cfg),
                                     dtype=torch.float32)
        tokens[impl] = engine.greedy_generate(params, prompts, 10, 96).tolist()
        if impl == "kernel":
            assert model.n_apps == 3 and model.remainder == 1
            assert ssd_ops.ssd.launches == counts[0] + cfg.num_layers
            assert flash_ops.flash_attention_fwd.launches == counts[1] + 10 * model.n_apps
            assert rms_ops.rmsnorm.launches == \
                counts[2] + 10 * (2 * cfg.num_layers + 2 * model.n_apps + 1)
    assert tokens["kernel"] == tokens["ref"]


def _moe_cfg():
    """Reduced moonshot with 8 experts at capacity factor 0.5: the capacity
    floor of 8 slots drops choices in a prefill or a microbatch."""
    return dataclasses.replace(get_config("moonshot-v1-16b-a3b").reduced(), num_experts=8,
                               moe_capacity_factor=0.5)


def test_cuda_moe_prefill_and_decode_kernel_path_match_ref_path(cuda_device):
    """The reduced MoE model in fp32 on the card: prefill logits and K/V and
    two decode steps (a per-row cache_index) of the kernel path within 1e-4
    of the plain path's; K1 once per layer and K2 2L + 1 times per forward."""
    cfg = _moe_cfg()
    L = cfg.num_layers
    params = build_model(cfg, device=cuda_device).init(
        torch.Generator(device=cuda_device).manual_seed(10))
    prompts = torch.from_numpy(
        np.random.default_rng(10).integers(0, cfg.vocab_size, (3, 61))).to(cuda_device)
    out = {}
    for impl in ("kernel", "ref"):
        model = build_model(cfg, impl=impl, device=cuda_device)
        counts = (flash_ops.flash_attention_fwd.launches, rms_ops.rmsnorm.launches)
        logits, cache = model.forward_prefill(params, prompts, max_len=72,
                                              dtype=torch.float32)
        steps = [logits]
        tok = logits[:, -1].argmax(-1, keepdim=True)
        for i in range(2):
            ci = torch.tensor([61 + i, 60 + i, 59 + i], device=cuda_device)
            logits, cache = model.forward_decode(params, tok, cache, ci, kv_len=ci + 1,
                                                 dtype=torch.float32)
            steps.append(logits)
        torch.cuda.synchronize()
        launched = (flash_ops.flash_attention_fwd.launches - counts[0],
                    rms_ops.rmsnorm.launches - counts[1])
        assert launched == ((3 * L, 3 * (2 * L + 1)) if impl == "kernel" else (0, 0))
        out[impl] = steps + [cache["k"], cache["v"]]
    for a, b in zip(out["kernel"], out["ref"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_cuda_moe_step_engine_kernel_path_matches_ref_path(cuda_device):
    """The reduced MoE model in fp32 through ``step_engine(...)
    .greedy_generate``: the kernel path emits the plain path's greedy
    tokens, with K1 L and K2 2L + 1 launches per forward."""
    cfg = _moe_cfg()
    params = build_model(cfg, device=cuda_device).init(
        torch.Generator(device=cuda_device).manual_seed(11))
    prompts = torch.from_numpy(
        np.random.default_rng(11).integers(0, cfg.vocab_size, (4, 77))).to(cuda_device)
    tokens = {}
    counts = (flash_ops.flash_attention_fwd.launches, rms_ops.rmsnorm.launches)
    for impl in ("kernel", "ref"):
        engine = serving.step_engine(build_model(cfg, impl=impl, device=cuda_device),
                                     serving.single_device_plan(cfg), dtype=torch.float32)
        tokens[impl] = engine.greedy_generate(params, prompts, 10, 96).tolist()
        if impl == "kernel":
            assert flash_ops.flash_attention_fwd.launches == counts[0] + 10 * cfg.num_layers
            assert rms_ops.rmsnorm.launches == counts[1] + 10 * (2 * cfg.num_layers + 1)
    assert tokens["kernel"] == tokens["ref"]


def test_cuda_moe_train_kernel_path_matches_ref_path(cuda_device):
    """The reduced MoE model's training on the card under ``selective``: the
    kernel path's fp32 loss, aux and grads are the plain path's (grads
    within 2e-3 of each leaf's scale, the router's included); K1 2L, K2
    4L + 1 and K2's backward 2L + 1 launches per microbatch; a bf16 step with
    grad accumulation gives a finite loss and a positive aux."""
    from repro_torch.core.strategy import LayerStrategy, uniform_plan
    from repro_torch.models.common import tree_leaves as leaves
    from repro_torch.runtime import train as ttrain
    from repro_torch.runtime.data import SyntheticDataset

    cfg = _moe_cfg()
    L = cfg.num_layers
    plan = uniform_plan(cfg.name, "train_4k", (1,), ("data",), L,
                        LayerStrategy(remat="selective"), grad_accum=2)
    params = build_model(cfg, device=cuda_device).init(
        torch.Generator(device=cuda_device).manual_seed(12))
    batch = SyntheticDataset(cfg, 256, 4, seed=12).batch(0)
    out = {}
    for impl in ("kernel", "ref"):
        hp = ttrain.construct_hybrid_parallel_model(build_model(cfg, impl=impl), plan)
        counts = (flash_ops.flash_attention_fwd.launches, rms_ops.rmsnorm.launches,
                  rms_ops.rmsnorm.backward_launches)
        out[impl] = hp.value_and_grad(params, batch, torch.float32)
        torch.cuda.synchronize()
        launched = (flash_ops.flash_attention_fwd.launches - counts[0],
                    rms_ops.rmsnorm.launches - counts[1],
                    rms_ops.rmsnorm.backward_launches - counts[2])
        assert launched == ((2 * L, 4 * L + 1, 2 * L + 1) if impl == "kernel" else (0, 0, 0))
    (lk, mk, gk), (lr, mr, gr) = out["kernel"], out["ref"]
    assert abs(float(lk) - float(lr)) <= 1e-5 * abs(float(lr))
    assert abs(float(mk["aux"]) - float(mr["aux"])) <= 1e-5 * abs(float(mr["aux"]))
    for a, b in zip(leaves(gk), leaves(gr)):
        assert float((a - b).abs().max()) <= 2e-3 * float(b.abs().max())
    hp = ttrain.construct_hybrid_parallel_model(build_model(cfg), plan)
    p, _, m = hp.train_step(params, hp.init_opt_state(params), batch)
    assert all(bool(torch.isfinite(x).all()) for x in leaves(p))
    assert np.isfinite(float(m["loss"])) and float(m["aux"]) > 0.0


def test_cuda_init_draws_a_leaf_of_one_piece_as_a_whole_draw(cuda_device, monkeypatch):
    """On the card too, a leaf that fits one piece keeps, bit for bit, the
    values of a whole draw of its shape; a leaf in pieces draws the same
    values for the same seed twice."""
    from repro_torch.models import common

    d = common.ParamDef((16, 2048, 96), ("layers", "embed", "ff"))
    whole = torch.randn(d.shape, generator=torch.Generator(device=cuda_device).manual_seed(5),
                        device=cuda_device, dtype=torch.float32).mul_(d.std())
    for dtype in (torch.float32, torch.bfloat16):
        x = d.materialize(torch.Generator(device=cuda_device).manual_seed(5), cuda_device, dtype)
        assert x.dtype == dtype and torch.equal(x, whole.to(dtype)), dtype
    monkeypatch.setattr(common, "DRAW_ELEMENTS", 1 << 20)      # 3 145 728 elements: 3 pieces
    a, b = (d.materialize(torch.Generator(device=cuda_device).manual_seed(5), cuda_device,
                          torch.bfloat16) for _ in range(2))
    assert torch.equal(a, b) and abs(float(a.float().std()) - d.std()) < 0.01 * d.std()


# ------------------------------------------------------------------ whisper (audio)

@pytest.mark.parametrize("case", [
    # (B, Sq, Sk, H, KV, hd, kind, kv_lens) at whisper-tiny's heads (H = KV 6, hd 64)
    (2, 300, 300, 6, 6, 64, "noncausal", None),       # encoder self, 4 tiles + a ragged 44
    (4, 4, 1500, 6, 6, 64, "noncausal", None),        # cross prefill, Sq != Sk
    (2, 96, 1500, 6, 6, 64, "noncausal", None),       # cross training shape, reduced
    (4, 1, 1500, 6, 6, 64, "noncausal", None),        # cross decode: split-K, no positions
    (4, 1, 448, 6, 6, 64, "decode", (5, 64, 65, 228)),    # self decode, per-slot kv_len
], ids=lambda c: f"B{c[0]}-Sq{c[1]}-Sk{c[2]}-{c[6]}")
def test_cuda_flash_at_whisper_shapes_matches_plain_version(cuda_device, case):
    """K1 on the encoder-decoder's paths against its plain version, at the
    tolerances of the other K1 cases."""
    _check_flash_case(cuda_device, case)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_autograd_non_causal_cross(cuda_device, dtype):
    """``flash_attention(..., causal=False)`` with Sq 96 != Sk 1500 (the
    cross-attention under autograd) against autograd through K1's plain
    version: 2e-3 of scale in fp32, 3e-2 in bf16; one launch a call."""
    g = torch.Generator(device=cuda_device).manual_seed(96)
    q = torch.randn((2, 96, 6, 64), generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn((2, 1500, 6, 64), generator=g, device=cuda_device).to(dtype)
            for _ in range(2))
    cot = torch.randn(q.shape, generator=g, device=cuda_device).to(dtype)
    tol = 2e-3 if dtype == torch.float32 else 3e-2
    results = []
    for fn in (flash_ops.flash_attention, flash_ref.flash_attention_fwd):
        tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
        n = flash_ops.flash_attention_fwd.launches
        out = fn(tq, tk, tv, causal=False)
        results.append((out, *torch.autograd.grad(out, (tq, tk, tv), cot)))
        assert flash_ops.flash_attention_fwd.launches == n + (fn is flash_ops.flash_attention)
    for a, b in zip(*results):
        a, b = a.detach().float(), b.detach().float()
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def _whisper_cfg():
    """Reduced whisper-tiny with 100 frames (not a multiple of 64)."""
    return dataclasses.replace(get_config("whisper-tiny").reduced(), enc_frames=100)


def _whisper_greedy(model, params, prompts, frames, max_new):
    """``prefill_step(params, tokens, {"frames": f})`` then ``decode_step``
    per token, in fp32 (the engine's calls for real frames)."""
    cfg = model.cfg
    S = prompts.shape[1]
    engine = serving.step_engine(model, serving.single_device_plan(cfg),
                                 max_len=S + max_new, dtype=torch.float32)
    logits, cache = engine.prefill_step(params, prompts, {"frames": frames})
    out = [logits[:, -1].argmax(-1)]
    for i in range(max_new - 1):
        logits, cache = engine.decode_step(params, out[-1][:, None], cache, S + i)
        out.append(logits[:, -1].argmax(-1))
    return torch.stack(out, dim=1).tolist()


def test_cuda_whisper_kernel_path_matches_ref_path(cuda_device):
    """The reduced whisper in fp32 on the card with non-zero frames: the
    kernel path's greedy tokens are the plain path's, with K1 E + 2L and K2
    (2E + 1) + (3L + 1) launches a prefill and K1 2L, K2 3L + 1 a decode
    step; ``greedy_generate`` (zero frames, as in JAX) agrees too."""
    cfg = _whisper_cfg()
    E, L = cfg.enc_layers, cfg.num_layers
    params = build_model(cfg, device=cuda_device).init(
        torch.Generator(device=cuda_device).manual_seed(13))
    g = torch.Generator(device=cuda_device).manual_seed(14)
    frames = torch.randn((3, cfg.enc_frames, cfg.d_model), generator=g, device=cuda_device)
    prompts = torch.from_numpy(
        np.random.default_rng(13).integers(0, cfg.vocab_size, (3, 5))).to(cuda_device)
    tokens, plain = {}, {}
    for impl in ("kernel", "ref"):
        model = build_model(cfg, impl=impl, device=cuda_device)
        counts = (flash_ops.flash_attention_fwd.launches, rms_ops.rmsnorm.launches)
        tokens[impl] = _whisper_greedy(model, params, prompts, frames, 12)
        launched = (flash_ops.flash_attention_fwd.launches - counts[0],
                    rms_ops.rmsnorm.launches - counts[1])
        if impl == "kernel":
            assert launched == (E + 2 * L + 11 * 2 * L, 2 * E + 1 + 3 * L + 1 + 11 * (3 * L + 1))
        else:
            assert launched == (0, 0)
        engine = serving.step_engine(model, serving.single_device_plan(cfg),
                                     dtype=torch.float32)
        plain[impl] = engine.greedy_generate(params, prompts, 8, 13).tolist()
    assert tokens["kernel"] == tokens["ref"]
    assert plain["kernel"] == plain["ref"]


def test_cuda_whisper_train_kernel_path_matches_ref_path(cuda_device):
    """The reduced whisper's fp32 loss and grads on the card, kernel path
    against plain path (grads within 2e-3 of each leaf's scale); K1 E + 2L,
    K2 2E + 3L + 2 and K2's backward as many launches per microbatch."""
    from repro_torch.core.strategy import LayerStrategy, uniform_plan
    from repro_torch.models.common import tree_leaves as leaves
    from repro_torch.runtime import train as ttrain
    from repro_torch.runtime.data import SyntheticDataset

    cfg = _whisper_cfg()
    E, L = cfg.enc_layers, cfg.num_layers
    plan = uniform_plan(cfg.name, "train_4k", (1,), ("data",), L, LayerStrategy(),
                        grad_accum=2)
    params = build_model(cfg, device=cuda_device).init(
        torch.Generator(device=cuda_device).manual_seed(15))
    batch = SyntheticDataset(cfg, 64, 4, seed=15).batch(0)
    out = {}
    for impl in ("kernel", "ref"):
        hp = ttrain.construct_hybrid_parallel_model(build_model(cfg, impl=impl), plan)
        counts = (flash_ops.flash_attention_fwd.launches, rms_ops.rmsnorm.launches,
                  rms_ops.rmsnorm.backward_launches)
        out[impl] = hp.value_and_grad(params, batch, torch.float32)
        torch.cuda.synchronize()
        launched = (flash_ops.flash_attention_fwd.launches - counts[0],
                    rms_ops.rmsnorm.launches - counts[1],
                    rms_ops.rmsnorm.backward_launches - counts[2])
        norms = 2 * E + 3 * L + 2
        assert launched == ((E + 2 * L, norms, norms) if impl == "kernel" else (0, 0, 0))
    (lk, _, gk), (lr, _, gr) = out["kernel"], out["ref"]
    assert abs(float(lk) - float(lr)) <= 1e-5 * abs(float(lr))
    for a, b in zip(leaves(gk), leaves(gr)):
        assert float((a - b).abs().max()) <= 2e-3 * float(b.abs().max())
    hp = ttrain.construct_hybrid_parallel_model(build_model(cfg), plan)
    p, _, m = hp.train_step(params, hp.init_opt_state(params), batch)
    assert all(bool(torch.isfinite(x).all()) for x in leaves(p))
    assert np.isfinite(float(m["loss"]))


# ------------------------------------------------------------------ VLM, SSM and hybrid training

def _train_pair(cfg, policy, seed, seq, extra=None):
    """The reduced model's fp32 loss and grads on one batch, kernel path and
    plain path, with each path's launches (K1, K2, K2 backward, K3, K3 under
    autograd)."""
    from repro_torch.core.strategy import LayerStrategy, uniform_plan
    from repro_torch.runtime import train as ttrain
    from repro_torch.runtime.data import SyntheticDataset

    plan = uniform_plan(cfg.name, "train_4k", (1,), ("data",), cfg.num_layers,
                        LayerStrategy(remat=policy), grad_accum=2)
    params = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(seed))
    batch = SyntheticDataset(cfg, seq, 4, seed=seed).batch(0)
    batch.update(extra or {})
    out, launched = {}, {}
    counters = lambda: (flash_ops.flash_attention_fwd.launches, rms_ops.rmsnorm.launches,
                        rms_ops.rmsnorm.backward_launches, ssd_ops.ssd.launches,
                        ssd_ops.ssd_autograd.launches)
    for impl in ("kernel", "ref"):
        hp = ttrain.construct_hybrid_parallel_model(build_model(cfg, impl=impl), plan)
        before = counters()
        out[impl] = hp.value_and_grad(params, batch, torch.float32)
        torch.cuda.synchronize()
        launched[impl] = tuple(a - b for a, b in zip(counters(), before))
    hp = ttrain.construct_hybrid_parallel_model(build_model(cfg), plan)
    step = hp.train_step(params, hp.init_opt_state(params), batch, donate=True)
    return out, launched, step


def _assert_same_grads(out):
    from repro_torch.models.common import tree_leaves as leaves

    (lk, _, gk), (lr, _, gr) = out["kernel"], out["ref"]
    assert abs(float(lk) - float(lr)) <= 1e-5 * abs(float(lr))
    for a, b in zip(leaves(gk), leaves(gr)):
        assert float((a - b).abs().max()) <= 2e-3 * float(b.abs().max())


@pytest.mark.parametrize("Bs,S,H,P,G,N", [
    (2, 2048, 80, 64, 1, 128),         # mamba2-2.7b's training microbatch
    (2, 2048, 112, 64, 2, 64),         # zamba2-7b's
    (1, 1000, 80, 64, 1, 128),         # ragged S
])
def test_cuda_ssd_autograd_matches_autograd_through_the_plain_version(cuda_device, Bs, S, H,
                                                                       P, G, N):
    """``ssd_autograd`` (K3 forward, fp32 recompute backward) against
    ``torch.autograd.grad`` through ``ssd_chunked``: y and dx, ddt, dA, dB,
    dC within 1e-3 · max(1, max |plain|) on fp32 inputs; on bf16 x/B/C each
    no further from the fp32 plain grads than twice the plain bf16 route's,
    in the inputs' dtypes; one launch counted on ``ssd`` and on
    ``ssd_autograd`` per forward."""
    g = torch.Generator(device=cuda_device).manual_seed(S + H)
    x, dt, A, B, C = _ssd_inputs(g, cuda_device, Bs, S, H, P, G, N)
    dy = torch.randn((Bs, S, H, P), generator=g, device=cuda_device)

    def run(fn, dtype):
        ins = [t.detach().to(dtype if i in (0, 3, 4) else torch.float32).requires_grad_()
               for i, t in enumerate((x, dt, A, B, C))]
        y, _ = fn(*ins)
        grads = torch.autograd.grad(y, ins, dy.to(y.dtype))
        return [y.detach()] + list(grads), ins

    n = (ssd_ops.ssd.launches, ssd_ops.ssd_autograd.launches)
    (k32, _), (r32, _) = run(ssd_ops.ssd_autograd, torch.float32), run(ssd_ref.ssd_chunked,
                                                                       torch.float32)
    (kbf, ins), (rbf, _) = run(ssd_ops.ssd_autograd, torch.bfloat16), run(ssd_ref.ssd_chunked,
                                                                          torch.bfloat16)
    torch.cuda.synchronize()
    assert (ssd_ops.ssd.launches - n[0], ssd_ops.ssd_autograd.launches - n[1]) == (2, 2)
    for i, (a, b, kb, rb) in enumerate(zip(k32, r32, kbf, rbf)):
        assert float((a - b).abs().max()) <= 1e-3 * max(1.0, float(b.abs().max())), i
        err_k = float((kb.float() - b).abs().max())
        assert err_k <= 2.0 * float((rb.float() - b).abs().max()), i
    assert [t.dtype for t in kbf[1:]] == [t.dtype for t in ins]


@pytest.mark.parametrize("policy", ["none", "selective", "full"])
def test_cuda_mamba2_train_kernel_path_matches_ref_path(cuda_device, policy):
    """Reduced mamba2's training on the card under each remat policy: the
    kernel path's fp32 loss and grads are the plain path's (2e-3 of each
    leaf's scale); per microbatch K3 under autograd once per layer (twice
    under a recomputing policy), K2 2L + 1 (+ 2L recomputed) and its
    backward 2L + 1; no gated K2, no K1; a donated bf16 step is finite."""
    from repro_torch.models.common import tree_leaves as leaves

    cfg = get_config("mamba2-2.7b").reduced()
    L, again = cfg.num_layers, int(policy != "none")
    out, launched, (p, _, m) = _train_pair(cfg, policy, 16, 192)
    assert launched["kernel"] == (0, 2 * L + 1 + 2 * L * again, 2 * L + 1, L * (1 + again),
                                  L * (1 + again))
    assert launched["ref"] == (0, 0, 0, 0, 0)
    _assert_same_grads(out)
    assert all(bool(torch.isfinite(x).all()) for x in leaves(p))
    assert np.isfinite(float(m["loss"]))


def test_cuda_hybrid_train_kernel_path_matches_ref_path(cuda_device):
    """Reduced zamba2 with a trailing Mamba layer (7 layers, 3 sites): fp32
    grads of the kernel path are the plain path's; per microbatch K1 once
    per site (under autograd), K3 once per layer, K2 and its backward 2L +
    2·sites + 1 (no remat: the family takes no runner, as in JAX)."""
    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(), num_layers=7)
    L, sites = cfg.num_layers, 3
    out, launched, (_, _, m) = _train_pair(cfg, "selective", 17, 160)
    norms = 2 * L + 2 * sites + 1
    assert launched["kernel"] == (sites, norms, norms, L, L)
    assert launched["ref"] == (0, 0, 0, 0, 0)
    _assert_same_grads(out)
    assert np.isfinite(float(m["loss"]))


def test_cuda_vlm_kernel_path_matches_ref_path(cuda_device):
    """The reduced internvl2 in fp32 on the card with a non-zero prefix:
    ``prefill_step(params, tokens, {"vis_embeds": v})`` then ``decode_step``
    at ``cache_index = Sv + S + i``: the kernel path's greedy tokens are the
    plain path's, with K1 L and K2 2L + 1 launches a forward."""
    cfg = get_config("internvl2-26b").reduced()
    Sv, S, new = cfg.vis_tokens, 40, 10
    params = build_model(cfg, device=cuda_device).init(
        torch.Generator(device=cuda_device).manual_seed(18))
    vis = torch.randn((3, Sv, cfg.d_model), generator=torch.Generator(
        device=cuda_device).manual_seed(19), device=cuda_device)
    prompts = torch.from_numpy(
        np.random.default_rng(18).integers(0, cfg.vocab_size, (3, S))).to(cuda_device)
    tokens = {}
    for impl in ("kernel", "ref"):
        model = build_model(cfg, impl=impl, device=cuda_device)
        engine = serving.step_engine(model, serving.single_device_plan(cfg), max_len=Sv + S + new,
                                     dtype=torch.float32)
        counts = (flash_ops.flash_attention_fwd.launches, rms_ops.rmsnorm.launches)
        logits, cache = engine.prefill_step(params, prompts, {"vis_embeds": vis})
        out = [logits[:, -1].argmax(-1)]
        for i in range(new - 1):
            kv_len = torch.full((3,), Sv + S + i + 1, device=cuda_device)
            logits, cache = engine.decode_step(params, out[-1][:, None], cache, Sv + S + i, kv_len)
            out.append(logits[:, -1].argmax(-1))
        tokens[impl] = torch.stack(out, dim=1).tolist()
        launched = (flash_ops.flash_attention_fwd.launches - counts[0],
                    rms_ops.rmsnorm.launches - counts[1])
        L = cfg.num_layers
        assert launched == ((new * L, new * (2 * L + 1)) if impl == "kernel" else (0, 0))
    assert tokens["kernel"] == tokens["ref"]


def test_cuda_vlm_train_kernel_path_matches_ref_path(cuda_device):
    """The reduced internvl2's fp32 loss and grads on the card under
    ``selective`` with seeded non-zero patch embeddings, kernel path against
    plain path; K1 2L, K2 4L + 1 and its backward 2L + 1 per microbatch."""
    cfg = get_config("internvl2-26b").reduced()
    L = cfg.num_layers
    vis = torch.randn((4, cfg.vis_tokens, cfg.d_model),
                      generator=torch.Generator().manual_seed(20)).bfloat16()
    out, launched, (_, _, m) = _train_pair(cfg, "selective", 20, cfg.vis_tokens + 128,
                                           {"vis_embeds": vis})
    assert launched["kernel"] == (2 * L, 4 * L + 1, 2 * L + 1, 0, 0)
    assert launched["ref"] == (0, 0, 0, 0, 0)
    _assert_same_grads(out)
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("arch", ["internvl2-26b", "mamba2-2.7b", "zamba2-7b"])
def test_cuda_measure_block_times_vlm_ssm_and_hybrid_blocks(cuda_device, arch):
    """``measure_block`` on the card for the families JAX measures through
    ``_block_apply_fn``'s other branches: finite, positive times and a peak
    above the block's bf16 parameters; K3 runs for a Mamba2 block."""
    import math

    from repro_torch.core import profiler_model as pm

    cfg = get_config(arch).reduced()
    n = ssd_ops.ssd.launches
    m = pm.measure_block(cfg, 256, batch=2, iters=3)
    for t in (m.fwd_time_s, m.bwd_time_s):
        assert math.isfinite(t) and t > 0.0
    assert m.peak_bytes > 2.0 * pm.profile_model(cfg, 256).layers[0].param_count
    assert (ssd_ops.ssd.launches > n) == (cfg.family != "vlm")


# ------------------------------------------------------------ CUDA graphs

def _same(got, want, what):
    """Graph replay against eager: bitwise, or (if cuBLAS picked another
    algorithm under capture) within 1e-6 of the eager values' scale; the
    case seen is printed."""
    if torch.equal(got, want):
        print(f"{what}: bitwise equal")
        return
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    print(f"{what}: not bitwise; max |diff| {err:.3e} on a scale of {scale:.3e}")
    assert err <= 1e-6 * scale, what


def _counts():
    from repro_torch.runtime.compiled import COUNTERS

    return [getattr(obj, attr) for obj, attr in COUNTERS]


def _kernel_cases(dev):
    """(name, fn, inputs maker): K1 on the split decode path and on the
    positional path of a prefill chunk, K2 plain and gated, K3 in bf16 and
    fp32."""
    def flash_decode(g):
        q = torch.randn((8, 1, 32, 64), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((8, 8192, 8, 64), generator=g, device=dev).bfloat16()
                for _ in range(2))
        kv_len = torch.randint(4000, 8193, (8,), generator=g, device=dev)
        return [q, k, v, *t_attn.flash_positions(kv_len - 1, 1, 8192, kv_len, 8, dev)]

    def flash_chunk(g):
        q = torch.randn((1, 256, 32, 64), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((1, 1280, 8, 64), generator=g, device=dev).bfloat16()
                for _ in range(2))
        off = torch.tensor(512, device=dev)
        return [q, k, v, *t_attn.flash_positions(off, 256, 1280, (off + 256).reshape(1), 1,
                                                 dev)]

    def rms(g, rows=8, D=2048):
        return [torch.randn((rows, D), generator=g, device=dev).bfloat16(),
                torch.randn((D,), generator=g, device=dev)]

    def gated(g):
        return [*(torch.randn((4, 5120), generator=g, device=dev).bfloat16() for _ in range(2)),
                torch.randn((5120,), generator=g, device=dev)]

    def ssd(dtype):
        return lambda g: list(_ssd_inputs(g, dev, 2, 200, 8, 64, 1, 128, dtype))

    def flash(q, k, v, qp, kp):
        return flash_ops.flash_attention_fwd(q, k, v, causal=True, q_pos=qp, k_pos=kp)

    return [("K1 split decode", flash, flash_decode), ("K1 positional chunk", flash, flash_chunk),
            ("K2", lambda x, s: rms_ops.rmsnorm(x, s), rms),
            ("K2 gated", lambda x, z, s: rms_ops.rmsnorm(x, s, gate=z), gated),
            ("K3 bf16", lambda *a: ssd_ops.ssd(*a), ssd(torch.bfloat16)),
            ("K3 fp32", lambda *a: ssd_ops.ssd(*a), ssd(torch.float32))]


@pytest.mark.parametrize("case", range(6))
def test_cuda_graph_replays_each_kernel_as_eager(cuda_device, case):
    """Each kernel captured in a graph and replayed on fresh inputs gives the
    eager call's output, and each replay adds the kernel's launches."""
    from repro_torch.runtime.compiled import compile_step

    name, fn, make = _kernel_cases(cuda_device)[case]
    g = torch.Generator(device=cuda_device).manual_seed(case)
    step = compile_step(fn, cuda_device, name=name)
    step(*make(g))                                  # warm-up, capture, one replay
    for _ in range(2):
        ins = make(g)
        want = fn(*ins)
        before = _counts()
        got = step(*ins)
        after = _counts()
        eager_before = _counts()
        fn(*ins)
        eager = [a - b for a, b in zip(_counts(), eager_before)]
        assert [a - b for a, b in zip(after, before)] == eager and any(eager)
        for i, (o, w) in enumerate(zip(*(x if isinstance(x, tuple) else (x,)
                                         for x in (got, want)))):
            _same(o, w, f"{name} output {i}")
    assert len(step.entries) == 1


def test_cuda_graph_of_a_llama_decode_step_counts_replayed_launches(cuda_device):
    """A reduced llama decode step through ``jit_decode_step``: N replays move
    the K1 and K2 counters by N x one eager step's launches, and each step's
    logits and cache are the eager step's."""
    cfg = get_config("llama3.2-1b").reduced()
    model = build_model(cfg, device=cuda_device)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(2), torch.bfloat16)
    eng = serving.step_engine(model, serving.single_device_plan(cfg), max_len=48)
    prompt = torch.randint(0, cfg.vocab_size, (3, 16), device=cuda_device,
                           generator=torch.Generator(device=cuda_device).manual_seed(3))
    _, cache = eng.prefill_step(params, prompt)
    eager_cache = {k: v.clone() for k, v in cache.items()}
    decode = eng.jit_decode_step(donate=True)
    tok = prompt[:, -1:]
    before = _counts()
    want, eager_cache = eng.decode_step(params, tok, eager_cache, 16)
    per_step = [a - b for a, b in zip(_counts(), before)]
    assert per_step[0] == cfg.num_layers and per_step[1] == 2 * cfg.num_layers + 1
    got, cache = decode(params, tok, cache, 16)     # warm-up, capture, one replay
    _same(got, want, "decode step 0")
    n = 5
    before = _counts()
    for i in range(1, n + 1):
        tok = want[:, -1].argmax(-1, keepdim=True)
        want, eager_cache = eng.decode_step(params, tok, eager_cache, 16 + i)
        got, cache = decode(params, tok, cache, 16 + i)
        _same(got, want, f"decode step {i}")
    moved = [a - b for a, b in zip(_counts(), before)]
    assert moved == [2 * n * d for d in per_step]   # n replays and n eager steps
    for k in cache:
        _same(cache[k], eager_cache[k], f"cache {k}")
    assert len(decode.compiled.entries) == 1


def test_cuda_compiled_scheduler_matches_the_eager_scheduler(cuda_device):
    """Reduced llama served in bf16 through the graphed scheduler and through
    ``compiled=False``: the same logits rows (bitwise, or within 1e-6 of
    scale) and tokens, and the same launches per tick."""
    from repro_torch.runtime.scheduler import ContinuousBatchingScheduler

    config = serving.ServeConfig(
        arch="llama3.2-1b", reduced=True, device="cuda",
        cache=serving.CacheConfig(max_context=48, page_size=8),
        scheduler=serving.SchedulerConfig(num_slots=3, prefill_chunk=8))
    cfg = config.model_config()
    model = build_model(cfg, device=cuda_device)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(5), torch.bfloat16)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 19), dtype=np.int32)
    rows, launched = {}, {}
    for compiled in (True, False):
        rec = rows.setdefault(compiled, {})

        def sample(logits, request, rng, rec=rec):
            rec[(request.rid, len(request.tokens))] = torch.from_numpy(logits.copy())
            return int(np.argmax(logits))

        sched = ContinuousBatchingScheduler(model, params, config.cache_config(),
                                            prefill_chunk=8, dtype=torch.bfloat16,
                                            sample_fn=sample, compiled=compiled)
        sched.submit(serving.Request(prompt=prompts[0], max_new=2))   # captures both graphs
        sched.run_until_drained()
        rec.clear()
        before = _counts()
        for p in prompts:
            sched.submit(serving.Request(prompt=p, max_new=7))
        sched.run_until_drained()
        launched[compiled] = [a - b for a, b in zip(_counts(), before)]
    assert rows[True].keys() == rows[False].keys() and len(rows[True]) == 4 * 7
    for key in rows[True]:
        _same(rows[True][key], rows[False][key], f"logits {key}")
    assert launched[True] == launched[False] and launched[True][0] > 0


def _tree_leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for v in tree.values() for leaf in _tree_leaves(v)]


def _moved(before):
    return [a - b for a, b in zip(_counts(), before)]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "internvl2-26b", "mamba2-2.7b",
                                  "moonshot-v1-16b-a3b", "zamba2-7b", "whisper-tiny"])
def test_cuda_jit_steps_match_the_eager_steps(cuda_device, arch):
    """``jit_prefill_step()`` and 8 ``jit_decode_step(donate=True)`` calls
    against ``prefill_step`` and ``decode_step`` on the same bf16 weights
    (internvl2 with seeded patch embeddings, whisper with seeded frames,
    zamba2 with 7 layers: 3 sites and a trailing Mamba layer): logits,
    tokens and every (nested) cache leaf equal.  The first call of each
    step launches 3 x the eager call's kernels (2 warm-up calls and the
    replay), each later replay 1 x (K1, K2, gated K2, K3 alike), and the
    donated cache is the graph's own buffer from the first call on."""
    cfg = get_config(arch).reduced()
    if arch == "zamba2-7b":
        cfg = dataclasses.replace(cfg, num_layers=7)
    model = build_model(cfg, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(9)
    params = model.init(g, torch.bfloat16)
    Sv = cfg.vis_tokens if cfg.family == "vlm" else 0
    S, new = 64, 9
    eng = serving.step_engine(model, serving.single_device_plan(cfg), max_len=Sv + S + new)
    prompt = torch.randint(0, cfg.vocab_size, (4, S), device=cuda_device, generator=g)
    side = {"vlm": ("vis_embeds", Sv), "audio": ("frames", cfg.enc_frames)}.get(cfg.family)
    extras = None
    if side:
        extras = {side[0]: torch.randn((4, side[1], cfg.d_model), device=cuda_device,
                                       generator=g).bfloat16()}
    before = _counts()
    want, eager_cache = eng.prefill_step(params, prompt, extras)
    per_prefill = _moved(before)
    assert (per_prefill[4] > 0) == (cfg.family in ("ssm", "hybrid"))      # K3
    prefill = eng.jit_prefill_step()
    before = _counts()
    got, cache = prefill(params, prompt, extras)
    assert _moved(before) == [3 * n for n in per_prefill]
    _same(got, want, f"{arch} prefill logits")
    for a, b in zip(_tree_leaves(cache), _tree_leaves(eager_cache)):
        _same(a, b, f"{arch} prefill cache")
    decode = eng.jit_decode_step(donate=True)
    buffers = [t.data_ptr() for t in _tree_leaves(cache)]
    attn = cfg.family not in ("ssm", "audio")
    tok = want[:, -1].argmax(-1, keepdim=True)
    for i in range(new - 1):
        pos = Sv + S + i
        kv_len = torch.full((4,), pos + 1, device=cuda_device) if attn else None
        before = _counts()
        want, eager_cache = eng.decode_step(params, tok, eager_cache, pos, kv_len)
        per_step = _moved(before)
        before = _counts()
        got, cache = decode(params, tok, cache, pos, kv_len)
        assert _moved(before) == [(3 if i == 0 else 1) * n for n in per_step]
        assert [t.data_ptr() for t in _tree_leaves(cache)] == buffers
        _same(got, want, f"{arch} decode step {i}")
        tok = want[:, -1].argmax(-1, keepdim=True)
        assert torch.equal(got[:, -1].argmax(-1, keepdim=True), tok)
    for a, b in zip(_tree_leaves(cache), _tree_leaves(eager_cache)):
        _same(a, b, f"{arch} cache after {new - 1} steps")
    assert len(decode.compiled.entries) == 1


BLOCK_ARCHS = ["llama3.2-1b", "internvl2-26b", "mamba2-2.7b", "zamba2-7b",
               "moonshot-v1-16b-a3b"]


@pytest.mark.parametrize("arch", BLOCK_ARCHS)
def test_cuda_measure_block_graphs_match_the_eager_steps(cuda_device, arch):
    """``block_steps`` at reduced width, S 256, batch 2, bf16, seeded input:
    the graphed forward, grad and full-remat grad (each captured with
    autograd inside: K2's backward kernel, K1's plain recompute, K3's, the
    MoE gathers' backwards) give the eager steps' outputs, and each replay
    adds the eager call's launches (the first call 3x: two warm-up calls
    and the replay after the capture)."""
    from repro_torch.core import profiler_model as pm

    cfg = get_config(arch).reduced()
    graphed, eager = (pm.block_steps(cfg, 256, batch=2, compiled=c, input_seed=4)
                      for c in (True, False))
    for name in ("forward", "grad", "grad_remat"):
        before = _counts()
        want = getattr(eager, name)(eager.params, eager.x)
        per_call = _moved(before)
        assert per_call[1] > 0 and (per_call[3] > 0) == (name != "forward")       # K2, bwd
        for i in range(3):
            before = _counts()
            got = getattr(graphed, name)(graphed.params, graphed.x)
            assert _moved(before) == [(3 if i == 0 else 1) * n for n in per_call]
            got, ref = (t if isinstance(t, tuple) else (t,) for t in (got, want))
            assert len(got) == len(ref) > 0
            for j, (a, b) in enumerate(zip(got, ref)):
                _same(a, b, f"{arch} {name} call {i} output {j}")
        assert len(getattr(graphed, name).entries) == 1


def test_cuda_measure_block_times_the_moe_block_in_graphs(cuda_device):
    """``measure_block`` on moonshot's reduced block, graphed: positive
    times and a peak above the block's bf16 parameters; K1, K2 and K2's
    backward launched (counted by replay)."""
    import math

    from repro_torch.core import profiler_model as pm

    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    before = _counts()
    m = pm.measure_block(cfg, 256, batch=2, iters=3)
    moved = _moved(before)
    for t in (m.fwd_time_s, m.bwd_time_s):
        assert math.isfinite(t) and t > 0.0
    assert math.isfinite(m.remat_extra_s) and m.remat_extra_s >= 0.0
    assert m.peak_bytes > 2.0 * pm.profile_model(cfg, 256).layers[0].param_count
    assert moved[0] > 0 and moved[1] > 0 and moved[3] > 0     # K1, K2, K2 backward


def test_cuda_a_capture_that_fails_raises(cuda_device):
    """A step that reads a tensor on the host cannot be captured: the
    capture raises, and nothing runs eagerly in its place.  (Last in the
    file: a failed capture is the one error this module provokes.)"""
    from repro_torch.runtime.compiled import compile_step

    step = compile_step(lambda x: x * float(x.sum()), cuda_device, name="host read")
    with pytest.raises(RuntimeError, match="capture of host read failed"):
        step(torch.ones(4, device=cuda_device))
    assert not step.entries
    torch.cuda.synchronize()
    assert torch.equal(torch.ones(4, device=cuda_device) * 2, torch.full((4,), 2.0,
                                                                          device=cuda_device))


# ------------------------------------------------------------------ the parallel runtime

def test_cuda_one_rank_nccl_mesh_is_bitwise_the_single_device_step(cuda_device, tmp_path):
    """A (1, 1) mesh over a one-rank NCCL group: every collective is the
    identity and every layout change a no-op, so two bf16 steps of reduced
    llama (ZeRO-1, ``selective``, grad_accum 2) give the ``mesh=None``
    step's losses and params bitwise."""
    import torch.distributed as dist

    from repro_torch.core.strategy import LayerStrategy, uniform_plan
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import tree_paths
    from repro_torch.runtime.data import SyntheticDataset
    from repro_torch.runtime.train import construct_hybrid_parallel_model

    cfg = get_config("llama3.2-1b").reduced()
    strat = LayerStrategy(zero=1, remat="selective")
    ds = SyntheticDataset(cfg, 64, 4, seed=2)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        runs = []
        for mesh in (None, make_mesh((1, 1), ("data", "model"), device=cuda_device)):
            shape, axes = ((1,), ("data",)) if mesh is None else ((1, 1), ("data", "model"))
            plan = uniform_plan(cfg.name, "t", shape, axes, cfg.num_layers, strat,
                                grad_accum=2)
            hp = construct_hybrid_parallel_model(build_model(cfg), plan, mesh)
            params = hp.init_params(torch.Generator(device=cuda_device).manual_seed(0))
            opt = hp.init_opt_state(params)
            losses = []
            for step in range(2):
                params, opt, m = hp.train_step(params, opt, ds.batch(step))
                losses.append(float(m["loss"]))
            runs.append((losses, hp.gather_params(params)))
        assert mesh.backend == "nccl"
    finally:
        dist.destroy_process_group()
    (l0, p0), (l1, p1) = runs
    assert l0 == l1
    for (path, a), (_, b) in zip(tree_paths(p0), tree_paths(p1)):
        assert torch.equal(a, b), path


def test_cuda_two_gloo_ranks_sharing_the_card_hold_tp2_sp_to_one_rank(cuda_device, tmp_path):
    """Two ranks on the one card over gloo, reduced llama at tp 2 with
    sequence parallelism (ZeRO-1): one fp32 step through K1 and K2 against
    one rank's ``mesh=None`` step on the same weights and batch: the loss
    within 1e-4 relative, every updated param within 2e-3 of its leaf's
    update scale (AdamW eps 1e-4, as tests/test_torch_parallel_mp.py)."""
    from repro_torch.core.strategy import LayerStrategy, uniform_plan
    from repro_torch.models.common import tree_map, tree_paths
    from repro_torch.runtime.data import SyntheticDataset
    from repro_torch.runtime.optimizer import AdamWConfig
    from repro_torch.runtime.train import construct_hybrid_parallel_model

    # by its path: this file runs with --noconftest where a ``tests`` package
    # of another project may shadow this directory
    spec = importlib.util.spec_from_file_location(
        "torch_dist_helpers", pathlib.Path(__file__).with_name("_torch_dist.py"))
    helpers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helpers)
    cfg = get_config("llama3.2-1b").reduced()
    opt_cfg = AdamWConfig(eps=1e-4)
    batch = SyntheticDataset(cfg, 64, 4, seed=5).batch(0)
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    plan = uniform_plan(cfg.name, "t", (1,), ("data",), cfg.num_layers, LayerStrategy())
    hp = construct_hybrid_parallel_model(build_model(cfg), plan, None, opt_cfg)
    live = tree_map(lambda x: x.to(cuda_device), params)
    new, _, m = hp.train_step(live, hp.init_opt_state(live), batch, torch.float32)
    case = dict(name="tp2_sp", cfg=cfg, strategies=[LayerStrategy(tp=2, sp=True, zero=1)],
                params=params, batch=batch)
    payload = {"mesh": (1, 2), "cases": [case], "opt": opt_cfg, "device": "cuda",
               "backend": "gloo"}          # NCCL refuses two ranks on one device
    got = helpers.run_ranks(2, "train_cases", payload, tmp_path)[0]["tp2_sp"]
    np.testing.assert_allclose(got["step_loss"], float(m["loss"]), rtol=1e-4)
    ref, init = dict(tree_paths(new)), dict(tree_paths(params))
    for path, a in tree_paths(got["new"]):
        want = ref[path].cpu() - init[path]
        err = float((a - ref[path].cpu()).abs().max())
        assert err <= 2e-3 * float(want.abs().max()), (path, err)


def test_cuda_two_gloo_ranks_pipeline_pp2_holds_to_one_rank(cuda_device, tmp_path):
    """Two pipeline stages on the one card over gloo (each hop through
    pinned host buffers: gloo sends host memory only), reduced llama cut to
    4 layers at pp 2 under 1f1b, grad_accum 4, fp32: ``train_step`` through
    K1 and K2 in each stage against one rank's ``mesh=None`` step at
    grad_accum 1 on the same weights and batch: the loss within 1e-4
    relative, every updated param within 2e-3 of its leaf's update scale
    (AdamW eps 1e-4); at most 2 microbatches in flight."""
    from repro_torch.core.strategy import LayerStrategy, uniform_plan
    from repro_torch.models.common import tree_map, tree_paths
    from repro_torch.runtime.data import SyntheticDataset
    from repro_torch.runtime.optimizer import AdamWConfig
    from repro_torch.runtime.train import construct_hybrid_parallel_model

    spec = importlib.util.spec_from_file_location(
        "torch_dist_helpers", pathlib.Path(__file__).with_name("_torch_dist.py"))
    helpers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helpers)
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(), num_layers=4)
    opt_cfg = AdamWConfig(eps=1e-4)
    batch = SyntheticDataset(cfg, 64, 8, seed=5).batch(0)
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    plan = uniform_plan(cfg.name, "t", (1,), ("data",), cfg.num_layers, LayerStrategy())
    hp = construct_hybrid_parallel_model(build_model(cfg), plan, None, opt_cfg)
    live = tree_map(lambda x: x.to(cuda_device), params)
    new, _, m = hp.train_step(live, hp.init_opt_state(live), batch, torch.float32)
    case = dict(name="pp2", cfg=cfg, strategies=[LayerStrategy()], params=params, batch=batch,
                mesh=(2, 1, 1), schedules=[("1f1b", 1)], grad_accum=4)
    payload = {"cases": [case], "opt": opt_cfg, "device": "cuda", "backend": "gloo"}
    ranks = helpers.run_ranks(2, "pipeline_cases", payload, tmp_path)
    got = ranks[0]["runs"]["pp2/1f1b"]
    np.testing.assert_allclose(got["step_loss"], float(m["loss"]), rtol=1e-4)
    ref, init = dict(tree_paths(new)), dict(tree_paths(params))
    for path, a in tree_paths(got["new"]):
        want = ref[path].cpu() - init[path]
        err = float((a - ref[path].cpu()).abs().max())
        assert err <= 2e-3 * float(want.abs().max()), (path, err)
    assert got["hop_bytes"]["host_copies"] == got["hop_bytes"]["sent"] * 2 > 0
    assert all(r["in_flight"]["pp2/1f1b"][1] <= 2 for r in ranks)


def test_cuda_four_gloo_ranks_pp2_cp2_hold_to_one_rank(cuda_device, tmp_path):
    """Two pipeline stages of two cp ranks each on the one card over gloo
    (the stage hop and the ring's through pinned host buffers), reduced
    llama cut to 4 layers at pp 2 x cp 2, ZeRO-1, ``selective``, under 1f1b
    and interleaved v 2, grad_accum 4, fp32: ``train_step`` through K1's
    ring partials and K2 in each stage against one rank's ``mesh=None`` step
    at grad_accum 1 on the same weights and batch: the loss within 1e-4
    relative, every updated param within 2e-3 of its leaf's update scale
    (AdamW eps 1e-4); the boundary block a rank's zig-zag half."""
    from repro_torch.core.strategy import LayerStrategy, uniform_plan
    from repro_torch.models.common import tree_map, tree_paths
    from repro_torch.runtime.data import SyntheticDataset
    from repro_torch.runtime.optimizer import AdamWConfig
    from repro_torch.runtime.train import construct_hybrid_parallel_model

    spec = importlib.util.spec_from_file_location(
        "torch_dist_helpers", pathlib.Path(__file__).with_name("_torch_dist.py"))
    helpers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helpers)
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(), num_layers=4)
    opt_cfg = AdamWConfig(eps=1e-4)
    batch = SyntheticDataset(cfg, 64, 8, seed=5).batch(0)
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    plan = uniform_plan(cfg.name, "t", (1,), ("data",), cfg.num_layers, LayerStrategy())
    hp = construct_hybrid_parallel_model(build_model(cfg), plan, None, opt_cfg)
    live = tree_map(lambda x: x.to(cuda_device), params)
    new, _, m = hp.train_step(live, hp.init_opt_state(live), batch, torch.float32)
    case = dict(name="ppcp", cfg=cfg, params=params, batch=batch, mesh=(2, 2, 1, 1),
                axes=("pod", "cp", "data", "model"), grad_accum=4,
                strategies=[LayerStrategy(cp=2, zero=1, remat="selective")],
                schedules=[("1f1b", 1), ("interleaved", 2)])
    payload = {"cases": [case], "opt": opt_cfg, "device": "cuda", "backend": "gloo"}
    ranks = helpers.run_ranks(4, "pipeline_cases", payload, tmp_path)
    ref, init = dict(tree_paths(new)), dict(tree_paths(params))
    for key in ("ppcp/1f1b", "ppcp/interleaved"):
        got = ranks[0]["runs"][key]
        np.testing.assert_allclose(got["step_loss"], float(m["loss"]), rtol=1e-4)
        for path, a in tree_paths(got["new"]):
            want = ref[path].cpu() - init[path]
            err = float((a - ref[path].cpu()).abs().max())
            assert err <= 2e-3 * float(want.abs().max()), (key, path, err)
        assert got["boundary_shape"] == (2, 32, cfg.d_model)
        assert got["hop_bytes"]["host_copies"] == got["hop_bytes"]["sent"] * 2 > 0
        assert all(r["in_flight"][key][1] <= 2 for r in ranks)


def test_cuda_distributed_slots_are_one_ranks_routing(cuda_device):
    """moonshot's routing of 8 192 seeded fp32 router logits on the card,
    split over 1 to 4 ranks and evaluated rank by rank from every rank's
    counts (``moe.distributed_slots``), gives one rank's expert indices,
    slots and keep mask on the whole batch exactly, at its capacity (C 960)
    and at a quarter of it (drops)."""
    from repro_torch.models import moe

    cfg = get_config("moonshot-v1-16b-a3b")
    T, E = 8192, cfg.num_experts
    g = torch.Generator(device=cuda_device).manual_seed(1)
    logits = torch.randn(T, E, generator=g, device=cuda_device)
    _, idx, _ = moe.route(logits, cfg)
    full = moe._capacity(cfg, T)
    for C in (full, full // 4):
        slots, keep = moe.assign_slots(idx, E, C)
        assert C == full or not bool(keep.all())          # a quarter of C drops
        for ranks in (1, 2, 4):
            parts = [moe.route(part, cfg)[1] for part in logits.chunk(ranks)]
            counts = torch.stack([moe.choice_counts(p, E) for p in parts])
            got = [moe.distributed_slots(p, counts, r, C) for r, p in enumerate(parts)]
            assert torch.equal(torch.cat(parts), idx)
            assert torch.equal(torch.cat([s for s, _, _ in got]), slots), (C, ranks)
            assert torch.equal(torch.cat([k for _, k, _ in got]), keep), (C, ranks)


def test_cuda_moe_one_rank_nccl_mesh_is_bitwise_the_single_device_step(cuda_device, tmp_path):
    """A (1, 1) mesh over a one-rank NCCL group runs the MoE layer's mesh
    path (a batch group of one rank): two bf16 steps of reduced moonshot (2
    layers; ZeRO-3, so the fp32 router is gathered; ``selective``,
    grad_accum 2) give the ``mesh=None`` step's losses and params bitwise."""
    import torch.distributed as dist

    from repro_torch.core.strategy import LayerStrategy, uniform_plan
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import tree_paths
    from repro_torch.runtime.data import SyntheticDataset
    from repro_torch.runtime.train import construct_hybrid_parallel_model

    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b").reduced(),
                              moe_capacity_factor=1.25)
    strat = LayerStrategy(zero=3, remat="selective")
    ds = SyntheticDataset(cfg, 64, 4, seed=2)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        runs = []
        for mesh in (None, make_mesh((1, 1), ("data", "model"), device=cuda_device)):
            shape, axes = ((1,), ("data",)) if mesh is None else ((1, 1), ("data", "model"))
            plan = uniform_plan(cfg.name, "t", shape, axes, cfg.num_layers, strat,
                                grad_accum=2)
            hp = construct_hybrid_parallel_model(build_model(cfg), plan, mesh)
            params = hp.init_params(torch.Generator(device=cuda_device).manual_seed(0))
            opt = hp.init_opt_state(params)
            losses = []
            for step in range(2):
                params, opt, m = hp.train_step(params, opt, ds.batch(step))
                losses.append((float(m["loss"]), float(m["aux"])))
            runs.append((losses, hp.gather_params(params)))
        assert mesh.backend == "nccl"
    finally:
        dist.destroy_process_group()
    (l0, p0), (l1, p1) = runs
    assert l0 == l1
    for (path, a), (_, b) in zip(tree_paths(p0), tree_paths(p1)):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rows,width", [(4096, 5120), (4096, 7168), (37, 666)])
def test_cuda_rmsnorm_split_passes_match_plain_and_the_whole_row(cuda_device, rows, width,
                                                                  dtype, tol):
    """K2's split-row form over two halves of a row (phase 27's gate norms
    at tp 2, and an odd half of 333 columns: the scalar template), each
    half's statistics summed by hand: each of the four passes against its
    plain version, and the halves concatenated against the whole-row K2 and
    its backward (dx at ``tol`` of its scale, dscale at 1e-4 of its scale
    in fp32, ``tol`` in bf16); each pass's launch counter moves once."""
    g = torch.Generator(device=cuda_device).manual_seed(rows + width)
    x = (3.0 * torch.randn((rows, width), generator=g, device=cuda_device)).to(dtype)
    gy = torch.randn((rows, width), generator=g, device=cuda_device).to(dtype)
    scale = 1 + 0.3 * torch.randn((width,), generator=g, device=cuda_device)
    xs = [t.contiguous() for t in x.chunk(2, -1)]
    gs = [t.contiguous() for t in gy.chunk(2, -1)]
    ss = list(scale.chunk(2))
    counters = [rms_ops.rmsnorm_split_sumsq, rms_ops.rmsnorm_split, rms_ops.rmsnorm_split_dot,
                rms_ops.rmsnorm_split_backward]
    before = [c.launches for c in counters]
    parts = [rms_ops.rmsnorm_split_sumsq(h) for h in xs]
    for p, h in zip(parts, xs):
        torch.testing.assert_close(p, rms_ops.rmsnorm_split_sumsq_reference(h), atol=1e-3,
                                   rtol=1e-5)
    stat = parts[0] + parts[1]
    outs = [rms_ops.rmsnorm_split(h, s, stat, width) for h, s in zip(xs, ss)]
    for o, h, s in zip(outs, xs, ss):
        torch.testing.assert_close(o.float(), rms_ops.rmsnorm_split_reference(
            h, s, stat, width).float(), atol=tol, rtol=tol)
    torch.testing.assert_close(torch.cat(outs, -1).float(),
                               rms_ops.rmsnorm(x, scale, 1e-5).float(), atol=tol, rtol=tol)
    dots = [rms_ops.rmsnorm_split_dot(h, s, q, stat, width) for h, s, q in zip(xs, ss, gs)]
    for d, h, s, q in zip(dots, xs, ss, gs):
        want = rms_ops.rmsnorm_split_dot_reference(h, s, q, stat, width)
        torch.testing.assert_close(d, want, atol=1e-4 * float(want.abs().max()), rtol=1e-4)
    dot = dots[0] + dots[1]
    grads = [rms_ops.rmsnorm_split_backward(h, s, q, stat, dot, width)
             for h, s, q in zip(xs, ss, gs)]
    dx, ds = torch.cat([a for a, _ in grads], -1), torch.cat([b for _, b in grads])
    wdx, wds = rms_ops.rmsnorm_backward(x, scale, gy, 1e-5)
    rgrads = [rms_ops.rmsnorm_split_backward_reference(h, s, q, stat, dot, width)
              for h, s, q in zip(xs, ss, gs)]
    rdx, rds = torch.cat([a for a, _ in rgrads], -1), torch.cat([b for _, b in rgrads])
    ds_tol = (1e-4 if dtype == torch.float32 else tol) * float(rds.abs().max())
    for got_dx, got_ds in ((rdx, rds), (wdx, wds)):
        torch.testing.assert_close(dx.float(), got_dx.float(),
                                   atol=tol * max(1.0, float(got_dx.float().abs().max())),
                                   rtol=tol)
        torch.testing.assert_close(ds, got_ds, atol=ds_tol, rtol=0)
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 2, 2, 2]


@pytest.mark.parametrize("arch,strategy", [
    ("mamba2-2.7b", dict(zero=1, remat="selective")),
    ("whisper-tiny", dict(zero=1))])
def test_cuda_ssm_and_audio_one_rank_nccl_mesh_is_bitwise_the_single_device_step(
        cuda_device, tmp_path, arch, strategy):
    """A (1, 1) mesh over a one-rank NCCL group: the model axis of one rank
    keeps every Mamba2 layer and attention block out of its region (the
    whole-row K2 on the gate norm, K3 on every head and group), so two bf16
    steps of reduced mamba2 (ZeRO-1, ``selective``) and whisper (ZeRO-1,
    real frames), grad_accum 2, give the ``mesh=None`` step's losses and
    params bitwise."""
    import torch.distributed as dist

    from repro_torch.core.strategy import LayerStrategy, uniform_plan
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import tree_paths
    from repro_torch.runtime.data import SyntheticDataset
    from repro_torch.runtime.train import construct_hybrid_parallel_model

    cfg = get_config(arch).reduced()
    strat = LayerStrategy(**strategy)
    ds = SyntheticDataset(cfg, 64, 4, seed=2)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        runs = []
        for mesh in (None, make_mesh((1, 1), ("data", "model"), device=cuda_device)):
            shape, axes = ((1,), ("data",)) if mesh is None else ((1, 1), ("data", "model"))
            plan = uniform_plan(cfg.name, "t", shape, axes, cfg.num_layers, strat,
                                grad_accum=2)
            hp = construct_hybrid_parallel_model(build_model(cfg), plan, mesh)
            params = hp.init_params(torch.Generator(device=cuda_device).manual_seed(0))
            opt = hp.init_opt_state(params)
            losses = []
            for step in range(2):
                params, opt, m = hp.train_step(params, opt, ds.batch(step))
                losses.append(float(m["loss"]))
            runs.append((losses, hp.gather_params(params)))
        assert mesh.backend == "nccl"
    finally:
        dist.destroy_process_group()
    (l0, p0), (l1, p1) = runs
    assert l0 == l1
    for (path, a), (_, b) in zip(tree_paths(p0), tree_paths(p1)):
        assert torch.equal(a, b), path


def test_cuda_exchange_is_a_plain_gather_on_gloo_ranks_sharing_the_card(cuda_device,
                                                                          tmp_path):
    """``collectives.exchange`` on CUDA tensors over two gloo ranks sharing
    the card (NCCL refuses two ranks on one device), uneven splits, fp32 and
    bf16: the rows received and the grad of the rows sent are bitwise a
    plain gather's."""
    spec = importlib.util.spec_from_file_location(
        "torch_dist_helpers", pathlib.Path(__file__).with_name("_torch_dist.py"))
    helpers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helpers)
    got = helpers.run_ranks(2, "exchange_rows", {"device": "cuda", "backend": "gloo"},
                            tmp_path)
    for rank in got:
        for dtype, res in rank.items():
            assert res["rows"] and res["grad"] and res["padding"] == 0.0, (dtype, res)


# ---------------------------------------------------------------- context parallelism

@pytest.mark.parametrize("S,cp", [(1024, 2), (768, 4)])
def test_cuda_ring_k1_partials_at_zigzag_shapes(cuda_device, S, cp):
    """The K1 calls of a rank's cp ring (parallel/context.py) at two small
    zig-zag shapes, llama's heads (32 over 8, hd 64): step 0 causal at the
    rank's zig-zag positions, a later step non-causal over the whole shard
    and an early chunk, or the late chunk over a whole shard; each against
    the plain version with residuals (fp32 1e-4, bf16 3e-2, m and l 1e-5)."""
    from repro_torch.parallel import context

    Sl = S // cp
    g = torch.Generator(device=cuda_device).manual_seed(S + cp)
    for index in range(cp):
        pos = context.zigzag_positions(S, cp, index, cuda_device)
        for Sq, Sk, causal in ((Sl, Sl, True), (Sl, Sl // 2, False), (Sl // 2, Sl, False)):
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
                q = torch.randn((1, Sq, 32, 64), generator=g, device=cuda_device).to(dtype)
                k, v = (torch.randn((1, Sk, 8, 64), generator=g, device=cuda_device).to(dtype)
                        for _ in range(2))
                kw = dict(causal=causal, q_pos=pos if causal else None,
                          k_pos=pos if causal else None)
                out, m, l = flash_ops.flash_attention_fwd(q, k, v, return_residuals=True, **kw)
                ref, rm, rl = flash_ref.flash_attention_fwd(q, k, v, return_residuals=True,
                                                            **kw)
                torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
                torch.testing.assert_close(m, rm, atol=1e-5, rtol=1e-5)
                torch.testing.assert_close(l, rl, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- serving on a mesh

@pytest.mark.parametrize("offset,kv_len", [(0, (520, 300)), (272, (520, 300)),
                                           (272, (200, 513))])
def test_cuda_flash_decode_partial_at_g8(cuda_device, offset, kv_len):
    """A serving-mesh rank's K1 decode partial (qwen2.5-3b on tp 2: every
    query head, 16 over 2 KV heads, g = 8, hd 128, over its 272-key slice
    of a 544-position cache): per-slot positions at the slice's key offset
    (``flash_positions(..., k_offset=...)``), residuals, on the split-K
    route; rank 1's slice with a slot that sees none of its keys (the mean
    of v, m = NEG_INF) included.  Against the plain version: o fp32 1e-4,
    bf16 3e-2; m and l 1e-5."""
    B, Sq, H, KV, hd, S_l = 2, 1, 16, 2, 128, 272
    kv = torch.tensor(kv_len, device=cuda_device)
    q_pos, k_pos = t_attn.flash_positions(kv - 1, Sq, S_l, kv, B, cuda_device, k_offset=offset)
    assert flash_ops.num_splits(B, KV, (H // KV) * Sq, S_l, flash_ops._sm_count(0)) > 1
    g = torch.Generator(device=cuda_device).manual_seed(offset + kv_len[1])
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        q = torch.randn((B, Sq, H, hd), generator=g, device=cuda_device).to(dtype)
        k, v = (torch.randn((B, S_l, KV, hd), generator=g, device=cuda_device).to(dtype)
                for _ in range(2))
        kw = dict(causal=True, q_pos=q_pos, k_pos=k_pos, return_residuals=True)
        out, m, l = flash_ops.flash_attention_fwd(q, k, v, **kw)
        ref, rm, rl = flash_ref.flash_attention_fwd(q, k, v, **kw)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(m, rm, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(l, rl, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_cuda_merged_k1_partials_are_the_whole_call(cuda_device, n):
    """One K1 decode call over a 544-key cache (g = 8, hd 128, per-slot
    positions) against K1's partials over its n slices, folded in fp32 by
    ``context.merge_partials`` as flash-decode folds them: o within
    1e-5 (fp32) and 3e-2 (bf16), the merged m and l within 1e-5 of the
    whole call's (fp32)."""
    from repro_torch.parallel import context

    B, Sq, H, KV, hd, S = 2, 1, 16, 2, 128, 544
    S_l = S // n
    kv = torch.tensor([530, 100], device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(n)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 3e-2)):
        q = torch.randn((B, Sq, H, hd), generator=g, device=cuda_device).to(dtype)
        k, v = (torch.randn((B, S, KV, hd), generator=g, device=cuda_device).to(dtype)
                for _ in range(2))
        q_pos, k_pos = t_attn.flash_positions(kv - 1, Sq, S, kv, B, cuda_device)
        out, m, l = flash_ops.flash_attention_fwd(q, k, v, causal=True, q_pos=q_pos,
                                                  k_pos=k_pos, return_residuals=True)
        parts = []
        for r in range(n):
            qp, kp = t_attn.flash_positions(kv - 1, Sq, S_l, kv, B, cuda_device,
                                            k_offset=r * S_l)
            o_r, m_r, l_r = flash_ops.flash_attention_fwd(
                q, k[:, r * S_l:(r + 1) * S_l].contiguous(),
                v[:, r * S_l:(r + 1) * S_l].contiguous(), causal=True, q_pos=qp, k_pos=kp,
                return_residuals=True)
            parts.append((o_r.float(), m_r.transpose(-1, -2), l_r.transpose(-1, -2)))
        merged, gm, gl = parts[0]
        for p in parts[1:]:
            merged, gm, gl = context.merge_partials(merged, gm, gl, *p)
        torch.testing.assert_close(merged, out.float(), atol=tol, rtol=tol)
        if dtype == torch.float32:
            torch.testing.assert_close(gm.transpose(-1, -2), m, atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(gl.transpose(-1, -2), l, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("Sq,Sk,causal", [(4096, 4096, True), (4096, 2048, False),
                                          (2048, 4096, False)])
def test_cuda_pipeline_context_k1_rows(cuda_device, Sq, Sk, causal):
    """The K1 calls of a rank's cp ring inside a pipeline stage (the
    ``pipeline_context`` rows: llama3.2-1b-long's heads, 32 over 8, hd 64,
    at S 8 192 and cp 2): step 0 causal at each rank's zig-zag positions,
    the later steps non-causal over the whole shard and an early chunk, or
    the late chunk over a whole shard; each against the plain version with
    residuals (fp32 1e-4, bf16 3e-2, m and l 1e-5)."""
    from repro_torch.parallel import context

    g = torch.Generator(device=cuda_device).manual_seed(Sq + Sk)
    for index in range(2 if causal else 1):
        pos = context.zigzag_positions(8192, 2, index, cuda_device) if causal else None
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
            q = torch.randn((1, Sq, 32, 64), generator=g, device=cuda_device).to(dtype)
            k, v = (torch.randn((1, Sk, 8, 64), generator=g, device=cuda_device).to(dtype)
                    for _ in range(2))
            kw = dict(causal=causal, q_pos=pos, k_pos=pos)
            out, m, l = flash_ops.flash_attention_fwd(q, k, v, return_residuals=True, **kw)
            ref, rm, rl = flash_ref.flash_attention_fwd(q, k, v, return_residuals=True, **kw)
            torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
            torch.testing.assert_close(m, rm, atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(l, rl, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_autograd_ring_grads_match_the_plain_serial_ring(cuda_device, cp, causal):
    """Every rank's half-block ring on K1 partials in one process
    (``ring_attention(use_flash=True)``, its hand-written backward going
    round the ring again) against ``torch.autograd.grad`` through the plain
    serial ring, fp32 (3e-4, JAX's grad tolerance), compact K/V at g = 4;
    K1 runs cp times a rank."""
    from repro_torch.parallel import context

    g = torch.Generator(device=cuda_device).manual_seed(cp + 10 * causal)
    B, S, H, KV, hd = 2, 512, 8, 2, 64
    q = torch.randn((B, S, H, hd), generator=g, device=cuda_device)
    k, v = (torch.randn((B, S, KV, hd), generator=g, device=cuda_device) for _ in range(2))
    w = torch.randn((B, S, H, hd), generator=g, device=cuda_device)
    runs = []
    for use_flash in (True, False):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        n = flash_ops.flash_attention_fwd.launches
        out = context.ring_attention(*leaves, causal=causal, cp=cp, use_flash=use_flash)
        if use_flash:
            assert flash_ops.flash_attention_fwd.launches == n + cp * cp
        runs.append((out, torch.autograd.grad((out * w).sum(), leaves)))
    (out, grads), (ref, ref_grads) = runs
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, atol=3e-4, rtol=3e-4)


def test_cuda_two_gloo_ranks_cp2_hold_to_one_rank(cuda_device, tmp_path):
    """Two ranks of the cp ring on the one card over gloo (each hop through
    pinned host buffers), reduced llama on (cp 2, data 1, model 1), ZeRO-1,
    fp32: one ``train_step`` through K1's ring partials and K2 against one
    rank's ``mesh=None`` step on the same weights and batch: the loss
    within 1e-4 relative, every updated param within 2e-3 of its leaf's
    update scale (AdamW eps 1e-4)."""
    from repro_torch.core.strategy import LayerStrategy, uniform_plan
    from repro_torch.models.common import tree_map, tree_paths
    from repro_torch.runtime.data import SyntheticDataset
    from repro_torch.runtime.optimizer import AdamWConfig
    from repro_torch.runtime.train import construct_hybrid_parallel_model

    spec = importlib.util.spec_from_file_location(
        "torch_dist_helpers", pathlib.Path(__file__).with_name("_torch_dist.py"))
    helpers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helpers)
    cfg = get_config("llama3.2-1b").reduced()
    opt_cfg = AdamWConfig(eps=1e-4)
    batch = SyntheticDataset(cfg, 256, 4, seed=5).batch(0)
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    plan = uniform_plan(cfg.name, "t", (1,), ("data",), cfg.num_layers, LayerStrategy())
    hp = construct_hybrid_parallel_model(build_model(cfg), plan, None, opt_cfg)
    live = tree_map(lambda x: x.to(cuda_device), params)
    new, _, m = hp.train_step(live, hp.init_opt_state(live), batch, torch.float32)
    case = dict(name="cp2", cfg=cfg, strategies=[LayerStrategy(cp=2, zero=1)], params=params,
                batch=batch, mesh=(2, 1, 1), axes=("cp", "data", "model"))
    payload = {"cases": [case], "opt": opt_cfg, "device": "cuda", "backend": "gloo"}
    got = helpers.run_ranks(2, "train_cases", payload, tmp_path)[0]["cp2"]
    np.testing.assert_allclose(got["step_loss"], float(m["loss"]), rtol=1e-4)
    ref, init = dict(tree_paths(new)), dict(tree_paths(params))
    for path, a in tree_paths(got["new"]):
        want = ref[path].cpu() - init[path]
        err = float((a - ref[path].cpu()).abs().max())
        assert err <= 2e-3 * float(want.abs().max()), (path, err)


def test_cuda_checkpoint_snapshot_is_fenced_before_an_in_place_update(cuda_device, tmp_path):
    """``save_async`` of CUDA leaves, then at once a long queue of kernels
    and an in-place update of every leaf: the written checkpoint holds the
    values at the call (the snapshot's pinned copies run ahead of the
    update on the stream, and the writer waits on their event)."""
    from repro_torch.runtime import checkpoint as ckpt

    g = torch.Generator(device=cuda_device).manual_seed(0)
    tree = {"w": torch.randn(4096, 4096, generator=g, device=cuda_device),
            "b": torch.randn(4096, generator=g, device=cuda_device).to(torch.bfloat16)}
    want = {k: v.cpu() for k, v in tree.items()}
    with ckpt.CheckpointWriter() as w:
        w.save_async(tmp_path, 1, tree)
        torch.cuda._sleep(int(2e8))                # keep the stream busy
        for x in tree.values():
            x.mul_(-3.0).add_(1.0)
    out = ckpt.restore(tmp_path, params_like=want)["params"]
    for k in want:
        assert out[k].dtype == want[k].dtype and torch.equal(out[k], want[k]), k
    assert not torch.equal(tree["w"].cpu(), want["w"])


def test_cuda_checkpoint_bf16_round_trips_through_the_card(cuda_device, tmp_path):
    """A bf16 optimizer state on the card: saved sync and async (the same
    bytes), restored, placed back on the card bitwise, its index naming the
    leaves ``bfloat16``."""
    import json

    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.runtime.optimizer import AdamWState

    g = torch.Generator(device=cuda_device).manual_seed(1)
    m = {"embed": {"tok": torch.randn(1000, 64, generator=g, device=cuda_device)
                   .to(torch.bfloat16)}}
    opt = AdamWState(step=torch.tensor(5, dtype=torch.int32, device=cuda_device), m=m,
                     v={"embed": {"tok": m["embed"]["tok"].square()}})
    params = {"embed": {"tok": torch.randn(1000, 64, generator=g, device=cuda_device)}}
    ckpt.save(tmp_path / "sync", 5, params, opt)
    with ckpt.CheckpointWriter() as w:
        w.save_async(tmp_path / "async", 5, params, opt)
    for name in ("step000000005.json", "MANIFEST"):
        assert ((tmp_path / "sync" / name).read_bytes()
                == (tmp_path / "async" / name).read_bytes())
    shards = json.loads((tmp_path / "sync" / "step000000005.json").read_text())["shards"]
    assert shards["opt/.m/embed/tok"]["dtype"] == "bfloat16"
    out = ckpt.restore(tmp_path / "async", params_like=params, opt_like=opt)
    back = out["opt"].m["embed"]["tok"].to(cuda_device)
    assert back.dtype == torch.bfloat16 and torch.equal(back, m["embed"]["tok"])
    assert torch.equal(out["opt"].v["embed"]["tok"].to(cuda_device), opt.v["embed"]["tok"])
    assert out["opt"].step.shape == () and int(out["opt"].step) == 5
    assert torch.equal(out["params"]["embed"]["tok"].to(cuda_device), params["embed"]["tok"])


def test_cuda_fence_waits_for_queued_work(cuda_device):
    """``obs.fence`` on a tree holding a CUDA tensor: a ``StepTimer``
    fenced by it reads at least the CUDA-event time of the same matmul
    loop; with a no-op fence it reads less (the launches alone)."""
    from repro_torch import obs

    g = torch.Generator(device=cuda_device).manual_seed(0)
    a, b = (torch.randn(4096, 4096, generator=g, device=cuda_device, dtype=torch.bfloat16)
            for _ in range(2))
    c = torch.empty_like(a)

    def work():
        for _ in range(32):
            torch.mm(a, b, out=c)
        return {"out": [c], "host": torch.zeros(1)}

    work()
    torch.cuda.synchronize()
    got = {}
    for label, fence_fn in (("fenced", obs.fence), ("unfenced", lambda outputs: None)):
        timer = obs.StepTimer(obs.MetricsRegistry(), fence_fn=fence_fn)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        timer.start()
        start.record()
        out = work()
        end.record()
        rec = timer.stop(0, out)
        end.synchronize()
        got[label] = (rec.step_time_s, start.elapsed_time(end) / 1e3)
    assert got["fenced"][0] >= got["fenced"][1] > 0
    assert got["unfenced"][0] < got["unfenced"][1]


def test_cuda_scheduler_with_telemetry_replays_its_graphs_bitwise(cuda_device):
    """Reduced llama in bf16 through the graphed scheduler with and without
    ``metrics`` / ``sink``: the hooks run on the host around the replays, so
    the tokens are bitwise the same, both graphs are captured once, and the
    log and the histograms count every request."""
    from repro_torch import obs
    from repro_torch.runtime.scheduler import ContinuousBatchingScheduler

    config = serving.ServeConfig(
        arch="llama3.2-1b", reduced=True, device="cuda",
        cache=serving.CacheConfig(max_context=48, page_size=8),
        scheduler=serving.SchedulerConfig(num_slots=3, prefill_chunk=8))
    cfg = config.model_config()
    model = build_model(cfg, device=cuda_device)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(6), torch.bfloat16)
    prompts = np.random.default_rng(6).integers(0, cfg.vocab_size, (4, 19), dtype=np.int32)
    tokens, logged = {}, []

    class Sink:
        def emit(self, event, **fields):
            logged.append(event)

    for telemetry in (False, True):
        reg = obs.MetricsRegistry() if telemetry else None
        sched = ContinuousBatchingScheduler(model, params, config.cache_config(),
                                            prefill_chunk=8, dtype=torch.bfloat16,
                                            metrics=reg, sink=Sink() if telemetry else None)
        reqs = [sched.submit(serving.Request(prompt=p, max_new=7)).request for p in prompts]
        sched.run_until_drained()
        steps = (sched._decode_fn, sched._prefill_fn)
        assert all(len(f.entries) == 1 and next(iter(f.entries.values())).graph is not None
                   for f in steps)
        tokens[telemetry] = [r.tokens for r in reqs]
    assert tokens[True] == tokens[False]
    assert logged.count("request_end") == 4 and reg.snapshot()["tpot_s"]["count"] == 4


def test_cuda_checkpoint_writer_logs_to_its_sink(cuda_device, tmp_path):
    """``CheckpointWriter(sink=RunSink)`` saving CUDA leaves: one ``queued``
    and one ``written`` event a save, JAX's fields, and the writer's spans
    in the default timeline."""
    from repro_torch import obs
    from repro_torch.runtime import checkpoint as ckpt

    g = torch.Generator(device=cuda_device).manual_seed(2)
    tree = {"w": torch.randn(1024, 1024, generator=g, device=cuda_device)}
    before = len(obs.default_tracer().timeline())
    with obs.RunSink.create(tmp_path / "run") as sink, ckpt.CheckpointWriter(sink=sink) as w:
        for step in (1, 2):
            w.save_async(tmp_path / "ck", step, tree)
    events = [e for e in obs.read_run(tmp_path / "run" / "run.jsonl") if e["event"] == "ckpt"]
    assert sorted((e["phase"], e["step"]) for e in events) == [
        ("queued", 1), ("queued", 2), ("written", 1), ("written", 2)]
    keys = {e["phase"]: set(e) for e in events}
    assert keys["queued"] == {"event", "ts", "phase", "step", "stall_seconds", "queue_depth"}
    assert keys["written"] == {"event", "ts", "phase", "step", "write_seconds", "path"}
    names = [r["name"] for r in obs.default_tracer().timeline()[before:]]
    assert names.count("ckpt_host_copy") == names.count("ckpt_enqueue") == 2


# --------------------------------------------------------------------------
# the dry run's trace beside real steps
# --------------------------------------------------------------------------

def _small_trainer(policy: str, device="cuda"):
    from repro_torch.core.strategy import LayerStrategy, uniform_plan
    from repro_torch.runtime.train import construct_hybrid_parallel_model

    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=2)
    plan = uniform_plan(cfg.name, "train", (1,), ("data",), cfg.num_layers,
                        LayerStrategy(remat=policy), grad_accum=2)
    return cfg, construct_hybrid_parallel_model(build_model(cfg, device=device), plan)


def test_cuda_launch_counters_rise_after_a_fake_trace(cuda_device):
    """A step traced on fake CUDA tensors launches and counts nothing; the
    same process's real step on the card then launches every kernel and
    counts each launch as before."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.step_trace import materialize, trace_step
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.runtime.data import SyntheticDataset, input_specs

    cfg, hp = _small_trainer("selective")
    spec = ShapeSpec("t", "train", 512, 4)
    before = _counts()
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = materialize(hp.abstract_params(), cuda_device)
        opt = materialize(hp.abstract_opt_state(), cuda_device)
        batch = materialize(input_specs(cfg, spec, hp.model), cuda_device)
        tr = trace_step(lambda: hp.train_step(params, opt, batch), (params, opt, batch))
    assert _counts() == before
    assert tr.kernel_counts()["flash_attention_fwd"] > 0
    real = hp.init_params(torch.Generator(device=cuda_device).manual_seed(0))
    out = hp.train_step(real, hp.init_opt_state(real), SyntheticDataset(cfg, 512, 4).batch(0))
    assert torch.isfinite(out[2]["loss"])
    moved = _moved(before)            # K1, K2, gated K2, K2's backward, ...
    assert moved[0] == tr.kernel_counts()["flash_attention_fwd"]
    assert moved[1] == tr.kernel_counts()["rmsnorm"]
    assert moved[3] == tr.kernel_counts()["rmsnorm_backward"]


@pytest.mark.parametrize("policy", ["none", "selective", "full"])
def test_cuda_traced_temp_is_the_measured_step_peak(cuda_device, policy):
    """A small real step's peak above its arguments (``max_memory_allocated``
    after ``reset_peak_memory_stats`` minus ``memory_allocated`` before the
    step) within 10 % of its trace's temp on meta tensors; the arguments'
    bytes equal."""
    from repro_torch.analysis.step_trace import materialize, trace_step
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.models.common import tree_leaves
    from repro_torch.runtime.data import SyntheticDataset, input_specs

    cfg, hp = _small_trainer(policy)
    spec = ShapeSpec("t", "train", 1024, 4)
    meta_hp = _small_trainer(policy, "meta")[1]
    params = materialize(meta_hp.abstract_params(), "meta")
    opt = materialize(meta_hp.abstract_opt_state(), "meta")
    batch = materialize(input_specs(cfg, spec, meta_hp.model), "meta")
    tr = trace_step(lambda: meta_hp.train_step(params, opt, batch), (params, opt, batch),
                    memory_only=True)
    real = hp.init_params(torch.Generator(device=cuda_device).manual_seed(0))
    ropt = hp.init_opt_state(real)
    rbatch = {k: torch.as_tensor(v).to(cuda_device)
              for k, v in SyntheticDataset(cfg, 1024, 4).batch(0).items()}
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(real) + tree_leaves(ropt.m)
                 + tree_leaves(ropt.v) + [ropt.step] + list(rbatch.values()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    hp.train_step(real, ropt, rbatch)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - before
    assert tr.argument_bytes == nbytes
    assert abs(tr.temp_bytes - measured) <= 0.10 * measured, (tr.temp_bytes, measured)


# ------------------------------------------------- ssm and hybrid on a serving mesh

@pytest.mark.parametrize("offset,kv_len", [(0, (520, 300)), (272, (520, 513)),
                                           (272, (200, 529))])
def test_cuda_flash_decode_partial_at_hd112(cuda_device, offset, kv_len):
    """A zamba2 site's K1 decode partial on a serving-mesh rank (every query
    head, 32 over 32 KV heads, g = 1, hd 112, over a 272-key slice of a
    544-position cache): per-slot positions at the slice's key offset,
    residuals; a slot that sees none of rank 1's keys included.  Against
    the plain version: o fp32 1e-4, bf16 3e-2; m and l 1e-5."""
    B, Sq, H, hd, S_l = 2, 1, 32, 112, 272
    kv = torch.tensor(kv_len, device=cuda_device)
    q_pos, k_pos = t_attn.flash_positions(kv - 1, Sq, S_l, kv, B, cuda_device, k_offset=offset)
    g = torch.Generator(device=cuda_device).manual_seed(offset + kv_len[1])
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        q = torch.randn((B, Sq, H, hd), generator=g, device=cuda_device).to(dtype)
        k, v = (torch.randn((B, S_l, H, hd), generator=g, device=cuda_device).to(dtype)
                for _ in range(2))
        kw = dict(causal=True, q_pos=q_pos, k_pos=k_pos, return_residuals=True)
        out, m, l = flash_ops.flash_attention_fwd(q, k, v, **kw)
        ref, rm, rl = flash_ref.flash_attention_fwd(q, k, v, **kw)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(m, rm, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(l, rl, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rows", [1024, 2])
@pytest.mark.parametrize("width", [5120, 7168])
def test_cuda_rmsnorm_split_serving_rows(cuda_device, rows, width):
    """The gate norm of a tp 2 serving rank (mamba2's d_inner 5120, zamba2's
    7168; a prefill of 2 x 512 rows and a decode step's 2): each half's two
    forward passes, the statistics summed by hand, against the plain passes
    and, concatenated, the whole-row K2 (fp32 1e-5, bf16 2e-2)."""
    g = torch.Generator(device=cuda_device).manual_seed(rows + width)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        x = (3.0 * torch.randn((rows, width), generator=g, device=cuda_device)).to(dtype)
        scale = 1 + 0.3 * torch.randn((width,), generator=g, device=cuda_device)
        xs, ss = [t.contiguous() for t in x.chunk(2, -1)], list(scale.chunk(2))
        stat = sum(rms_ops.rmsnorm_split_sumsq(h) for h in xs)
        want_stat = sum(rms_ops.rmsnorm_split_sumsq_reference(h) for h in xs)
        torch.testing.assert_close(stat, want_stat, atol=1e-3, rtol=1e-5)
        outs = [rms_ops.rmsnorm_split(h, s, stat, width) for h, s in zip(xs, ss)]
        for o, h, s in zip(outs, xs, ss):
            torch.testing.assert_close(o.float(), rms_ops.rmsnorm_split_reference(
                h, s, stat, width).float(), atol=tol, rtol=tol)
        torch.testing.assert_close(torch.cat(outs, -1).float(),
                                   rms_ops.rmsnorm(x, scale, 1e-5).float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("H,G,N,rank", [(80, 1, 128, 1), (112, 2, 64, 1), (112, 2, 64, 0)])
def test_cuda_ssd_on_a_ranks_heads(cuda_device, H, G, N, rank):
    """K3 on a tp 2 serving rank's heads at prefill (mamba2: 40 of 80 heads,
    G 1; zamba2: 56 of 112 heads, the one of 2 groups they read,
    ``mamba2.local_groups``), B2 S512 P64 in bf16 and fp32: against the
    plain version (1e-3 of its scale, a bf16 y one bf16 step more), and
    against the whole call's heads, which read the same group."""
    from repro_torch.models.mamba2 import local_groups

    Bs, S, P = 2, 512, 64
    h0, h1 = rank * H // 2, (rank + 1) * H // 2
    g0, g1 = local_groups(H, G, 2, rank)
    gen = torch.Generator(device=cuda_device).manual_seed(H + rank)
    for dtype in (torch.bfloat16, torch.float32):
        x, dt, A, B, C = _ssd_inputs(gen, cuda_device, Bs, S, H, P, G, N, dtype)
        local = [t[:, :, h0:h1].contiguous() for t in (x, dt)] + [A[h0:h1].contiguous()] + \
            [t[:, :, g0:g1].contiguous() for t in (B, C)]
        y, st = ssd_ops.ssd(*local)
        ry, rs = ssd_ref.ssd_chunked(*local)
        wy, ws = ssd_ops.ssd(x, dt, A, B, C)
        torch.cuda.synchronize()
        rtol_y = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
        for a, b, rtol in ((y.float(), ry.float(), rtol_y), (st, rs, 0.0),
                           (y.float(), wy[:, :, h0:h1].float(), rtol_y),
                           (st, ws[:, h0:h1], 0.0)):
            tol = 1e-3 * max(1.0, float(b.abs().max()))
            assert bool(((a - b).abs() <= tol + rtol * b.abs()).all()), (dtype, a.shape)


def _serve_mesh_case(name, cfg, max_len, seed):
    """A reduced model's canonical fp32 weights (SSM heads' ``A_log``,
    ``D`` and ``dt_bias`` drawn apart), prompts and 3 teacher-forced decode
    steps, as ``_torch_dist.serve_cases`` takes them on (data 1, model 2)."""
    g = torch.Generator().manual_seed(seed)
    params = build_model(cfg, device="cpu").init(g)
    blocks = params["blocks"]
    blocks["A_log"] += 0.5 * torch.randn(blocks["A_log"].shape, generator=g)
    blocks["dt_bias"] += 0.5 * torch.randn(blocks["dt_bias"].shape, generator=g)
    blocks["D"] *= 1 + 0.5 * torch.randn(blocks["D"].shape, generator=g)
    rng = np.random.default_rng(seed)
    B, S = 4, 32
    steps = [(torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1))), S + i,
              torch.tensor([S + i + 1 - d for d in (0, 1, 0, 2)])) for i in range(3)]
    return dict(name=name, cfg=cfg, mesh=(1, 2), tp=2, max_len=max_len, max_new=4,
                params=params, tokens=torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))),
                extras=None, steps=steps)


def test_cuda_ssm_and_hybrid_serve_on_gloo_ranks_sharing_the_card(cuda_device, tmp_path):
    """Reduced mamba2 (8 SSM heads, G 1) and zamba2 at 6 layers (8 heads in
    2 groups, 3 sites, a 36-position cache split over the model axis: the
    sites decode by flash-decode) in fp32 on two gloo ranks sharing the
    card, tp 2, the kernel path (K3 on each rank's heads and group, K2's
    split-row gate norm, K1's partials): the prefill's and each decode
    step's logits and the gathered cache within 1e-3 of their scale of one
    device's plain path (``impl="ref"``), and the greedy tokens equal."""
    spec = importlib.util.spec_from_file_location(
        "torch_dist_helpers", pathlib.Path(__file__).with_name("_torch_dist.py"))
    helpers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helpers)
    cases = [_serve_mesh_case("ssm", get_config("mamba2-2.7b").reduced(), 36, 0),
             _serve_mesh_case("hybrid", dataclasses.replace(
                 get_config("zamba2-7b").reduced(), num_layers=6), 36, 1)]
    got = helpers.run_ranks(2, "serve_cases", {"cases": cases, "device": "cuda",
                                               "backend": "gloo"}, tmp_path)

    def close(a, b, what):
        scale = max(1.0, float(b.abs().max()))
        assert float((a.float() - b.float().cpu()).abs().max()) <= 1e-3 * scale, what

    for case in cases:
        cfg = case["cfg"]
        eng = serving.step_engine(build_model(cfg, impl="ref", device=cuda_device),
                                  serving.single_device_plan(cfg), batch=4,
                                  max_len=case["max_len"], dtype=torch.float32)
        params = _to(case["params"], cuda_device)
        logits, cache = eng.prefill_step(params, case["tokens"].to(cuda_device))
        want = [logits]
        for tok, index, kv in case["steps"]:
            logits, cache = eng.decode_step(params, tok.to(cuda_device), cache, index,
                                            kv.to(cuda_device))
            want.append(logits)
        greedy = eng.greedy_generate(params, case["tokens"].to(cuda_device), 4, 36)
        for res in (r[case["name"]] for r in got):
            for i, (a, b) in enumerate(zip([res["prefill"]] + res["steps"], want)):
                close(a, b, f"{case['name']} step {i}")
            gathered = dict(tree_paths(res["cache"]))
            for path, leaf in tree_paths(cache):
                close(gathered[path], leaf, f"{case['name']} {path}")
            assert res["greedy"].tolist() == greedy.tolist(), case["name"]


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}
