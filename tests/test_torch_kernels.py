"""The port's kernels on the CPU: each plain version (the route a CPU tensor
takes through the wrapper) against the JAX package's Pallas kernel in
interpret mode, on the same numpy inputs; the attention dispatch's
explicit-position form against JAX ``dense_attention``; and the wrappers'
device rules.  The CUDA kernels themselves are held against these plain
versions on the card (``chip_smoke.py`` and ``tests/test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_fwd as jax_flash
from repro.kernels.rmsnorm.kernel import rmsnorm_pallas
from repro.models import attention as jax_attn
from repro.parallel.context import zigzag_permutation
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models import attention as t_attn

# the JAX kernel tests' shapes and tolerances (tests/test_kernels_flash.py)
SHAPES = [
    (1, 128, 1, 64),
    (2, 256, 4, 64),
    (1, 512, 2, 128),
    (2, 384, 3, 32),
]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _qkv(seed, shape, dtype_name, sk=None):
    jd, td = DTYPES[dtype_name]
    kshape = shape if sk is None else (shape[0], sk) + tuple(shape[2:])
    arrs = [_normal(seed, shape), _normal(seed + 1, kshape), _normal(seed + 2, kshape)]
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


# ------------------------------------------------------------- flash attention

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_matches_pallas_kernel(shape, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(0, shape, dtype)
    ref = jax_flash(jq, jk, jv, causal=causal, interpret=True)
    out = flash_ops.flash_attention_fwd(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=TOL[dtype], rtol=TOL[dtype])


def test_plain_flash_positional_zigzag_and_residuals():
    """Explicit positions under a zig-zag permutation, and the (m, l)
    residuals, against the Pallas kernel at 1e-5."""
    B, S, H, hd = 1, 256, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _qkv(3, (B, S, H, hd), "float32")
    perm = np.asarray(zigzag_permutation(S, 4), np.int32)
    jo, jm, jl = jax_flash(jq[:, perm], jk[:, perm], jv[:, perm], causal=True,
                           q_pos=jnp.asarray(perm), k_pos=jnp.asarray(perm),
                           return_residuals=True, interpret=True)
    p = torch.from_numpy(perm)
    to, tm, tl = flash_ops.flash_attention_fwd(tq[:, p], tk[:, p], tv[:, p], causal=True,
                                               q_pos=p, k_pos=p, return_residuals=True)
    for a, b in ((to, jo), (tm, jm), (tl, jl)):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-5, rtol=1e-5)


def test_plain_flash_batched_positions_and_half_kv_residuals():
    """(B, S) positions and a kv shard (Sk != Sq), residuals included."""
    B, S, H, hd = 2, 128, 2, 64
    (jq, jk, jv), (tq, tk, tv) = _qkv(5, (B, S, H, hd), "float32")
    rng = np.random.default_rng(6)
    qp = np.stack([rng.permutation(S) for _ in range(B)]).astype(np.int32)
    kp = np.stack([np.sort(rng.permutation(S)[:S // 2]) for _ in range(B)]).astype(np.int32)
    half = S // 2
    jr = jax_flash(jq, jk[:, :half], jv[:, :half], causal=True, q_pos=jnp.asarray(qp),
                   k_pos=jnp.asarray(kp), return_residuals=True, interpret=True)
    tr = flash_ops.flash_attention_fwd(tq, tk[:, :half], tv[:, :half], causal=True,
                                       q_pos=torch.from_numpy(qp), k_pos=torch.from_numpy(kp),
                                       return_residuals=True)
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,Sq,Sk,offsets", [
    (4, 1, 33, (0, 7, 20, 32)),        # decode: one row per slot, odd Sk
    (1, 16, 80, (20,)),                # a prefill chunk at cache_index 20
    (3, 5, 29, (0, 11, 24)),           # ragged multi-token steps per slot
])
def test_dispatch_positions_match_dense_attention(B, Sq, Sk, offsets):
    """``q_pos = offset + arange(Sq)`` and ``k_pos = arange(Sk)`` with keys
    at or beyond kv_len moved to INT32_MAX reproduce ``dense_attention``'s
    ``(k <= q_offset + i) & (k < kv_len)`` mask, row for row — with equal
    head counts, and with compact GQA k/v (g = 4) and the positions built
    once by ``flash_positions``, as ``forward_decode`` hands them to every
    layer."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(8, (B, Sq, 4, 32), "float32", sk=Sk)
    off = np.asarray(offsets, np.int32)
    kv_len = off + Sq
    out = t_attn._flash(tq, tk, tv, causal=True, q_offset=torch.from_numpy(off),
                        kv_len=torch.from_numpy(kv_len))
    # GQA: one compact kv head shared by the 4 query heads
    tkc, tvc = tk[:, :, :1].contiguous(), tv[:, :, :1].contiguous()
    jkc, jvc = (jnp.repeat(a[:, :, :1], 4, axis=2) for a in (jk, jv))
    positions = t_attn.flash_positions(torch.from_numpy(off), Sq, Sk,
                                       torch.from_numpy(kv_len), B, tq.device)
    out_gqa = t_attn._flash(tq, tkc, tvc, causal=True, positions=positions)
    for b in range(B):           # JAX takes one scalar offset per call (vmap lane)
        for o, k_, v_ in ((out, jk, jv), (out_gqa, jkc, jvc)):
            ref = jax_attn.dense_attention(jq[b:b + 1], k_[b:b + 1], v_[b:b + 1], causal=True,
                                           q_offset=int(off[b]),
                                           kv_len=jnp.asarray(kv_len[b:b + 1]))
            np.testing.assert_allclose(_f32(o[b:b + 1]), _f32(ref), atol=1e-5, rtol=1e-5)


def test_dispatch_noncausal_kv_len_and_fully_masked_rows():
    """Non-causal with valid lengths, and a row with no valid key (the mean
    of v, from the finite NEG_INF) — both as dense_attention, with equal
    head counts and with compact GQA k/v (g = 4) on positions from
    ``flash_positions``."""
    B, Sq, Sk = 2, 3, 9
    (jq, jk, jv), (tq, tk, tv) = _qkv(11, (B, Sq, 8, 32), "float32", sk=Sk)
    kv_len = np.asarray([4, 9], np.int32)
    tkc, tvc = tk[:, :, ::4].contiguous(), tv[:, :, ::4].contiguous()      # KV = 2
    jkc, jvc = (jnp.repeat(a[:, :, ::4], 4, axis=2) for a in (jk, jv))
    for k_, v_, jk_, jv_ in ((tk, tv, jk, jv), (tkc, tvc, jkc, jvc)):
        out = t_attn._flash(tq, k_, v_, causal=False, q_offset=0,
                            kv_len=torch.from_numpy(kv_len))
        pos = t_attn.flash_positions(0, Sq, Sk, torch.from_numpy(kv_len), B, tq.device,
                                     causal=False)
        out_pos = t_attn._flash(tq, k_, v_, causal=False, positions=pos)
        ref = jax_attn.dense_attention(jq, jk_, jv_, causal=False, kv_len=jnp.asarray(kv_len))
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_f32(out_pos), _f32(ref), atol=1e-5, rtol=1e-5)
        masked = t_attn._flash(tq, k_, v_, causal=True, q_offset=0,
                               kv_len=torch.zeros(B, dtype=torch.int32))
        ref = jax_attn.dense_attention(jq, jk_, jv_, causal=True,
                                       kv_len=jnp.zeros((B,), jnp.int32))
        np.testing.assert_allclose(_f32(masked), _f32(ref), atol=1e-5, rtol=1e-5)
        mean = np.repeat(_f32(v_).mean(axis=1), 8 // v_.shape[2], axis=1)
        np.testing.assert_allclose(_f32(masked[:, 0]), mean, atol=1e-5)


@pytest.mark.parametrize("Sq,Sk", [(16, 16), (8, 40)])
def test_plain_paths_agree(Sq, Sk):
    """dense_attention, chunked_attention and the kernel's plain version give
    the same result on a decode-style call."""
    (_, _, _), (tq, tk, tv) = _qkv(13, (2, Sq, 4, 32), "float32", sk=Sk)
    off, kv_len = torch.tensor([3, Sk - Sq]), torch.tensor([3 + Sq, Sk])
    dense = t_attn.dense_attention(tq, tk, tv, causal=True, q_offset=off, kv_len=kv_len)
    chunked = t_attn.chunked_attention(tq, tk, tv, causal=True, q_offset=off, kv_len=kv_len,
                                       chunk_q=4, chunk_kv=8)
    flash = t_attn._flash(tq, tk, tv, causal=True, q_offset=off, kv_len=kv_len)
    torch.testing.assert_close(chunked, dense, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(flash, dense, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------ rmsnorm

@pytest.mark.parametrize("shape", [(4, 64, 256), (2, 128, 512), (7, 384), (1, 1, 128),
                                   (3, 2048), (5, 4, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_rmsnorm_matches_pallas_kernel(shape, dtype):
    jd, td = DTYPES[dtype]
    x = _normal(20, shape, 3.0)
    scale = _normal(21, shape[-1:])
    ref = rmsnorm_pallas(jnp.asarray(x, jd), jnp.asarray(scale), interpret=True)
    out = rms_ops.rmsnorm(torch.from_numpy(x).to(td), torch.from_numpy(scale))
    assert out.dtype == td
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=tol, rtol=tol)


# ------------------------------------------------------------ wrapper rules

def test_cpu_route_takes_plain_version_without_counting():
    before = (flash_ops.flash_attention_fwd.launches, rms_ops.rmsnorm.launches)
    x = torch.randn(2, 3, 64)
    rms_ops.rmsnorm(x, torch.ones(64))
    q = torch.randn(1, 4, 2, 32)
    flash_ops.flash_attention_fwd(q, q, q)
    assert (flash_ops.flash_attention_fwd.launches, rms_ops.rmsnorm.launches) == before


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """Only a CPU tensor takes the plain version: any other device must
    launch the kernel or raise — never fall back quietly.  A ``meta``
    tensor, which holds no data, takes the kernel's fake path (the dry
    run's: ``kernels/_fake.py``): the kernel's outputs on ``meta``, one
    kernel event, no launch counted, never the plain version."""
    from repro_torch.kernels import _fake

    events = []
    counts = (rms_ops.rmsnorm.launches, flash_ops.flash_attention_fwd.launches)
    x = torch.empty(2, 64, device="meta")
    q = torch.empty(1, 4, 2, 32, device="meta")
    with _fake.listen(events.append):
        out = rms_ops.rmsnorm(x, torch.empty(64, device="meta"))
        o = flash_ops.flash_attention_fwd(q, q, q)
    assert out.device.type == "meta" and o.device.type == "meta"
    assert [e.name for e in events] == ["rmsnorm", "flash_attention_fwd"]
    assert (rms_ops.rmsnorm.launches, flash_ops.flash_attention_fwd.launches) == counts
    with pytest.raises(ValueError):          # mixed devices
        rms_ops.rmsnorm(torch.ones(2, 64), torch.empty(64, device="meta"))


def test_gqa_expansion_matches_kv_expand_index():
    k = torch.randn(2, 5, 2, 8)
    q = torch.randn(2, 5, 8, 8)
    _, ke, _ = t_attn.expand_and_pad(q, k, k)
    idx = torch.from_numpy(t_attn._kv_expand_index(8, 2, 8))
    torch.testing.assert_close(ke, k.index_select(2, idx), atol=0, rtol=0)
    np.testing.assert_array_equal(t_attn._kv_expand_index(8, 2, 8),
                                  jax_attn._kv_expand_index(8, 2, 8))
