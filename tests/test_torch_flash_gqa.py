"""K1 on compact GQA heads, on the CPU.

* The wrapper's plain route (``flash_ops.flash_attention_fwd`` on CPU
  tensors) takes k/v with KV < H heads; it is held against the JAX Pallas
  kernel in interpret mode fed with ``np.repeat``-expanded heads: g = H/KV in
  {1, 4, 5}, head_dim in {64, 112, 128}, causal, non-causal and (B, S)
  positions with residuals (fp32 1e-4, bf16 3e-2, residuals 1e-5 — the JAX
  kernel tests' tolerances).
* The kernel dispatch of the llama decode path, forced on CPU tensors (the
  compact heads and the positions ``forward_decode`` builds once reach the
  plain route), against the JAX model's decode logits at fp32 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.kernels.flash_attention.kernel import flash_attention_fwd as jax_flash
from repro.models import build_model as jax_build_model
from repro_torch.configs.registry import get_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention as t_attn
from repro_torch.models import build_model
from repro_torch.models.common import params_from_jax

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["causal", "noncausal", "positions"])
@pytest.mark.parametrize("hd", [64, 112, 128])
@pytest.mark.parametrize("g", [1, 4, 5])
def test_plain_flash_compact_heads_match_pallas_kernel(g, hd, mode, dtype):
    """Compact k/v through the wrapper's plain route against the Pallas
    kernel on the expanded heads; with (B, S) positions the (m, l)
    residuals are compared too."""
    B, Sq, Sk, KV = 2, 32, 64, 2
    H = g * KV
    rng = np.random.default_rng(100 * g + hd)
    q, k, v = _normal(rng, (B, Sq, H, hd)), _normal(rng, (B, Sk, KV, hd)), \
        _normal(rng, (B, Sk, KV, hd))
    jd, td = DTYPES[dtype]
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, np.repeat(k, g, axis=2),
                                               np.repeat(v, g, axis=2)))
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    kw_j, kw_t = dict(causal=mode != "noncausal"), dict(causal=mode != "noncausal")
    if mode == "positions":
        qp = np.stack([rng.permutation(Sq) * 2 for _ in range(B)]).astype(np.int32)
        kp = np.stack([rng.permutation(Sk) for _ in range(B)]).astype(np.int32)
        kw_j.update(q_pos=jnp.asarray(qp), k_pos=jnp.asarray(kp), return_residuals=True)
        kw_t.update(q_pos=torch.from_numpy(qp), k_pos=torch.from_numpy(kp),
                    return_residuals=True)
    ref = jax_flash(jq, jk, jv, interpret=True, **kw_j)
    out = flash_ops.flash_attention_fwd(tq, tk, tv, **kw_t)
    if mode == "positions":
        (out, m, l), (ref, rm, rl) = out, ref
        for a, b in ((m, rm), (l, rl)):
            np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-5, rtol=1e-5)
    assert out.dtype == td and out.shape == tq.shape
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=TOL[dtype], rtol=TOL[dtype])


def test_plain_flash_rejects_indivisible_heads():
    q = torch.zeros(1, 4, 6, 64)
    kv = torch.zeros(1, 4, 4, 64)
    with pytest.raises(ValueError):
        flash_ops.flash_attention_fwd(q, kv, kv)


@pytest.mark.parametrize("B,KV,rows,Sk", [
    (8, 8, 4, 1025),            # llama decode: 5 splits of 4 tiles
    (1, 8, 4, 8192),            # one long decode
    (4, 8, 4, 130),             # fewer tiles than the split target
    (2, 8, 4, 1),
    (1, 8, 1024, 1280),         # llama prefill chunk: no split
    (1, 1, 1, 64 * 300),        # past MAX_TILES tiles: split anyway
    (1, 8, 1024, 64 * 600),
])
def test_num_splits_obeys_the_kernel_limits(B, KV, rows, Sk):
    """The split count the wrapper passes is one the kernel's entry point
    accepts: every split walks at most MAX_TILES tiles and none is empty;
    only decode-sized calls split below MAX_TILES tiles."""
    tiles = -(-Sk // flash_ops.TILE_K)
    n = flash_ops.num_splits(B, KV, rows, Sk, 132)
    per = -(-tiles // n)
    assert 1 <= n <= tiles
    assert per <= flash_ops.MAX_TILES and -(-tiles // per) == n
    if rows > flash_ops.DECODE_ROWS and tiles <= flash_ops.MAX_TILES:
        assert n == 1
    if (B, KV, rows, Sk) == (8, 8, 4, 1025):
        assert n == 5


# ---------------------------------------------------------------- decode path

def _llama_pair(seed=0):
    jcfg, tcfg = jax_get_config("llama3.2-1b").reduced(), get_config("llama3.2-1b").reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.num_heads > tcfg.num_kv_heads                   # GQA
    jm = jax_build_model(jcfg)
    np_params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                             jm.init(jax.random.PRNGKey(seed)))
    return tcfg, jm, jax.tree.map(jnp.asarray, np_params), \
        params_from_jax(np_params, "cpu", torch.float32)


@pytest.fixture(scope="module")
def llama_pair():
    return _llama_pair()


@pytest.mark.parametrize("route", ["cpu", "kernel-dispatch"])
@pytest.mark.parametrize("step", ["decode", "chunk"])
def test_forward_decode_kernel_impl_matches_jax(llama_pair, monkeypatch, route, step):
    """Reduced llama3.2-1b ``forward_decode`` with ``impl="kernel"`` on CPU
    tensors against the JAX model's decode logits at fp32 1e-4: as it runs
    on the CPU (expand + dense_attention), and with the kernel dispatch
    forced, so the compact K/V and the positions built once per forward go
    through the kernel's plain route.  ``decode``: one token per slot at
    per-slot cache indices; ``chunk``: a 4-token chunk at a scalar index
    with per-slot valid lengths."""
    cfg, jm, jp, tp = llama_pair
    tm = build_model(cfg, impl="kernel", device="cpu")
    calls = []
    if route == "kernel-dispatch":
        monkeypatch.setattr(t_attn, "uses_kernel", lambda impl, x: impl == "kernel")
        real = t_attn.flash_positions
        monkeypatch.setattr(t_attn, "flash_positions",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        real_flash = flash_ops.flash_attention_fwd
        seen = []
        monkeypatch.setattr(flash_ops, "flash_attention_fwd",
                            lambda q, k, v, **kw: seen.append(k.shape) or real_flash(q, k, v, **kw))
    rng = np.random.default_rng(7)
    B, S, M = 3, 10, 24
    prompts = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    _, jc = jm.forward_prefill(jp, jnp.asarray(prompts), max_len=M, dtype=jnp.float32)
    cache_np = {k: np.asarray(v) for k, v in jc.items()}
    t_cache = {k: torch.tensor(v) for k, v in cache_np.items()}
    if step == "decode":
        ci = np.asarray([10, 7, 9], np.int32)
        tok = rng.integers(0, cfg.vocab_size, (B, 1), dtype=np.int32)
        tl, _ = tm.forward_decode(tp, torch.from_numpy(tok).long(), t_cache,
                                  torch.from_numpy(ci), kv_len=torch.from_numpy(ci + 1),
                                  dtype=torch.float32)
        for b in range(B):
            jl, _ = jm.forward_decode(jp, jnp.asarray(tok[b:b + 1]),
                                      {k: jnp.asarray(v[:, b:b + 1]) for k, v in cache_np.items()},
                                      int(ci[b]), kv_len=jnp.asarray(ci[b:b + 1] + 1),
                                      dtype=jnp.float32)
            np.testing.assert_allclose(_f32(tl[b:b + 1]), _f32(jl), atol=1e-4, rtol=1e-4)
    else:
        chunk = rng.integers(0, cfg.vocab_size, (B, 4), dtype=np.int32)
        kv_len = np.asarray([S + 4, S + 2, S + 1], np.int32)
        tl, _ = tm.forward_decode(tp, torch.from_numpy(chunk).long(), t_cache, S,
                                  kv_len=torch.from_numpy(kv_len), dtype=torch.float32)
        jl, _ = jm.forward_decode(jp, jnp.asarray(chunk),
                                  {k: jnp.asarray(v) for k, v in cache_np.items()}, S,
                                  kv_len=jnp.asarray(kv_len), dtype=jnp.float32)
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-4, rtol=1e-4)
    if route == "kernel-dispatch":
        assert len(calls) == 1                       # once per forward, not per layer
        assert len(seen) == cfg.num_layers
        assert all(s[2] == cfg.num_kv_heads for s in seen)     # compact heads
