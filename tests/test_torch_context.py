"""The port's context parallelism (``repro_torch.parallel.context``) in one
process, against JAX's ``repro.parallel.context`` on the same seeded numpy
inputs, at JAX's own tolerances (tests/test_context_parallel.py: values
3e-5, grads 3e-4, fp32):

* ``validate_cp``, ``zigzag_permutation`` and ``inverse_permutation``
  equal JAX's for several (S, cp), and the same odd remainders are
  refused; ``zigzag_shard`` / ``zigzag_positions`` are the permutation's
  per-rank blocks;
* ``merge_partials`` against JAX's;
* the serial positional ring on compact K/V against JAX's
  ``ring_attention(mesh=None, cp=...)`` on heads expanded with
  ``np.repeat``, values and grads (JAX's dk / dv summed over each KV
  head's query heads), for cp 1, 2 and 4, causal and not, with GQA;
* every rank's half-block ring on K1's partials (its plain version on CPU
  tensors, with positions and residuals), run in one process
  (``use_flash=True``), against the positional ring, values and the grads
  of its hand-written backward, and its forward against JAX's
  ``_serial_flash_ring`` (``use_flash=True``, Pallas in interpret mode);
* attention under a ring context refuses a shard that is not S / cp of a
  sequence splitting into 2·cp chunks, and any mode but train.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import context as jctx
from repro_torch.parallel import context as tctx

ATOL = 3e-5
GRAD_ATOL = 3e-4


def _qkv(seed, B=2, S=64, H=4, KV=2, hd=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    g = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    return q, k, v, g


def _expand(a, H):
    return np.repeat(a, H // a.shape[2], axis=2)


def _fold(grad, KV):
    """A grad on expanded heads -> the compact heads' (summed per group)."""
    B, S, H, hd = grad.shape
    return grad.reshape(B, S, KV, H // KV, hd).sum(3)


@pytest.mark.parametrize("S,cp", [(8, 1), (16, 2), (64, 4), (96, 3), (256, 8)])
def test_layout_equals_jaxs(S, cp):
    perm = tctx.zigzag_permutation(S, cp)
    np.testing.assert_array_equal(perm, jctx.zigzag_permutation(S, cp))
    np.testing.assert_array_equal(tctx.inverse_permutation(perm),
                                  jctx.inverse_permutation(perm))
    x = torch.arange(S).reshape(1, S)
    n = S // cp
    for r in range(cp):
        np.testing.assert_array_equal(tctx.zigzag_shard(x, 1, r, cp)[0].numpy(),
                                      perm[r * n:(r + 1) * n])
        pos = tctx.zigzag_positions(S, cp, r)
        assert pos.dtype == torch.int32
        np.testing.assert_array_equal(pos.numpy(), perm[r * n:(r + 1) * n])


@pytest.mark.parametrize("S,cp", [(60, 4), (100, 4), (64, 0), (6, 2)])
def test_odd_remainders_refused_as_jax_refuses_them(S, cp):
    with pytest.raises(ValueError):
        jctx.validate_cp(S, cp)
    with pytest.raises(ValueError):
        tctx.validate_cp(S, cp)
    if cp >= 1:
        with pytest.raises(ValueError):
            tctx.zigzag_shard(torch.zeros(1, S), 1, 0, cp)


def test_merge_partials_matches_jaxs():
    rng = np.random.default_rng(3)
    o1, o2 = (rng.standard_normal((2, 3, 5, 8)).astype(np.float32) for _ in range(2))
    m1, m2 = (rng.standard_normal((2, 3, 5)).astype(np.float32) * 4 for _ in range(2))
    l1, l2 = (rng.uniform(0.5, 9.0, (2, 3, 5)).astype(np.float32) for _ in range(2))
    m2[0, 0, 0] = tctx.NEG_INF                  # a hidden block weighs exactly 0
    want = jctx.merge_partials(*(jnp.asarray(a) for a in (o1, m1, l1, o2, m2, l2)))
    got = tctx.merge_partials(*(torch.from_numpy(a) for a in (o1, m1, l1, o2, m2, l2)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def _port(q, k, v, g, **kw):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tctx.ring_attention(qt, kt, vt, **kw)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (qt, kt, vt))
    return out.detach().numpy(), [x.numpy() for x in grads]


@pytest.mark.parametrize("cp", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_serial_ring_matches_jax_mesh_none(cp, causal):
    q, k, v, g = _qkv(cp + 10 * causal)
    H, KV = q.shape[2], k.shape[2]

    def jloss(q_, k_, v_):
        return jnp.sum(jctx.ring_attention(q_, k_, v_, causal=causal, cp=cp) * g)

    jq, jk, jv = jnp.asarray(q), jnp.asarray(_expand(k, H)), jnp.asarray(_expand(v, H))
    want = jctx.ring_attention(jq, jk, jv, causal=causal, cp=cp)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    out, grads = _port(q, k, v, g, causal=causal, cp=cp)
    np.testing.assert_allclose(out, np.asarray(want), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(grads[0], np.asarray(jgrads[0]), atol=GRAD_ATOL, rtol=GRAD_ATOL)
    for got, ref in zip(grads[1:], jgrads[1:]):
        np.testing.assert_allclose(got, _fold(np.asarray(ref), KV), atol=GRAD_ATOL,
                                   rtol=GRAD_ATOL)


@pytest.mark.parametrize("cp", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_half_block_ring_matches_the_positional_ring(cp, causal):
    """Every rank's half-block ring in one process: its steps skip what the
    masks hide, and its backward goes round the ring again from the final
    log-sum-exp."""
    q, k, v, g = _qkv(20 + cp + 10 * causal)
    want, want_grads = _port(q, k, v, g, causal=causal, cp=cp)
    out, grads = _port(q, k, v, g, causal=causal, cp=cp, use_flash=True)
    np.testing.assert_allclose(out, want, atol=ATOL, rtol=ATOL)
    for got, ref in zip(grads, want_grads):
        np.testing.assert_allclose(got, ref, atol=GRAD_ATOL, rtol=GRAD_ATOL)


def test_kernel_partials_match_jaxs_serial_flash_ring():
    """The kernel-partial merge path (K1's plain version on CPU tensors:
    positions at step 0, residuals at every step) against JAX's Pallas
    partials in interpret mode, forward only, at JAX's 1e-4."""
    q, k, v, _ = _qkv(5, B=1, S=128, H=4, KV=2, hd=32)
    for causal in (True, False):
        want = jctx.ring_attention(jnp.asarray(q), jnp.asarray(_expand(k, 4)),
                                   jnp.asarray(_expand(v, 4)), causal=causal, cp=4,
                                   use_flash=True, interpret=True)
        got = tctx.ring_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                                  cp=4, use_flash=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_attention_refuses_what_the_ring_cannot_run(monkeypatch):
    """Under a ring context: a shard that is not S / cp of the microbatch,
    a microbatch that does not split into 2·cp chunks, and any mode but
    train raise before any rank communicates."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import attention
    from repro_torch.models import build_model
    from repro_torch.parallel.axes import RingContext

    cfg = get_config("llama3.2-1b").reduced()
    model = build_model(cfg, device="cpu")
    params = {k: v[0] for k, v in model.init(torch.Generator().manual_seed(0))["blocks"]
              ["attn"].items()}
    ring = RingContext(group=None, hop=None, index=0, cp=2, seq_len=64)
    for bad, Sq, mode, kind, words in (
            (dataclasses.replace(ring, seq_len=62), 31, "train", ValueError,
             "seq_len % (2*cp) == 0"),
            (dataclasses.replace(ring, seq_len=128), 32, "train", ValueError, "not 1/2 of"),
            (ring, 32, "prefill", NotImplementedError, "not 'prefill'")):
        monkeypatch.setattr(attention, "ring_context", lambda bad=bad: bad)
        with pytest.raises(kind, match=re.escape(words)):
            attention.attention_block(params, torch.randn(1, Sq, cfg.d_model), cfg=cfg,
                                      mode=mode, impl="ref")
