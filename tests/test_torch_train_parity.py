"""The port's training forward and backward on the CPU against the JAX
package, on the same weights (JAX ``model.init`` -> numpy, norms and biases
perturbed -> ``params_from_jax``) and the same numpy batch:

* fp32 ``forward_train`` logits at 1e-4 (reduced llama3.2-1b, qwen2.5-3b
  with qkv bias, qwen3-14b with qk-norm, nemotron-4-15b with relu2);
* the fp32 loss (``softmax_xent`` with masked labels and z-loss, plus the
  aux weight) and every grad against ``jax.value_and_grad`` of JAX's own
  ``forward_train`` + ``softmax_xent``: 2e-3 (the JAX flash-VJP
  tolerance) of each grad's largest magnitude;
* the autograd ``flash_attention`` (CPU route: the plain forward, the
  block-by-block recompute backward) against JAX's ``flash_attention``
  custom VJP with the Pallas kernel in interpret mode, at g = 4, hd 64,
  S 256: 2e-3;
* ``chunked_attention_vjp`` with several query blocks, and the plain
  path's recomputed chunked attention beyond ``DENSE_MAX_SEQ``, against
  autograd of the dense math;
* K2's recomputing backward against ``jax.grad`` of JAX's ``_rmsnorm``:
  1e-5 fp32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.models import build_model as jax_build_model
from repro.models.norms import _rmsnorm as jax_rmsnorm
from repro.runtime import train as jtrain
from repro_torch.configs.registry import get_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models import attention as t_attn
from repro_torch.models import build_model
from repro_torch.models.common import params_from_jax, tree_paths
from repro_torch.runtime import train as ttrain
from tests._torch_params import perturbed

ARCHS = ["llama3.2-1b", "qwen2.5-3b", "qwen3-14b", "nemotron-4-15b"]
TOL32 = 1e-4
TOL_GRAD = 2e-3
B, S = 2, 24


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm, tm = jax_build_model(jcfg), build_model(tcfg, device="cpu")
    np_params = perturbed(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                           np.random.default_rng(0))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab_size, (B, S + 1), dtype=np.int32)
    labels = toks[:, 1:].copy()
    labels[1, :5] = -1                      # masked positions
    return dict(cfg=tcfg, jm=jm, tm=tm, np=np_params, tokens=toks[:, :-1], labels=labels,
                jp=jax.tree.map(jnp.asarray, np_params),
                tp=params_from_jax(np_params, "cpu", torch.float32))


def _close(a, b, tol):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=tol, rtol=tol)


def _close_to_scale(a, b, tol):
    """|a - b| <= tol · max |b|: a grad's error against its own scale (the
    reduced models' grads are ~1e-2, where a plain 2e-3 would say little)."""
    b = np.asarray(b, np.float32)
    err = np.abs(a.detach().float().numpy() - b).max()
    assert err <= tol * np.abs(b).max(), (err, np.abs(b).max())


def test_forward_train_logits_match_jax(pair):
    jl, jx = pair["jm"].forward_train(pair["jp"], jnp.asarray(pair["tokens"]),
                                      dtype=jnp.float32)
    tl, tx = pair["tm"].forward_train(pair["tp"], torch.from_numpy(pair["tokens"]).long(),
                                      dtype=torch.float32)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    assert float(tx) == float(jx) == 0.0
    _close(tl, jl, TOL32)


def test_loss_and_every_grad_match_jax_value_and_grad(pair):
    jm = pair["jm"]

    def jloss(p, tokens, labels):
        logits, extra = jm.forward_train(p, tokens, dtype=jnp.float32)
        loss, _ = jtrain.softmax_xent(logits, labels)
        return loss + jtrain.AUX_LOSS_WEIGHT * extra

    jl, jg = jax.jit(jax.value_and_grad(jloss))(pair["jp"], jnp.asarray(pair["tokens"]),
                                                jnp.asarray(pair["labels"]))
    live = {path: t.clone().requires_grad_() for path, t in tree_paths(pair["tp"])}
    params = {}
    for path, t in live.items():
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    logits, extra = pair["tm"].forward_train(params, torch.from_numpy(pair["tokens"]).long(),
                                             dtype=torch.float32)
    loss, metrics = ttrain.softmax_xent(logits, torch.from_numpy(pair["labels"]))
    loss = loss + ttrain.AUX_LOSS_WEIGHT * extra
    grads = torch.autograd.grad(loss, list(live.values()))
    assert float(metrics["tokens"]) == B * S - 5
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=TOL32)
    jgrads = dict(tree_paths(jax.tree.map(np.asarray, jg)))
    for path, g in zip(live, grads):
        assert g.dtype == torch.float32, path
        _close_to_scale(g, jgrads[path], TOL_GRAD)


def _qkv(seed, Bq, Sq, H, KV, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Bq, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((Bq, Sq, KV, hd)).astype(np.float32)
    v = rng.standard_normal((Bq, Sq, KV, hd)).astype(np.float32)
    g = rng.standard_normal((Bq, Sq, H, hd)).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_autograd_matches_jax_custom_vjp(causal):
    """g = 4 (8 query heads, 2 kv heads), hd 64, S 256.  JAX's custom VJP
    runs on repeated heads; its dk/dv are summed over each kv head's query
    heads to compare with the port's compact grads."""
    H, KV = 8, 2
    q, k, v, g = _qkv(0, 1, 256, H, KV, 64)
    rep = lambda a: jnp.asarray(np.repeat(a, H // KV, axis=2))
    jout, vjp = jax.vjp(lambda q_, k_, v_: jax_flash_attention(q_, k_, v_, causal),
                        jnp.asarray(q), rep(k), rep(v))
    jdq, jdk, jdv = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    group = lambda a: a.reshape(a.shape[:2] + (KV, H // KV) + a.shape[3:]).sum(axis=3)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_ops.flash_attention(tq, tk, tv, causal=causal)
    dq, dk, dv = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    _close(out, jout, TOL32)
    _close(dq, jdq, TOL_GRAD)
    _close(dk, group(jdk), TOL_GRAD)
    _close(dv, group(jdv), TOL_GRAD)
    assert flash_ops.flash_attention_fwd.launches == 0      # the CPU route launches nothing


@pytest.mark.parametrize("causal,KV,block_q,Sq", [
    (True, 2, 64, 200),       # ragged last block, compact heads
    (True, 8, 32, 96),        # expanded heads (KV == H)
    (False, 2, 48, 100),
])
def test_chunked_attention_vjp_by_blocks_matches_autograd(causal, KV, block_q, Sq):
    """Several query blocks (the backward's unit of recompute) give the
    grads of autograd through the dense math on expanded heads."""
    H = 8
    q, k, v, g = (torch.from_numpy(a) for a in _qkv(1, 2, Sq, H, KV, 32))
    dq, dk, dv = t_attn.chunked_attention_vjp(q, k, v, g, causal=causal, block_q=block_q)
    tq, tk, tv = (a.clone().requires_grad_() for a in (q, k, v))
    _, ke, ve = t_attn.expand_and_pad(tq, tk, tv)
    out = t_attn.dense_attention(tq, ke, ve, causal=causal)
    rq, rk, rv = torch.autograd.grad(out, (tq, tk, tv), g)
    for a, b in ((dq, rq), (dk, rk), (dv, rv)):
        assert a.dtype == b.dtype and a.shape == b.shape
        _close(a, b, 1e-5)


def test_plain_path_beyond_dense_max_seq_recomputes_chunked_attention():
    """``attention_math`` past ``DENSE_MAX_SEQ`` runs chunked attention whose
    backward recomputes block by block: its grads are dense autograd's."""
    Sq = t_attn.DENSE_MAX_SEQ + 64
    q, k, v, g = (torch.from_numpy(a) for a in _qkv(2, 1, Sq, 2, 2, 32))
    grads = []
    for fn in (t_attn.attention_math, t_attn.dense_attention):
        tq, tk, tv = (a.clone().requires_grad_() for a in (q, k, v))
        out = fn(tq, tk, tv, causal=True)
        grads.append(torch.autograd.grad(out, (tq, tk, tv), g))
    for a, b in zip(*grads):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("shape", [(4, 6, 128), (3, 32)])
def test_rmsnorm_backward_matches_jax_grad(shape):
    rng = np.random.default_rng(3)
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal(shape[-1:])).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    jdx, jds = jax.grad(lambda x_, s_: jnp.sum(jax_rmsnorm(s_, x_, 1e-5) * w), (0, 1))(
        jnp.asarray(x), jnp.asarray(scale))
    tx, ts = torch.from_numpy(x).requires_grad_(), torch.from_numpy(scale).requires_grad_()
    y = rms_ops.rmsnorm_autograd(tx, ts, 1e-5)
    dx, ds = torch.autograd.grad(y, (tx, ts), torch.from_numpy(w))
    assert dx.dtype == ds.dtype == torch.float32
    _close(dx, jdx, 1e-5)
    _close(ds, jds, 1e-5)
    assert rms_ops.rmsnorm.launches == 0


def test_rmsnorm_backward_bf16_input_gives_bf16_dx_and_fp32_dscale():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(64)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    xb = x.bfloat16().requires_grad_()
    s = scale.clone().requires_grad_()
    dx, ds = torch.autograd.grad(rms_ops.rmsnorm_autograd(xb, s), (xb, s), g.bfloat16())
    assert dx.dtype == torch.bfloat16 and ds.dtype == torch.float32
    xf = xb.detach().float().requires_grad_()
    s2 = scale.clone().requires_grad_()
    rdx, rds = torch.autograd.grad(rms_ops.rmsnorm_reference(xf, s2), (xf, s2),
                                   g.bfloat16().float())
    _close(dx, rdx, 2e-2)
    _close(ds, rds, 1e-4)


def test_rmsnorm_autograd_without_a_grad_to_take_calls_the_wrapper():
    """Serving runs under ``no_grad``: there ``rmsnorm_autograd`` is the
    plain wrapper call, with no autograd node; with a grad to take it is the
    autograd function.  Same values either way."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(32)).astype(np.float32))
    with torch.no_grad():
        y0 = rms_ops.rmsnorm_autograd(x, scale.requires_grad_())
    y1 = rms_ops.rmsnorm_autograd(x, scale.detach())
    y2 = rms_ops.rmsnorm_autograd(x, scale.requires_grad_())
    assert y0.grad_fn is None and y1.grad_fn is None
    assert type(y2.grad_fn).__name__ == "_RMSNormBackward"
    assert torch.equal(y0, y2.detach()) and torch.equal(y1, y0)
