"""The port's hybrid family (zamba2: Mamba2 layers plus one weight-shared
attention block per ``attn_every`` layers) on the CPU against the JAX
package's ``HybridLM`` (``impl="ref"``), on the same weights (JAX init ->
numpy, zero and one inits perturbed -> ``params_from_jax``) and the same
numpy tokens.  Three reduced zamba2-7b configs:

* ``reduced()``: 6 layers, ``attn_every`` 2 -> 3 sites, no trailing layer;
* ``layers7``: 7 layers -> 3 sites and 1 trailing Mamba layer;
* ``hd112``: the same with head_dim 112 (the full model's).

Checked: the parameter tree and the full-width parameter count (the shared
block counted once), ``init_cache``, fp32 train logits, prefill logits and
every cache (each site's K/V padded to ``max_len``), three decode steps,
prefill + decode against the full pass (prompts of 1 and 2 tokens too),
greedy tokens of the step engine against a JAX greedy loop, bf16 prefill,
and ``impl="kernel"`` against ``impl="ref"`` on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.common import count_params as jax_count_params
from repro_torch import serving
from repro_torch.configs.registry import get_config
from repro_torch.models import build_model
from repro_torch.models.common import count_params, params_from_jax, tree_paths
from repro_torch.models.hybrid import HybridLM

ARCH = "zamba2-7b"
TOL32 = 1e-4
MAMBA_KEYS = ("conv_x", "conv_B", "conv_C", "ssm")
CONFIGS = {
    "reduced": {},
    "layers7": {"num_layers": 7},
    "hd112": {"num_layers": 7, "head_dim": 112},
}


def _perturbed(tree, rng):
    """Numpy param tree with the zero/one inits of a fresh init (A_log,
    dt_bias, D and the norm scales) perturbed, so those paths are compared."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturbed(v, rng)
        elif k in ("A_log", "dt_bias"):
            out[k] = (v + 0.3 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k in ("D", "scale"):
            out[k] = (v * (1 + 0.1 * rng.standard_normal(v.shape))).astype(np.float32)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    kw = CONFIGS[request.param]
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), **kw)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm, tm = jax_build_model(jcfg), build_model(tcfg, device="cpu")
    np_params = _perturbed(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                           np.random.default_rng(0))
    return dict(name=request.param, cfg=tcfg, jm=jm, tm=tm,
                jp=jax.tree.map(jnp.asarray, np_params),
                tp=params_from_jax(np_params, "cpu", torch.float32))


def _close(a, b, tol=TOL32):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=tol, rtol=tol)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape, dtype=np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _cache_leaves(cache):
    """(path, leaf) of a hybrid cache {"mamba": {...}, "attn": {"k","v"}}."""
    return [(("mamba", k), cache["mamba"][k]) for k in MAMBA_KEYS] + \
        [(("attn", k), cache["attn"][k]) for k in ("k", "v")]


def _close_caches(tc, jc, tol=TOL32):
    assert tc.keys() == jc.keys() == {"mamba", "attn"}
    assert tc["mamba"].keys() == jc["mamba"].keys() == set(MAMBA_KEYS)
    assert tc["attn"].keys() == jc["attn"].keys() == {"k", "v"}
    for (path, t), (_, j) in zip(_cache_leaves(tc), _cache_leaves(jc)):
        assert tuple(t.shape) == j.shape, path
        _close(t, j, tol)


# ------------------------------------------------------------- structure

def test_sites_and_param_tree_match_jax(pair):
    """Sites, covered and trailing layers as JAX counts them; the parameter
    tree (``shared_attn`` stored once, beside the stacked Mamba blocks) with
    JAX's keys, shapes, inits and axes."""
    jm, tm = pair["jm"], pair["tm"]
    assert (tm.n_apps, tm.covered, tm.remainder) == (jm.n_apps, jm.covered, jm.remainder)
    assert tm.remainder == (0 if pair["name"] == "reduced" else 1)
    sites = [tm._site(layer) for layer in range(pair["cfg"].num_layers)]
    every = pair["cfg"].attn_every
    assert [s for s in sites if s is not None] == list(range(tm.n_apps))
    assert [i for i, s in enumerate(sites) if s is not None] == \
        [every * (s + 1) - 1 for s in range(tm.n_apps)]
    jdefs = dict(tree_paths(jm.param_defs()))
    tdefs = dict(tree_paths(tm.param_defs()))
    assert jdefs.keys() == tdefs.keys()
    assert {p[1] for p in tdefs if p[0] == "shared_attn"} == {"ln1", "attn", "ln2", "mlp"}
    for path, d in tdefs.items():
        j = jdefs[path]
        assert (d.shape, d.init, d.scale, d.logical_axes) == \
            (j.shape, j.init, j.scale, j.logical_axes), path
    for path, t in tree_paths(pair["tp"]):
        assert tuple(t.shape) == jdefs[path].shape, path


def test_full_width_param_count_matches_jax():
    """zamba2-7b at full width: the port's count is JAX's, with the shared
    block counted once (81 Mamba layers + one attention/SwiGLU block)."""
    cfg = get_config(ARCH)
    model = build_model(cfg, device="cpu")
    assert isinstance(model, HybridLM)
    assert (model.n_apps, model.covered, model.remainder) == (13, 78, 3)
    n = count_params(model.param_defs())
    assert n == jax_count_params(jax_build_model(jax_get_config(ARCH)).param_defs())
    shared = count_params(model.shared_block_defs())
    d, hd = cfg.d_model, cfg.resolved_head_dim
    assert shared == 2 * d + 4 * d * cfg.num_heads * hd + 3 * d * cfg.d_ff
    assert n == 6_787_740_240


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_init_cache_dtypes_and_shapes_match_jax(pair, dtype):
    """Conv buffers bf16 and the SSD state fp32 whatever dtype is asked for;
    one K/V cache per site in ``dtype``, as the JAX model makes them."""
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jc = pair["jm"].init_cache(3, 40, dtype=jdtype)
    tc = pair["tm"].init_cache(3, 40, dtype=dtype)
    assert tc["attn"]["k"].shape == (pair["tm"].n_apps, 3, 40, pair["cfg"].num_kv_heads,
                                     pair["cfg"].resolved_head_dim)
    for (path, t), (_, j) in zip(_cache_leaves(tc), _cache_leaves(jc)):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), path
        assert float(t.float().abs().sum()) == 0.0


# ------------------------------------------------------------- forward passes

def test_forward_train_logits_match_jax(pair):
    toks = _tokens(1, (2, 20), pair["cfg"].vocab_size)
    jl, jaux = pair["jm"].forward_train(pair["jp"], jnp.asarray(toks), dtype=jnp.float32)
    tl, aux = pair["tm"].forward_train(pair["tp"], _t(toks), dtype=torch.float32)
    assert tl.shape == jl.shape and float(aux) == float(jaux) == 0.0
    _close(tl, jl)


def test_prefill_logits_and_caches_match_jax(pair):
    """Last-position logits, every Mamba state and each site's K/V, padded
    with zeros to ``max_len`` in the compute dtype (fp32 here)."""
    S, max_len = 13, 32
    toks = _tokens(2, (2, S), pair["cfg"].vocab_size)
    jl, jc = pair["jm"].forward_prefill(pair["jp"], jnp.asarray(toks), max_len=max_len,
                                        dtype=jnp.float32)
    tl, tc = pair["tm"].forward_prefill(pair["tp"], _t(toks), max_len=max_len,
                                        dtype=torch.float32)
    assert tl.shape == jl.shape
    _close(tl, jl)
    _close_caches(tc, jc)
    assert tc["attn"]["k"].dtype == torch.float32
    assert float(tc["attn"]["v"][:, :, S:].abs().sum()) == 0.0


def test_three_decode_steps_match_jax(pair):
    """Three ``forward_decode`` steps from JAX's prefill cache: logits and
    every cache at each step (the port writes the cache in place)."""
    cfg = pair["cfg"]
    S = 9
    toks = _tokens(3, (2, S + 3), cfg.vocab_size)
    _, jc = pair["jm"].forward_prefill(pair["jp"], jnp.asarray(toks[:, :S]), max_len=S + 3,
                                       dtype=jnp.float32)
    tc = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jc)
    for i in range(3):
        step = toks[:, S + i:S + i + 1]
        jl, jc = pair["jm"].forward_decode(pair["jp"], jnp.asarray(step), jc, S + i,
                                           dtype=jnp.float32)
        tl, tc = pair["tm"].forward_decode(pair["tp"], _t(step), tc, S + i,
                                           dtype=torch.float32)
        _close(tl, jl)
        _close_caches(tc, jc)


@pytest.mark.parametrize("prompt_len", [1, 2, 3, 11])
def test_prefill_then_decode_equals_full_pass(pair, prompt_len):
    """Prefill ``prompt_len`` tokens, decode one: the logits of the full pass
    over ``prompt_len + 1`` tokens (fp32, 1e-3; the check of
    ``tests/test_arch_smoke.py``).  Prompts shorter than W-1 = 3 get conv
    buffers left-padded with zeros."""
    toks = _t(_tokens(5, (2, prompt_len + 1), pair["cfg"].vocab_size))
    tm, tp = pair["tm"], pair["tp"]
    full, _ = tm.forward_train(tp, toks, dtype=torch.float32)
    lp, cache = tm.forward_prefill(tp, toks[:, :-1], max_len=prompt_len + 1,
                                   dtype=torch.float32)
    ld, _ = tm.forward_decode(tp, toks[:, -1:], cache, prompt_len, dtype=torch.float32)
    _close(lp[:, 0], full[:, -2].numpy(), 1e-3)
    _close(ld[:, 0], full[:, -1].numpy(), 1e-3)


def test_bf16_prefill_logits_match_jax(pair):
    """bf16 ``forward_prefill``: the logits no further from JAX's fp32 logits
    than twice JAX's own bf16 logits are (the chip's parity rule: the two
    frameworks round the bf16 matmuls, conv and norms at different places,
    ~5 % of the logit scale through 6-7 layers here), the K/V kept bf16."""
    toks = jnp.asarray(_tokens(9, (2, 33), pair["cfg"].vocab_size))
    j16, _ = pair["jm"].forward_prefill(pair["jp"], toks, dtype=jnp.bfloat16)
    j32, _ = pair["jm"].forward_prefill(pair["jp"], toks, dtype=jnp.float32)
    tl, tc = pair["tm"].forward_prefill(pair["tp"], _t(toks), dtype=torch.bfloat16)
    j16, j32 = np.asarray(j16, np.float32), np.asarray(j32, np.float32)
    assert tl.dtype == torch.float32 and tl.shape == j32.shape
    assert tc["attn"]["k"].dtype == torch.bfloat16 and tc["mamba"]["ssm"].dtype == torch.float32
    assert float(np.abs(tl.numpy() - j32).max()) <= 2.0 * float(np.abs(j16 - j32).max())


def test_kernel_and_ref_impl_agree_on_cpu(pair):
    """On CPU tensors ``impl="kernel"`` takes the kernels' plain versions:
    the train logits and the prefill + decode logits of the ``impl="ref"``
    model."""
    cfg, tp = pair["cfg"], pair["tp"]
    toks = _t(_tokens(4, (2, 70), cfg.vocab_size))
    ref = build_model(cfg, impl="ref", device="cpu")
    a, _ = pair["tm"].forward_train(tp, toks, dtype=torch.float32)
    b, _ = ref.forward_train(tp, toks, dtype=torch.float32)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    outs = []
    for model in (pair["tm"], ref):
        _, cache = model.forward_prefill(tp, toks[:, :20], max_len=21, dtype=torch.float32)
        logits, _ = model.forward_decode(tp, toks[:, 20:21], cache, 20, dtype=torch.float32)
        outs.append(logits)
    torch.testing.assert_close(*outs, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------- the step engine

def _jax_greedy(jm, jp, prompts, max_new):
    S = prompts.shape[1]
    decode = jax.jit(lambda p, t, c, ci: jm.forward_decode(p, t, c, ci, dtype=jnp.float32))
    logits, cache = jm.forward_prefill(jp, jnp.asarray(prompts), max_len=S + max_new,
                                       dtype=jnp.float32)
    out = [np.asarray(jnp.argmax(logits[:, -1], axis=-1))]
    for i in range(max_new - 1):
        logits, cache = decode(jp, jnp.asarray(out[-1][:, None]), cache, jnp.int32(S + i))
        out.append(np.asarray(jnp.argmax(logits[:, -1], axis=-1)))
    return np.stack(out, axis=1)


def test_step_engine_greedy_matches_jax_greedy_loop(pair):
    cfg = pair["cfg"]
    prompts = _tokens(6, (3, 12), cfg.vocab_size)
    engine = serving.step_engine(pair["tm"], serving.single_device_plan(cfg),
                                 dtype=torch.float32, device="cpu")
    out = engine.greedy_generate(pair["tp"], prompts, max_new=7, max_len=19)
    assert out.dtype == torch.int32 and out.shape == (3, 7)
    np.testing.assert_array_equal(out.numpy(), _jax_greedy(pair["jm"], pair["jp"], prompts, 7))
    assert len(engine.latencies["prefill_s"]) == 1 and len(engine.latencies["decode_s"]) == 6


@pytest.mark.parametrize("prompt_len", [1, 2])
def test_step_engine_serves_prompts_shorter_than_the_conv(pair, prompt_len):
    """One- and two-token prompts (JAX fails at the first decode step) give
    the tokens of a greedy loop over the full pass."""
    cfg = pair["cfg"]
    prompts = _tokens(7, (2, prompt_len), cfg.vocab_size)
    engine = serving.step_engine(pair["tm"], serving.single_device_plan(cfg),
                                 dtype=torch.float32, device="cpu")
    out = engine.greedy_generate(pair["tp"], prompts, max_new=4, max_len=prompt_len + 4)
    seq = _t(prompts)
    for _ in range(4):
        logits, _ = pair["tm"].forward_train(pair["tp"], seq, dtype=torch.float32)
        seq = torch.cat([seq, logits[:, -1].argmax(-1, keepdim=True)], dim=1)
    np.testing.assert_array_equal(out.numpy(), seq[:, prompt_len:].numpy())
