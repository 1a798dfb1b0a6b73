"""The port's Mamba2 serving slice on the CPU against the JAX package, on the
same weights (JAX ``model.init`` -> numpy, zero and one inits perturbed ->
``params_from_jax``) and the same numpy tokens, reduced mamba2-2.7b:

* the parameter tree, the full-width parameter count;
* ``forward_train`` logits, ``forward_prefill`` logits and all four caches,
  and three ``forward_decode`` steps in fp32 at 1e-4;
* prefill + one decode step equals the full pass, for prompts of 1 and 2
  tokens too (the JAX model cannot decode after them: its conv buffer keeps
  fewer than W-1 rows);
* the scan fed bf16 x/B/C (no fp32 casts around it) gives bitwise the
  block output of the old cast sequence, and the bf16 prefill matches JAX's;
* ``step_engine(...).greedy_generate`` in fp32 against a JAX greedy loop;
* the step engine's paged route against its reference loop on dense
  llama3.2-1b, and its plan against the JAX ``single_device_plan``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs.registry import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.common import count_params as jax_count_params
from repro_torch import serving
from repro_torch.configs.registry import get_config
from repro_torch.models import build_model
from repro_torch.models.common import count_params, params_from_jax, tree_paths
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import mamba2 as t_mamba2
from repro_torch.models.common import cast_tree, take_layer
from repro_torch.models.mamba2 import Mamba2LM

ARCH = "mamba2-2.7b"
TOL32 = 1e-4
CACHE_KEYS = ("conv_x", "conv_B", "conv_C", "ssm")


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


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm, tm = jax_build_model(jcfg), build_model(tcfg, device="cpu")
    np_params = _perturbed(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                           np.random.default_rng(0))
    return dict(cfg=tcfg, jm=jm, tm=tm, np=np_params,
                jp=jax.tree.map(jnp.asarray, np_params),
                tp=params_from_jax(np_params, "cpu", torch.float32))


def _close(a, b, tol=TOL32):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=tol, rtol=tol)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape, dtype=np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


# ------------------------------------------------------------- parameters

def test_param_tree_matches_jax(pair):
    jdefs = dict(tree_paths(pair["jm"].param_defs()))
    tdefs = dict(tree_paths(pair["tm"].param_defs()))
    assert jdefs.keys() == tdefs.keys()
    for path, d in tdefs.items():
        j = jdefs[path]
        assert (d.shape, d.init, d.scale, d.logical_axes) == \
            (j.shape, j.init, j.scale, j.logical_axes), path
    for path, t in tree_paths(pair["tp"]):
        assert tuple(t.shape) == jdefs[path].shape, path


def test_init_zeros_and_ones_match_jax(pair):
    jp = dict(tree_paths(jax.tree.map(np.asarray, pair["jm"].init(jax.random.PRNGKey(1)))))
    tp = dict(tree_paths(pair["tm"].init(torch.Generator().manual_seed(1))))
    for path, d in tree_paths(pair["tm"].param_defs()):
        assert tp[path].dtype == torch.float32 and tuple(tp[path].shape) == jp[path].shape
        if d.init in ("zeros", "ones"):
            np.testing.assert_array_equal(tp[path].numpy(), jp[path])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_init_cache_dtypes_and_shapes_match_jax(pair, dtype):
    """Conv buffers bf16 and the SSD state fp32, whatever dtype is asked
    for, as the JAX model makes them."""
    jc = pair["jm"].init_cache(3, 64, dtype=jnp.float32 if dtype == torch.float32 else
                               jnp.bfloat16)
    tc = pair["tm"].init_cache(3, 64, dtype=dtype)
    assert tc.keys() == jc.keys() == set(CACHE_KEYS)
    for k in CACHE_KEYS:
        assert tuple(tc[k].shape) == jc[k].shape, k
        assert str(tc[k].dtype).replace("torch.", "") == str(jc[k].dtype), k
        assert float(tc[k].float().abs().sum()) == 0.0


def test_full_width_param_count_matches_jax():
    n = count_params(build_model(get_config(ARCH), device="cpu").param_defs())
    assert n == jax_count_params(jax_build_model(jax_get_config(ARCH)).param_defs())
    assert n == 2_830_951_936


# ------------------------------------------------------------- forward passes

def test_forward_train_logits_match_jax(pair):
    toks = _tokens(1, (2, 20), pair["cfg"].vocab_size)
    jl, _ = pair["jm"].forward_train(pair["jp"], jnp.asarray(toks), dtype=jnp.float32)
    tl, aux = pair["tm"].forward_train(pair["tp"], _t(toks), dtype=torch.float32)
    assert tl.shape == jl.shape and float(aux) == 0.0
    _close(tl, jl)


def test_prefill_logits_and_caches_match_jax(pair):
    toks = _tokens(2, (2, 13), pair["cfg"].vocab_size)
    jl, jc = pair["jm"].forward_prefill(pair["jp"], jnp.asarray(toks), max_len=32,
                                        dtype=jnp.float32)
    tl, tc = pair["tm"].forward_prefill(pair["tp"], _t(toks), max_len=32, dtype=torch.float32)
    assert tl.shape == jl.shape and tc.keys() == jc.keys() == set(CACHE_KEYS)
    _close(tl, jl)
    for k in CACHE_KEYS:
        assert tuple(tc[k].shape) == jc[k].shape, k
        _close(tc[k], jc[k])


def test_three_decode_steps_match_jax(pair):
    """Three ``forward_decode`` steps from JAX's prefill cache: logits and
    every cache at each step (the port writes the cache in place)."""
    cfg = pair["cfg"]
    S = 9
    toks = _tokens(3, (2, S + 3), cfg.vocab_size)
    _, jc = pair["jm"].forward_prefill(pair["jp"], jnp.asarray(toks[:, :S]), dtype=jnp.float32)
    tc = {k: torch.tensor(np.asarray(v)) for k, v in jc.items()}
    for i in range(3):
        step = toks[:, S + i:S + i + 1]
        jl, jc = pair["jm"].forward_decode(pair["jp"], jnp.asarray(step), jc, S + i,
                                           dtype=jnp.float32)
        tl, tc = pair["tm"].forward_decode(pair["tp"], _t(step), tc, S + i,
                                           dtype=torch.float32)
        _close(tl, jl)
        for k in CACHE_KEYS:
            _close(tc[k], jc[k])


def test_kernel_and_ref_impl_agree_on_cpu(pair):
    """On CPU tensors ``impl="kernel"`` takes the kernels' plain versions: the
    same logits as the ``impl="ref"`` model."""
    toks = _t(_tokens(4, (2, 70), pair["cfg"].vocab_size))
    ref = build_model(pair["cfg"], impl="ref", device="cpu")
    a, _ = pair["tm"].forward_train(pair["tp"], toks, dtype=torch.float32)
    b, _ = ref.forward_train(pair["tp"], toks, dtype=torch.float32)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("prompt_len", [1, 2, 3, 11])
def test_prefill_then_decode_equals_full_pass(pair, prompt_len):
    """Prefill ``prompt_len`` tokens, decode one: the logits of the full pass
    over ``prompt_len + 1`` tokens (fp32; the check of
    ``tests/test_arch_smoke.py``).  Prompts shorter than W-1 = 3 get conv
    buffers left-padded with zeros."""
    toks = _t(_tokens(5, (2, prompt_len + 1), pair["cfg"].vocab_size))
    tm, tp = pair["tm"], pair["tp"]
    full, _ = tm.forward_train(tp, toks, dtype=torch.float32)
    lp, cache = tm.forward_prefill(tp, toks[:, :-1], dtype=torch.float32)
    assert cache["conv_x"].shape[2] == pair["cfg"].conv_width - 1
    ld, _ = tm.forward_decode(tp, toks[:, -1:], cache, prompt_len, dtype=torch.float32)
    _close(lp[:, 0], full[:, -2].numpy())
    _close(ld[:, 0], full[:, -1].numpy())


@pytest.mark.parametrize("impl", ["kernel", "ref"])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_bf16_scan_without_casts_is_bitwise_the_old_sequence(pair, monkeypatch, impl, mode):
    """The block hands the scan bf16 x/B/C and takes its bf16 y.  The old
    sequence (``ssd(x.float(), .., B.float(), C.float())`` then
    ``y.to(bf16)``) gives bitwise the same block output and final state on
    the plain route: a bf16 -> fp32 cast is exact and both round y once."""
    cfg = pair["cfg"]
    layer = take_layer(cast_tree(pair["tp"], torch.bfloat16)["blocks"], 0)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 70, cfg.d_model)).astype(np.float32)).bfloat16()
    new, new_state = t_mamba2.mamba_block_apply(layer, x, cfg, mode=mode, impl=impl)
    scan = ssd_ops.ssd
    seen = []

    def old_sequence(xh, dt, A, Bm, Cm, impl):
        seen.append((xh.dtype, Bm.dtype, Cm.dtype))
        y, final = scan(xh.float(), dt, A, Bm.float(), Cm.float(), impl=impl)
        return y.to(xh.dtype), final

    monkeypatch.setattr(ssd_ops, "ssd", old_sequence)
    old, old_state = t_mamba2.mamba_block_apply(layer, x, cfg, mode=mode, impl=impl)
    assert seen == [(torch.bfloat16,) * 3]
    assert new.dtype == torch.bfloat16 and torch.equal(new, old)
    if mode == "prefill":
        assert torch.equal(new_state["ssm"], old_state["ssm"])


def test_bf16_prefill_logits_match_jax(pair):
    """``forward_prefill`` in bf16 (fp32 master weights cast per block, as
    in JAX) against JAX's bf16 ``forward_prefill``: within 3e-2 of the logit
    scale, the bf16 bound the K1 tests use — the two frameworks round the
    bf16 matmuls, conv and norms at different places, and the scan now
    takes bf16 inputs where JAX casts them to fp32 first (exact)."""
    toks = _tokens(9, (2, 77), pair["cfg"].vocab_size)
    jl, jc = pair["jm"].forward_prefill(pair["jp"], jnp.asarray(toks), dtype=jnp.bfloat16)
    tl, tc = pair["tm"].forward_prefill(pair["tp"], _t(toks), dtype=torch.bfloat16)
    jl = np.asarray(jl, np.float32)
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    assert tc["ssm"].dtype == torch.float32 and tc["conv_x"].dtype == torch.bfloat16
    scale = float(np.abs(jl).max())
    assert float(np.abs(tl.numpy() - jl).max()) <= 3e-2 * scale
    for k in CACHE_KEYS:
        ref = np.asarray(jc[k], np.float32)
        assert float(np.abs(tc[k].float().numpy() - ref).max()) <= 3e-2 * max(
            1.0, float(np.abs(ref).max())), k


# ------------------------------------------------------------- the step engine

def _jax_greedy(jm, jp, prompts, max_new):
    decode = jax.jit(lambda p, t, c, ci: jm.forward_decode(p, t, c, ci, dtype=jnp.float32))
    logits, cache = jm.forward_prefill(jp, jnp.asarray(prompts), dtype=jnp.float32)
    out = [np.asarray(jnp.argmax(logits[:, -1], axis=-1))]
    S = prompts.shape[1]
    for i in range(max_new - 1):
        logits, cache = decode(jp, jnp.asarray(out[-1][:, None]), cache, jnp.int32(S + i))
        out.append(np.asarray(jnp.argmax(logits[:, -1], axis=-1)))
    return np.stack(out, axis=1)


def test_step_engine_greedy_matches_jax_greedy_loop(pair):
    cfg = pair["cfg"]
    prompts = _tokens(6, (3, 12), cfg.vocab_size)
    engine = serving.step_engine(pair["tm"], serving.single_device_plan(cfg),
                                 dtype=torch.float32, device="cpu")
    out = engine.greedy_generate(pair["tp"], prompts, max_new=7, max_len=32)
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
    out = engine.greedy_generate(pair["tp"], prompts, max_new=4, max_len=16)
    seq = _t(prompts)
    for _ in range(4):
        logits, _ = pair["tm"].forward_train(pair["tp"], seq, dtype=torch.float32)
        seq = torch.cat([seq, logits[:, -1].argmax(-1, keepdim=True)], dim=1)
    np.testing.assert_array_equal(out.numpy(), seq[:, prompt_len:].numpy())


def test_single_device_plan_matches_jax():
    for arch in (ARCH, "llama3.2-1b"):
        jplan = jserving.single_device_plan(jax_get_config(arch))
        assert serving.single_device_plan(get_config(arch)).to_json() == jplan.to_json()


def test_dense_engine_paged_route_matches_reference_loop():
    """``greedy_generate`` routes dense llama3.2-1b through the paged
    scheduler; it equals ``greedy_generate_reference`` (the port of
    ``tests/test_serving.py::test_paged_greedy_generate_matches_reference``)."""
    cfg = get_config("llama3.2-1b").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(13))
    engine = serving.step_engine(model, serving.single_device_plan(cfg), batch=2,
                                 max_len=16, dtype=torch.float32, device="cpu")
    prompts = _tokens(13, (2, 4), cfg.vocab_size)
    fast = engine.greedy_generate(params, prompts, max_new=6, max_len=16)
    slow = engine.greedy_generate_reference(params, prompts, 6, 16)
    assert fast.shape == (2, 6)
    np.testing.assert_array_equal(fast.numpy(), slow.numpy())


def test_step_engine_rejects_a_mesh_and_a_foreign_device(pair):
    plan = serving.single_device_plan(pair["cfg"])
    with pytest.raises(NotImplementedError, match="mesh"):
        serving.step_engine(pair["tm"], plan, mesh=object(), device="cpu")
    meta = Mamba2LM(pair["cfg"], device="meta")
    with pytest.raises(ValueError, match="step_engine"):
        serving.step_engine(meta, plan, device="cpu")
    unknown = dataclasses.replace(get_config("internvl2-26b").reduced(), family="speech")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(unknown, device="cpu")
