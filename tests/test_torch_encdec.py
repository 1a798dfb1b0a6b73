"""The port's encoder-decoder family (``repro_torch.models.encdec``:
whisper-tiny) on the CPU against the JAX package's ``repro.models.encdec``
(jnp; the family reaches no Pallas kernel), on the same weights (JAX
``model.init`` -> numpy, norm scales perturbed -> ``params_from_jax``) and
the same numpy inputs.  Configs: whisper-tiny ``reduced()`` (32 frames) and
the same with 100 frames, not a multiple of 64.

Every check feeds non-zero frames from a numpy seed: with zero frames this
bias-free config's encoder outputs exactly 0 and compares nothing (only
``greedy_generate``, which passes no frames in either package, runs on
zeros).  Checked in fp32: ``encode`` and train logits (1e-4), prefill
logits and both caches, three decode steps, the engine's
``prefill_step(..., {"frames": f})`` + ``decode_step`` tokens, the loss and
every grad against ``jax.value_and_grad`` (2e-3 of each grad's scale), a
bf16 ``train_step`` with grad_accum 2, and the launcher on the CPU.  Also
the repaired ``chunked_attention`` (ceil(S / chunk) blocks, the last one
ragged) against JAX's ``dense_attention`` and its VJP.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core.strategy import LayerStrategy as JaxLayerStrategy
from repro.core.strategy import uniform_plan as jax_uniform_plan
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.runtime import train as jtrain
from repro.runtime.data import SyntheticDataset as JaxSyntheticDataset
from repro_torch import serving
from repro_torch.configs.registry import get_config
from repro_torch.core.strategy import LayerStrategy, uniform_plan
from repro_torch.launch import train as train_cli
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models.common import count_params, params_from_jax, tree_paths
from repro_torch.models.encdec import EncDecLM
from repro_torch.runtime import train as ttrain
from repro_torch.runtime.data import SyntheticDataset
from tests._torch_params import perturbed

TOL32 = 1e-4
TOL_GRAD = 2e-3
B, S = 2, 12
ARCH = "whisper-tiny"
CONFIGS = {"reduced": {}, "frames100": {"enc_frames": 100}}


def _configs(name):
    kw = CONFIGS[name]
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), **kw)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _frames(seed, cfg, batch=B):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.enc_frames, cfg.d_model)).astype(np.float32)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape, dtype=np.int32)


def _pair(name, impl="kernel"):
    jcfg, tcfg = _configs(name)
    jm = jax_build_model(jcfg)
    np_params = perturbed(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                          np.random.default_rng(0))
    toks = _tokens(1, (B, S + 1), tcfg.vocab_size)
    labels = toks[:, 1:].copy()
    labels[1, :3] = -1                      # masked positions
    return dict(name=name, jcfg=jcfg, cfg=tcfg, jm=jm,
                tm=build_model(tcfg, impl=impl, device="cpu"),
                tokens=toks[:, :-1], labels=labels, frames=_frames(2, tcfg),
                jp=jax.tree.map(jnp.asarray, np_params),
                tp=params_from_jax(np_params, "cpu", torch.float32))


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    return _pair(request.param)


def _close(a, b, tol):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=tol, rtol=tol)


def _close_to_scale(a, b, tol):
    """|a - b| <= tol · max |b|: a grad's error against its own scale."""
    b = np.asarray(b, np.float32)
    err = np.abs(a.detach().float().numpy() - b).max()
    assert err <= tol * np.abs(b).max(), (err, np.abs(b).max())


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


# ------------------------------------------------------------------ chunked attention

def _qkv(seed, Sq, Sk, H, KV, hd=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((2, Sk, KV, hd)).astype(np.float32),
            rng.standard_normal((2, Sk, KV, hd)).astype(np.float32))


def test_blocks_cover_the_range_with_a_ragged_last_block():
    assert tattn.blocks(150, 64) == [(0, 64), (64, 128), (128, 150)]
    assert tattn.blocks(1500, 1024) == [(0, 1024), (1024, 1500)]
    assert tattn.blocks(128, 64) == [(0, 64), (64, 128)]
    assert tattn.blocks(5, 64) == [(0, 5)]


@pytest.mark.parametrize("causal", [False, True])
def test_chunked_attention_walks_ragged_blocks_and_matches_jax_dense(monkeypatch, causal):
    """Sk 150 at chunk_kv 64 visits 3 key blocks (not 75 of 2); Sq 70 at
    chunk_q 32 visits 3 query blocks.  The forward matches JAX's
    ``dense_attention`` (1e-4) and the VJP ``jax.vjp`` of it (2e-3),
    causal at a q offset of Sk - Sq and non-causal."""
    Sq, Sk, H = 70, 150, 4
    q, k, v = _qkv(3, Sq, Sk, H, H)
    off = Sk - Sq if causal else 0
    g = np.random.default_rng(4).standard_normal((2, Sq, H, 16)).astype(np.float32)
    calls = []
    einsum = torch.einsum
    monkeypatch.setattr(torch, "einsum", lambda *a: calls.append(a[0]) or einsum(*a))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.chunked_attention(tq, tk, tv, causal=causal, q_offset=off, chunk_q=32,
                                  chunk_kv=64)
    assert len(calls) == 2 * 3 * 3           # two products per (query, key) block pair
    monkeypatch.undo()
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    jout, vjp = jax.vjp(lambda a, b, c: jattn.dense_attention(a, b, c, causal=causal,
                                                              q_offset=off), q, k, v)
    _close(out, jout, TOL32)
    for got, want in zip(grads, vjp(jnp.asarray(g))):
        _close_to_scale(got, want, TOL_GRAD)


@pytest.mark.parametrize("causal", [False, True])
def test_chunked_attention_vjp_on_compact_heads_matches_jax(causal):
    """``chunked_attention_vjp`` (K1's backward) on compact K/V (H 4 over
    KV 2) with Sq 40 != Sk 150 and 16-row query blocks: dq, and dk/dv
    summed over each kv head's query heads, against ``jax.vjp`` of
    ``dense_attention`` on the expanded heads (2e-3 of scale)."""
    Sq, Sk, H, KV = 40, 150, 4, 2
    q, k, v = _qkv(5, Sq, Sk, H, KV)
    g = np.random.default_rng(6).standard_normal((2, Sq, H, 16)).astype(np.float32)
    off = Sk - Sq if causal else 0
    dq, dk, dv = tattn.chunked_attention_vjp(
        *(torch.from_numpy(x) for x in (q, k, v, g)), causal=causal, q_offset=off, block_q=16)
    rep = lambda x: jnp.repeat(x, H // KV, axis=2)
    _, vjp = jax.vjp(lambda a, b, c: jattn.dense_attention(a, rep(b), rep(c), causal=causal,
                                                           q_offset=off), q, k, v)
    for got, want in zip((dq, dk, dv), vjp(jnp.asarray(g))):
        _close_to_scale(got, want, TOL_GRAD)


# ------------------------------------------------------------------ model structure

def test_param_tree_matches_jax(pair):
    jtree = dict(tree_paths(jax.tree.map(np.asarray, pair["jp"])))
    ttree = dict(tree_paths(pair["tp"]))
    assert set(jtree) == set(ttree)
    assert ("dec_blocks", "cross_attn", "wq") in ttree and ("enc_norm", "scale") in ttree
    for path, t in ttree.items():
        assert tuple(t.shape) == jtree[path].shape, path
    fresh = pair["tm"].init(torch.Generator().manual_seed(0))
    assert {p: tuple(t.shape) for p, t in tree_paths(fresh)} == \
        {p: tuple(t.shape) for p, t in ttree.items()}


def test_full_width_param_tree_is_jaxs_abstract():
    """Keys and shapes against JAX's ``abstract()`` at full width, nothing
    materialised (the port builds on ``meta``)."""
    model = build_model(get_config(ARCH), device="meta")
    assert isinstance(model, EncDecLM)
    assert model.supports_layer_grouping is False and model.text_offset() == 0
    jabs = dict(tree_paths(jax_build_model(jax_get_config(ARCH)).abstract()))
    tdefs = dict(tree_paths(model.param_defs()))
    assert jabs.keys() == tdefs.keys()
    for path, d in tdefs.items():
        assert d.shape == tuple(jabs[path].shape), path
    assert count_params(model.param_defs()) == sum(int(np.prod(a.shape))
                                                   for a in jabs.values())


def test_init_cache_matches_jax(pair):
    jc = pair["jm"].init_cache(3, 20, jnp.float32)
    tc = pair["tm"].init_cache(3, 20, torch.float32)
    for kind in ("self", "cross"):
        for name in ("k", "v"):
            assert tuple(tc[kind][name].shape) == jc[kind][name].shape, (kind, name)
            assert tc[kind][name].dtype == torch.float32 and not tc[kind][name].any()


def test_build_model_defaults_to_the_card():
    cfg = get_config(ARCH).reduced()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(cfg)
    model = build_model(cfg, device="cpu")
    assert isinstance(model, EncDecLM) and model.impl == "kernel"


def test_paged_serving_sends_whisper_to_the_step_engine():
    with pytest.raises(NotImplementedError, match="step_engine"):
        serving.build(serving.ServeConfig(arch=ARCH, device="cpu"))


def test_attention_block_rejects_an_unknown_mode(pair):
    lp = {k: v[0] for k, v in pair["tp"]["enc_blocks"]["attn"].items()}
    with pytest.raises(ValueError, match="mode"):
        tattn.attention_block(lp, torch.zeros((1, 4, pair["cfg"].d_model)), cfg=pair["cfg"],
                              mode="bidirectional")


# ------------------------------------------------------------------ forward passes

def test_encode_matches_jax(pair):
    f = pair["frames"]
    jout = pair["jm"].encode(pair["jp"], jnp.asarray(f))
    tout = pair["tm"].encode(pair["tp"], torch.from_numpy(f))
    assert tuple(tout.shape) == jout.shape
    assert np.abs(np.asarray(jout)).max() > 0.1
    _close(tout, jout, TOL32)


def test_forward_train_logits_match_jax(pair):
    f = pair["frames"]
    jl, jx = pair["jm"].forward_train(pair["jp"], jnp.asarray(pair["tokens"]),
                                      frames=jnp.asarray(f), dtype=jnp.float32)
    tl, tx = pair["tm"].forward_train(pair["tp"], _t(pair["tokens"]),
                                      frames=torch.from_numpy(f), dtype=torch.float32)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    assert float(tx) == float(jx) == 0.0
    _close(tl, jl, TOL32)


def test_frames_change_the_logits_and_none_means_zeros(pair):
    """The decoder reads the encoder: other frames give other logits, and
    ``frames=None`` is zeros, as in JAX."""
    tm, tp, toks = pair["tm"], pair["tp"], _t(pair["tokens"])
    f = torch.from_numpy(pair["frames"])
    a, _ = tm.forward_train(tp, toks, frames=f, dtype=torch.float32)
    b, _ = tm.forward_train(tp, toks, frames=2 * f, dtype=torch.float32)
    assert float((a - b).abs().max()) > 1e-3
    z, _ = tm.forward_train(tp, toks, frames=torch.zeros_like(f), dtype=torch.float32)
    n, _ = tm.forward_train(tp, toks, dtype=torch.float32)
    torch.testing.assert_close(n, z, atol=0, rtol=0)


def test_prefill_logits_and_caches_match_jax(pair):
    f = pair["frames"]
    jl, jc = pair["jm"].forward_prefill(pair["jp"], jnp.asarray(pair["tokens"]),
                                        frames=jnp.asarray(f), max_len=20, dtype=jnp.float32)
    tl, tc = pair["tm"].forward_prefill(pair["tp"], _t(pair["tokens"]),
                                        frames=torch.from_numpy(f), max_len=20,
                                        dtype=torch.float32)
    cfg = pair["cfg"]
    assert tl.shape == jl.shape
    assert tuple(tc["self"]["k"].shape) == (cfg.num_layers, B, 20, cfg.num_kv_heads,
                                            cfg.resolved_head_dim)
    assert tuple(tc["cross"]["v"].shape) == (cfg.num_layers, B, cfg.enc_frames,
                                             cfg.num_kv_heads, cfg.resolved_head_dim)
    _close(tl, jl, TOL32)
    for kind in ("self", "cross"):
        for name in ("k", "v"):
            _close(tc[kind][name], jc[kind][name], TOL32)


def test_decode_steps_match_jax(pair):
    """Three decode steps at a scalar cache_index after a prefill with frames."""
    cfg = pair["cfg"]
    prompts = _tokens(3, (B, 10), cfg.vocab_size)
    f = pair["frames"]
    _, jc = pair["jm"].forward_prefill(pair["jp"], jnp.asarray(prompts),
                                       frames=jnp.asarray(f), max_len=16, dtype=jnp.float32)
    tc = {kind: {n: torch.tensor(np.asarray(t)) for n, t in kv.items()}
          for kind, kv in jc.items()}
    tok = _tokens(4, (B, 1), cfg.vocab_size)
    for i in range(3):
        jl, jc = pair["jm"].forward_decode(pair["jp"], jnp.asarray(tok), jc, 10 + i,
                                           dtype=jnp.float32)
        tl, tc = pair["tm"].forward_decode(pair["tp"], _t(tok), tc, 10 + i,
                                           dtype=torch.float32)
        _close(tl, jl, TOL32)
        for kind in ("self", "cross"):
            for name in ("k", "v"):
                _close(tc[kind][name], jc[kind][name], TOL32)
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)


def _jax_greedy(jm, jp, prompts, max_new, frames=None):
    """JAX's reference loop (``greedy_generate_reference``'s calls) in fp32."""
    Sp = prompts.shape[1]
    extras = {} if frames is None else {"frames": jnp.asarray(frames)}
    decode = jax.jit(lambda p, t, c, ci, kl: jm.forward_decode(p, t, c, ci, kv_len=kl,
                                                               dtype=jnp.float32))
    logits, cache = jm.forward_prefill(jp, jnp.asarray(prompts), max_len=Sp + max_new,
                                       dtype=jnp.float32, **extras)
    out = [np.asarray(jnp.argmax(logits[:, -1], axis=-1))]
    kv_len = jnp.full((prompts.shape[0],), Sp, jnp.int32)
    for i in range(max_new - 1):
        logits, cache = decode(jp, jnp.asarray(out[-1][:, None]), cache, jnp.int32(Sp + i),
                               kv_len + i + 1)
        out.append(np.asarray(jnp.argmax(logits[:, -1], axis=-1)))
    return np.stack(out, axis=1)


def test_engine_prefill_step_with_frames_then_decode_matches_jax(pair):
    """Serving real frames: the engine's ``prefill_step(params, tokens,
    {"frames": f})`` then ``decode_step`` per token, token for token
    against the same calls of JAX's model."""
    cfg = pair["cfg"]
    prompts = _tokens(5, (B, 6), cfg.vocab_size)
    max_new = 6
    engine = serving.step_engine(pair["tm"], serving.single_device_plan(cfg),
                                 max_len=6 + max_new, dtype=torch.float32, device="cpu")
    logits, cache = engine.prefill_step(pair["tp"], _t(prompts),
                                        {"frames": torch.from_numpy(pair["frames"])})
    out = [logits[:, -1].argmax(-1)]
    kv_len = torch.full((B,), 6)
    for i in range(max_new - 1):
        logits, cache = engine.decode_step(pair["tp"], out[-1][:, None], cache, 6 + i,
                                           kv_len=kv_len + i + 1)
        out.append(logits[:, -1].argmax(-1))
    got = torch.stack(out, dim=1).numpy()
    want = _jax_greedy(pair["jm"], pair["jp"], prompts, max_new, pair["frames"])
    np.testing.assert_array_equal(got, want)
    zeros = _jax_greedy(pair["jm"], pair["jp"], prompts, max_new)
    assert (got != zeros).any()             # the frames reached the tokens


def test_greedy_generate_without_extras_matches_jax(pair):
    """``greedy_generate`` passes no extras in either package: zero frames."""
    cfg = pair["cfg"]
    prompts = _tokens(6, (3, 8), cfg.vocab_size)
    engine = serving.step_engine(pair["tm"], serving.single_device_plan(cfg),
                                 dtype=torch.float32, device="cpu")
    out = engine.greedy_generate(pair["tp"], prompts, max_new=5, max_len=13)
    assert out.dtype == torch.int32 and out.shape == (3, 5)
    np.testing.assert_array_equal(out.numpy(), _jax_greedy(pair["jm"], pair["jp"], prompts, 5))
    assert len(engine.latencies["prefill_s"]) == 1 and len(engine.latencies["decode_s"]) == 4


# ------------------------------------------------------------------ training

def _live(tree):
    """The params as leaves that require grad, in the tree's layout."""
    live = {path: t.clone().requires_grad_() for path, t in tree_paths(tree)}
    params = {}
    for path, t in live.items():
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return live, params


def test_loss_and_every_grad_match_jax_value_and_grad(pair):
    jm = pair["jm"]
    f = pair["frames"]

    def jloss(p, tokens, labels, frames):
        logits, extra = jm.forward_train(p, tokens, frames=frames, dtype=jnp.float32)
        loss, _ = jtrain.softmax_xent(logits, labels)
        return loss + jtrain.AUX_LOSS_WEIGHT * extra

    jl, jg = jax.jit(jax.value_and_grad(jloss))(pair["jp"], jnp.asarray(pair["tokens"]),
                                                jnp.asarray(pair["labels"]), jnp.asarray(f))
    live, params = _live(pair["tp"])
    _, plan = _plans(pair["cfg"])
    hp = ttrain.construct_hybrid_parallel_model(pair["tm"], plan)
    batch = {"tokens": _t(pair["tokens"]), "labels": torch.from_numpy(pair["labels"]),
             "frames": torch.from_numpy(f)}
    loss, metrics = hp.loss_fn(params, batch, torch.float32)
    grads = torch.autograd.grad(loss, list(live.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=TOL32)
    assert float(metrics["aux"]) == 0.0
    jgrads = dict(tree_paths(jax.tree.map(np.asarray, jg)))
    assert ("enc_blocks", "attn", "wq") in live and ("dec_blocks", "cross_attn", "wk") in live
    for path, g in zip(live, grads):
        assert g.dtype == torch.float32, path
        assert np.abs(jgrads[path]).max() > 0.0, path
        _close_to_scale(g, jgrads[path], TOL_GRAD)


def _plans(cfg, remat_policy="none", grad_accum=1):
    jplan = jax_uniform_plan(cfg.name, "train_4k", (1,), ("data",), cfg.num_layers,
                             JaxLayerStrategy(remat=remat_policy), grad_accum=grad_accum)
    tplan = uniform_plan(cfg.name, "train_4k", (1,), ("data",), cfg.num_layers,
                         LayerStrategy(remat=remat_policy), grad_accum=grad_accum)
    return jplan, tplan


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_train_step_with_grad_accum_matches_jax(name):
    """As the dense family's: loss and grad norm within 3e-2, every
    parameter within 2·lr·(1 + wd) of JAX's after one bf16 step over
    ``SyntheticDataset`` batches, whose frames are bitwise JAX's."""
    p = _pair(name)
    jplan, tplan = _plans(p["cfg"], "selective", grad_accum=2)
    jhp = jtrain.construct_hybrid_parallel_model(p["jm"], jplan)
    thp = ttrain.construct_hybrid_parallel_model(p["tm"], tplan)
    jbatch = {k: jnp.asarray(v) for k, v in JaxSyntheticDataset(p["jcfg"], 16, 4).batch(0).items()}
    tbatch = SyntheticDataset(p["cfg"], 16, 4).batch(0)
    assert set(tbatch) == {"tokens", "labels", "frames"}
    jp, _, jm = jhp.jit_train_step(donate=False)(p["jp"], jhp.init_opt_state(p["jp"]), jbatch)
    tp, ts, tm = thp.train_step(p["tp"], thp.init_opt_state(p["tp"]), tbatch)
    assert int(ts.step) == 1 and set(tm) == set(jm)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=3e-2)
    oc = thp.opt_cfg
    bound = 2 * oc.lr * (1 + oc.weight_decay)
    jflat = dict(tree_paths(jax.tree.map(np.asarray, jp)))
    for path, t in tree_paths(tp):
        assert t.dtype == torch.float32
        assert np.abs(t.numpy() - jflat[path]).max() <= bound, path


def test_kernel_route_on_cpu_gives_the_plain_paths_grads():
    """``impl="kernel"`` on CPU tensors (K1's and K2's autograd functions
    with their plain forwards, K1 non-causal in the encoder and the
    cross-attention) gives ``impl="ref"``'s loss and grads."""
    k, r = _pair("frames100", "kernel"), _pair("frames100", "ref")
    _, plan = _plans(k["cfg"])
    batch = SyntheticDataset(k["cfg"], 16, 2, seed=4).batch(0)
    lk, _, gk = ttrain.construct_hybrid_parallel_model(k["tm"], plan).value_and_grad(
        k["tp"], batch, torch.float32)
    lr, _, gr = ttrain.construct_hybrid_parallel_model(r["tm"], plan).value_and_grad(
        r["tp"], batch, torch.float32)
    np.testing.assert_allclose(float(lk), float(lr), rtol=1e-6)
    for (path, a), (_, b) in zip(tree_paths(gk), tree_paths(gr)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5, err_msg=str(path))


def test_train_launcher_runs_whisper_on_the_cpu(capsys):
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2", "--seq", "16",
            "--batch", "2", "--log-every", "1"]
    assert train_cli.main(argv) == 0
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "done" in out
