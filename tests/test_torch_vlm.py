"""The port's VLM family (``repro_torch.models.transformer.VLMTransformerLM``:
internvl2-26b's InternLM2 backbone reading stub patch embeddings as a
prefix) on the CPU against the JAX package's ``VLMTransformerLM`` (jnp), on
the same weights (JAX ``model.init`` -> numpy, norm scales perturbed ->
``params_from_jax``) and the same numpy inputs.  Configs: internvl2-26b
``reduced()`` (16 prefix positions, 4 query heads over 1 KV head) and the
same with 2 KV heads and 24 prefix positions.

Every check but ``greedy_generate``'s feeds seeded non-zero ``vis_embeds``:
``SyntheticDataset`` gives zeros and JAX's serving loop passes none, so
neither would show whether the prefix reaches the text.  Checked in fp32:
train logits (1e-4), the prefill logits and cache, the engine's
``prefill_step(params, tokens, {"vis_embeds": v})`` + 8 ``decode_step``s
token for token, ``greedy_generate`` with no prefix, the loss and every
grad against ``jax.value_and_grad`` of JAX's ``loss_fn`` formula (the
logits sliced at ``text_offset()``; 2e-3 of each grad's scale), a bf16
``train_step`` with grad_accum 2 against JAX's, the kernel route's grads,
and the launcher on the CPU.
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
from repro.models import build_model as jax_build_model
from repro.runtime import train as jtrain
from repro.runtime.data import SyntheticDataset as JaxSyntheticDataset
from repro_torch import serving
from repro_torch.configs.registry import get_config
from repro_torch.core.strategy import LayerStrategy, uniform_plan
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.models.common import count_params, params_from_jax, tree_paths
from repro_torch.models.transformer import DenseTransformerLM, VLMTransformerLM
from repro_torch.runtime import train as ttrain
from repro_torch.runtime.data import SyntheticDataset
from tests._torch_params import perturbed

TOL32 = 1e-4
TOL_GRAD = 2e-3
B, S = 2, 12
ARCH = "internvl2-26b"
CONFIGS = {"reduced": {}, "kv2": {"num_kv_heads": 2, "vis_tokens": 24}}


def _configs(name):
    kw = CONFIGS[name]
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), **kw)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _vis(seed, cfg, batch=B):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.vis_tokens, cfg.d_model)).astype(np.float32)


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
                tokens=toks[:, :-1], labels=labels, vis=_vis(2, tcfg),
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


def _plans(cfg, remat_policy="none", grad_accum=1):
    jplan = jax_uniform_plan(cfg.name, "train_4k", (1,), ("data",), cfg.num_layers,
                             JaxLayerStrategy(remat=remat_policy), grad_accum=grad_accum)
    tplan = uniform_plan(cfg.name, "train_4k", (1,), ("data",), cfg.num_layers,
                         LayerStrategy(remat=remat_policy), grad_accum=grad_accum)
    return jplan, tplan


# ------------------------------------------------------------------ model structure

def test_build_model_gives_the_vlm_on_the_dense_tree(pair):
    tm = pair["tm"]
    assert isinstance(tm, VLMTransformerLM) and isinstance(tm, DenseTransformerLM)
    assert tm.text_offset() == pair["cfg"].vis_tokens
    jtree = dict(tree_paths(jax.tree.map(np.asarray, pair["jp"])))
    ttree = dict(tree_paths(pair["tp"]))
    assert jtree.keys() == ttree.keys()
    for path, t in ttree.items():
        assert tuple(t.shape) == jtree[path].shape, path
    dense = dataclasses.replace(pair["cfg"], family="dense")
    assert tree_paths(build_model(dense, device="meta").param_defs()) == \
        tree_paths(tm.param_defs())


def test_full_width_param_tree_is_jaxs_abstract():
    """Keys, shapes and the parameter count (about 19.86 G) against JAX's
    ``abstract()`` at full width, nothing materialised."""
    model = build_model(get_config(ARCH), device="meta")
    assert isinstance(model, VLMTransformerLM) and model.text_offset() == 256
    jabs = dict(tree_paths(jax_build_model(jax_get_config(ARCH)).abstract()))
    tdefs = dict(tree_paths(model.param_defs()))
    assert jabs.keys() == tdefs.keys()
    for path, d in tdefs.items():
        assert d.shape == tuple(jabs[path].shape), path
    n = count_params(model.param_defs())
    assert n == sum(int(np.prod(a.shape)) for a in jabs.values())
    assert 19.8e9 < n < 19.9e9


def test_paged_serving_sends_the_vlm_to_the_step_engine():
    with pytest.raises(NotImplementedError, match="step_engine"):
        serving.build(serving.ServeConfig(arch=ARCH, device="cpu"))


# ------------------------------------------------------------------ forward passes

def test_forward_train_logits_match_jax(pair):
    v = pair["vis"]
    jl, jx = pair["jm"].forward_train(pair["jp"], jnp.asarray(pair["tokens"]),
                                      vis_embeds=jnp.asarray(v), dtype=jnp.float32)
    tl, tx = pair["tm"].forward_train(pair["tp"], _t(pair["tokens"]),
                                      vis_embeds=torch.from_numpy(v), dtype=torch.float32)
    assert tuple(tl.shape) == jl.shape == (B, pair["cfg"].vis_tokens + S,
                                           pair["cfg"].vocab_size)
    assert tl.dtype == torch.float32 and float(tx) == float(jx) == 0.0
    _close(tl, jl, TOL32)


def test_the_prefix_reaches_the_text_logits(pair):
    """Other patch embeddings give other text logits; the prefix rows come
    first, so without ``vis_embeds`` the logits are the text's alone."""
    tm, tp, toks = pair["tm"], pair["tp"], _t(pair["tokens"])
    v = torch.from_numpy(pair["vis"])
    off = tm.text_offset()
    a, _ = tm.forward_train(tp, toks, vis_embeds=v, dtype=torch.float32)
    b, _ = tm.forward_train(tp, toks, vis_embeds=2 * v, dtype=torch.float32)
    assert float((a[:, off:] - b[:, off:]).abs().max()) > 1e-3
    n, _ = tm.forward_train(tp, toks, dtype=torch.float32)
    assert tuple(n.shape) == (B, S, pair["cfg"].vocab_size)


def test_prefill_logits_and_cache_match_jax(pair):
    v = pair["vis"]
    Sv = pair["cfg"].vis_tokens
    max_len = Sv + S + 4
    jl, jc = pair["jm"].forward_prefill(pair["jp"], jnp.asarray(pair["tokens"]),
                                        vis_embeds=jnp.asarray(v), max_len=max_len,
                                        dtype=jnp.float32)
    tl, tc = pair["tm"].forward_prefill(pair["tp"], _t(pair["tokens"]),
                                        vis_embeds=torch.from_numpy(v), max_len=max_len,
                                        dtype=torch.float32)
    cfg = pair["cfg"]
    assert tl.shape == jl.shape == (B, 1, cfg.vocab_size)
    assert tuple(tc["k"].shape) == (cfg.num_layers, B, max_len, cfg.num_kv_heads,
                                    cfg.resolved_head_dim)
    _close(tl, jl, TOL32)
    for name in ("k", "v"):
        _close(tc[name], jc[name], TOL32)
        assert not tc[name][:, :, Sv + S:].any()


def _jax_generate(jm, jp, prompts, max_new, vis=None):
    """JAX's model calls of ``greedy_generate_reference`` in fp32, with the
    prefix given to ``forward_prefill`` and its rows counted in the decode
    positions."""
    St = prompts.shape[1]
    Sv = 0 if vis is None else vis.shape[1]
    extras = {} if vis is None else {"vis_embeds": jnp.asarray(vis)}
    decode = jax.jit(lambda p, t, c, ci, kl: jm.forward_decode(p, t, c, ci, kv_len=kl,
                                                               dtype=jnp.float32))
    logits, cache = jm.forward_prefill(jp, jnp.asarray(prompts), max_len=Sv + St + max_new,
                                       dtype=jnp.float32, **extras)
    out = [np.asarray(jnp.argmax(logits[:, -1], axis=-1))]
    kv_len = jnp.full((prompts.shape[0],), Sv + St, jnp.int32)
    for i in range(max_new - 1):
        logits, cache = decode(jp, jnp.asarray(out[-1][:, None]), cache,
                               jnp.int32(Sv + St + i), kv_len + i + 1)
        out.append(np.asarray(jnp.argmax(logits[:, -1], axis=-1)))
    return np.stack(out, axis=1)


def test_engine_prefill_step_with_vis_embeds_then_decode_matches_jax(pair):
    """Serving an image: the engine's ``prefill_step(params, tokens,
    {"vis_embeds": v})`` then 8 ``decode_step``s at ``cache_index = Sv + St
    + i``, token for token against the same calls of JAX's model."""
    cfg = pair["cfg"]
    Sv, St, new = cfg.vis_tokens, 6, 9
    prompts = _tokens(5, (B, St), cfg.vocab_size)
    engine = serving.step_engine(pair["tm"], serving.single_device_plan(cfg),
                                 max_len=Sv + St + new, dtype=torch.float32, device="cpu")
    logits, cache = engine.prefill_step(pair["tp"], _t(prompts),
                                        {"vis_embeds": torch.from_numpy(pair["vis"])})
    out = [logits[:, -1].argmax(-1)]
    kv_len = torch.full((B,), Sv + St)
    for i in range(new - 1):
        logits, cache = engine.decode_step(pair["tp"], out[-1][:, None], cache, Sv + St + i,
                                           kv_len=kv_len + i + 1)
        out.append(logits[:, -1].argmax(-1))
    got = torch.stack(out, dim=1).numpy()
    want = _jax_generate(pair["jm"], pair["jp"], prompts, new, pair["vis"])
    np.testing.assert_array_equal(got, want)
    assert (got != _jax_generate(pair["jm"], pair["jp"], prompts, new)).any()


def test_greedy_generate_without_extras_matches_jax(pair):
    """``greedy_generate`` passes no extras in either package: no prefix."""
    cfg = pair["cfg"]
    prompts = _tokens(6, (3, 8), cfg.vocab_size)
    engine = serving.step_engine(pair["tm"], serving.single_device_plan(cfg),
                                 dtype=torch.float32, device="cpu")
    out = engine.greedy_generate(pair["tp"], prompts, max_new=5, max_len=13)
    assert out.dtype == torch.int32 and out.shape == (3, 5)
    np.testing.assert_array_equal(out.numpy(),
                                  _jax_generate(pair["jm"], pair["jp"], prompts, 5))


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
    """The port's ``loss_fn`` against ``jax.value_and_grad`` of JAX's
    ``loss_fn`` formula in fp32: the prefix runs through every layer and
    the head, and the loss reads the text positions only."""
    jm = pair["jm"]
    off = jm.text_offset()

    def jloss(p, tokens, labels, vis):
        logits, extra = jm.forward_train(p, tokens, vis_embeds=vis, dtype=jnp.float32)
        loss, _ = jtrain.softmax_xent(logits[:, off:, :], labels)
        return loss + jtrain.AUX_LOSS_WEIGHT * extra

    v = pair["vis"]
    jl, jg = jax.jit(jax.value_and_grad(jloss))(pair["jp"], jnp.asarray(pair["tokens"]),
                                                jnp.asarray(pair["labels"]), jnp.asarray(v))
    live, params = _live(pair["tp"])
    _, plan = _plans(pair["cfg"])
    hp = ttrain.construct_hybrid_parallel_model(pair["tm"], plan)
    batch = {"tokens": _t(pair["tokens"]), "labels": torch.from_numpy(pair["labels"]),
             "vis_embeds": torch.from_numpy(v)}
    loss, metrics = hp.loss_fn(params, batch, torch.float32)
    grads = torch.autograd.grad(loss, list(live.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=TOL32)
    assert float(metrics["aux"]) == 0.0 and float(metrics["tokens"]) == B * S - 3
    jgrads = dict(tree_paths(jax.tree.map(np.asarray, jg)))
    for path, g in zip(live, grads):
        assert g.dtype == torch.float32, path
        assert np.abs(jgrads[path]).max() > 0.0, path
        _close_to_scale(g, jgrads[path], TOL_GRAD)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_train_step_with_grad_accum_matches_jax(name):
    """As the dense family's: loss and grad norm within 3e-2, every
    parameter within 2·lr·(1 + wd) of JAX's after one bf16 step over
    ``SyntheticDataset`` batches (text of seq - vis_tokens, zero prefix),
    bitwise JAX's."""
    p = _pair(name)
    jplan, tplan = _plans(p["cfg"], "selective", grad_accum=2)
    jhp = jtrain.construct_hybrid_parallel_model(p["jm"], jplan)
    thp = ttrain.construct_hybrid_parallel_model(p["tm"], tplan)
    seq = p["cfg"].vis_tokens + 16
    jbatch = {k: jnp.asarray(v) for k, v in JaxSyntheticDataset(p["jcfg"], seq, 4).batch(0).items()}
    tbatch = SyntheticDataset(p["cfg"], seq, 4).batch(0)
    assert set(tbatch) == {"tokens", "labels", "vis_embeds"}
    assert tuple(tbatch["tokens"].shape) == (4, 16)
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
    with their plain forwards) gives ``impl="ref"``'s loss and grads with a
    non-zero prefix."""
    k, r = _pair("kv2", "kernel"), _pair("kv2", "ref")
    _, plan = _plans(k["cfg"], "selective")
    batch = SyntheticDataset(k["cfg"], k["cfg"].vis_tokens + 16, 2, seed=4).batch(0)
    batch["vis_embeds"] = torch.from_numpy(_vis(7, k["cfg"])).bfloat16()
    lk, _, gk = ttrain.construct_hybrid_parallel_model(k["tm"], plan).value_and_grad(
        k["tp"], batch, torch.float32)
    lr, _, gr = ttrain.construct_hybrid_parallel_model(r["tm"], plan).value_and_grad(
        r["tp"], batch, torch.float32)
    np.testing.assert_allclose(float(lk), float(lr), rtol=1e-6)
    for (path, a), (_, b) in zip(tree_paths(gk), tree_paths(gr)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5, err_msg=str(path))


def test_train_launcher_runs_internvl2_on_the_cpu(capsys):
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2", "--seq", "32",
            "--batch", "2", "--log-every", "1"]
    assert train_cli.main(argv) == 0
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "done" in out
