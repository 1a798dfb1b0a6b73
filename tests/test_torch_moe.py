"""The port's MoE family (``repro_torch.models.moe``: moonshot 64 experts /
top-6 with a shared expert, grok 8 / top-2 geglu) on the CPU against the JAX
package's ``repro.models.moe`` (jnp; MoE reaches no Pallas kernel), on the
same weights (JAX ``model.init`` -> numpy, norm scales perturbed ->
``params_from_jax``) and the same numpy inputs.  Configs: moonshot and grok
``reduced()`` (cf 4.0: nothing dropped), and moonshot reduced with 8 experts
at cf 0.5, where the capacity floor of 8 slots drops tokens in training.

Checked: ``route`` (1e-6; indices exact), ``assign_slots`` and
``slot_inverse`` integer-exact with drops, ``dispatch``/``combine`` forward
exact and their autograd backwards against ``jax.vjp`` of JAX's
``custom_vjp`` (1e-6), ``moe_ffn_apply`` for every FFN type with and
without the shared expert and drops (y 1e-5, aux 1e-6), train logits (1e-4)
and aux (1e-5), the loss and every grad against ``jax.value_and_grad``
(2e-3 of each grad's scale), a bf16 ``train_step`` with grad_accum 2
against JAX's, prefill and decode (scalar and per-row cache_index, 1e-4),
the step engine's greedy tokens against a JAX greedy loop, ``selective``
remat (same grads as ``none``; saves no expert ``bmm``), the full-width
parameter trees, and ``init_params`` drawing large leaves in pieces.
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
from repro.models import moe as jmoe
from repro.models.common import init_params as jax_init_params
from repro.runtime import train as jtrain
from repro.runtime.data import SyntheticDataset as JaxSyntheticDataset
from repro_torch import serving
from repro_torch.configs.registry import get_config
from repro_torch.core.strategy import LayerStrategy, uniform_plan
from repro_torch.models import build_model
from repro_torch.models import common
from repro_torch.models import moe as tmoe
from repro_torch.models.common import (ParamDef, count_params, params_from_jax, tree_leaves,
                                       tree_paths)
from repro_torch.parallel import remat
from repro_torch.runtime import train as ttrain
from repro_torch.runtime.data import SyntheticDataset
from tests._torch_params import perturbed

TOL32 = 1e-4
TOL_GRAD = 2e-3
B, S = 2, 24
CONFIGS = {
    "moonshot": ("moonshot-v1-16b-a3b", {}),
    "grok": ("grok-1-314b", {}),
    "moonshot-drops": ("moonshot-v1-16b-a3b", {"num_experts": 8, "moe_capacity_factor": 0.5}),
}


def _configs(name):
    arch, kw = CONFIGS[name]
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **kw)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _pair(name, impl="kernel"):
    jcfg, tcfg = _configs(name)
    jm = jax_build_model(jcfg)
    np_params = perturbed(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                          np.random.default_rng(0))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab_size, (B, S + 1), dtype=np.int32)
    labels = toks[:, 1:].copy()
    labels[1, :5] = -1                      # masked positions
    return dict(name=name, jcfg=jcfg, cfg=tcfg, jm=jm,
                tm=build_model(tcfg, impl=impl, device="cpu"),
                tokens=toks[:, :-1], labels=labels,
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


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape, dtype=np.int32)


def _ffn_params(cfg, seed=0):
    """JAX-initialised MoE FFN params: (jax tree, port tree)."""
    tree = jax.tree.map(np.asarray, jax_init_params(jmoe.moe_ffn_defs(cfg),
                                                    jax.random.PRNGKey(seed)))
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, "cpu", torch.float32)


# ------------------------------------------------------------------ routing

@pytest.mark.parametrize("T,E,k", [(32, 4, 2), (96, 8, 2), (50, 64, 6), (7, 8, 1)])
def test_route_matches_jax(T, E, k):
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), num_experts=E,
                              experts_per_token=k)
    logits = (2 * np.random.default_rng(T).standard_normal((T, E))).astype(np.float32)
    jg, ji, ja = jmoe.route(jnp.asarray(logits), cfg)
    tg, ti, ta = tmoe.route(torch.from_numpy(logits), cfg)
    assert ti.dtype == torch.long and tuple(ti.shape) == (T, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg, 1e-6)
    _close(ta, ja, 1e-6)


# seeds, token counts, expert counts and top-k in the range of
# tests/test_moe.py::test_slot_assignment_invariants; C = T·k // E drops
# whatever routes past an expert's fair share
SLOT_CASES = [(0, 4, 2, 1), (1, 64, 8, 2), (2, 33, 4, 2), (3, 17, 8, 1), (4, 64, 2, 2),
              (5, 40, 4, 1), (6, 9, 8, 2), (7, 50, 2, 1)]


def test_slot_cases_drop_choices():
    drops = []
    for seed, T, E, k in SLOT_CASES:
        idx = np.random.default_rng(seed).integers(0, E, (T, k))
        drops.append(np.bincount(idx[:, 0], minlength=E).max() > max(T * k // E, 1))
    assert any(drops) and not all(drops)


@pytest.mark.parametrize("seed,T,E,k", SLOT_CASES)
def test_slots_keep_and_inverse_are_jaxs_exactly(seed, T, E, k):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, E, (T, k)).astype(np.int32)
    if k == 2:                                   # top-k never repeats an expert
        idx[:, 1] = (idx[:, 0] + 1 + rng.integers(0, E - 1, T)) % E
    C = max(T * k // E, 1)
    js, jk = jmoe.assign_slots(jnp.asarray(idx), E, C)
    ts, tk = tmoe.assign_slots(_t(idx), E, C)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    jinv = jmoe.slot_inverse(jnp.asarray(idx), js, jk, E, C)
    tinv = tmoe.slot_inverse(_t(idx), ts, tk, E, C)
    assert tinv.dtype == torch.long and tuple(tinv.shape) == (E * C,)
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    over = np.bincount(idx.ravel(), minlength=E).max() > C
    assert bool(tk.all()) != over                # an expert past C drops choices
    assert int(tk.sum()) == int(np.minimum(np.bincount(idx.ravel(), minlength=E), C).sum())


@pytest.mark.parametrize("drops", [False, True])
def test_dispatch_and_combine_and_their_backwards_match_jax(drops):
    """Forward gathers bitwise; the autograd backwards (the opposite
    gathers) against ``jax.vjp`` of JAX's ``custom_vjp`` at 1e-6."""
    rng = np.random.default_rng(4)
    T, D, E, k = 24, 16, 4, 2
    idx = np.stack([rng.integers(0, E, T), np.zeros(T, np.int64)], 1)
    idx[:, 1] = (idx[:, 0] + 1 + rng.integers(0, E - 1, T)) % E
    C = 8 if drops else 16
    js, jk = jmoe.assign_slots(jnp.asarray(idx, jnp.int32), E, C)
    jinv = jmoe.slot_inverse(jnp.asarray(idx, jnp.int32), js, jk, E, C)
    jflat = jnp.asarray(idx, jnp.int32) * C + js
    ts, tk = tmoe.assign_slots(_t(idx), E, C)
    tinv = tmoe.slot_inverse(_t(idx), ts, tk, E, C)
    tflat = _t(idx) * C + ts
    assert bool(tk.all()) != drops
    xt = rng.standard_normal((T, D)).astype(np.float32)
    g_disp = rng.standard_normal((E * C, D)).astype(np.float32)
    g_comb = rng.standard_normal((T, k, D)).astype(np.float32)

    jout, jvjp = jax.vjp(lambda x: jmoe.dispatch(x, jinv, jflat, jk), jnp.asarray(xt))
    tx = torch.from_numpy(xt).requires_grad_()
    tout = tmoe.dispatch(tx, tinv, tflat, tk)
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(jout))
    (tdx,) = torch.autograd.grad(tout, tx, torch.from_numpy(g_disp))
    _close(tdx, jvjp(jnp.asarray(g_disp))[0], 1e-6)

    ef = rng.standard_normal((E * C, D)).astype(np.float32)
    jout, jvjp = jax.vjp(lambda e: jmoe.combine(e, jinv, jflat, jk), jnp.asarray(ef))
    te = torch.from_numpy(ef).requires_grad_()
    tout = tmoe.combine(te, tinv, tflat, tk)
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(jout))
    (tde,) = torch.autograd.grad(tout, te, torch.from_numpy(g_comb))
    _close(tde, jvjp(jnp.asarray(g_comb))[0], 1e-6)


def test_dispatch_and_combine_backwards_are_gathers_not_scatters():
    """The backwards are the autograd Functions' own (``index_select``
    gathers), not ``index_select``'s scatter-add backward."""
    T, D, E, C = 6, 4, 2, 8
    idx = torch.tensor([[0, 1], [1, 0], [0, 1], [1, 0], [0, 1], [1, 0]])
    slots, keep = tmoe.assign_slots(idx, E, C)
    inv = tmoe.slot_inverse(idx, slots, keep, E, C)
    x = torch.randn(T, D, requires_grad=True)
    out = tmoe.dispatch(x, inv, idx * C + slots, keep)
    assert type(out.grad_fn).__name__ == "_DispatchBackward"
    y = tmoe.combine(out, inv, idx * C + slots, keep)
    assert type(y.grad_fn).__name__ == "_CombineBackward"
    # every choice kept: combine(dispatch(x)) hands each token back k times
    torch.testing.assert_close(y, x[:, None, :].expand(T, 2, D))


@pytest.mark.parametrize("drops", [False, True], ids=["nodrops", "drops"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "noshared"])
@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "relu2", "gelu"])
def test_moe_ffn_apply_matches_jax(mlp_type, shared, drops):
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b").reduced(), mlp_type=mlp_type,
                              shared_expert_ff=128 if shared else 0, num_experts=8,
                              moe_capacity_factor=0.5 if drops else 4.0)
    jp, tp = _ffn_params(cfg, seed=3)
    x = np.random.default_rng(5).standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_ffn_apply(jp, jnp.asarray(x), cfg)
    ty, taux = tmoe.moe_ffn_apply(tp, torch.from_numpy(x), cfg)
    assert ty.dtype == torch.float32 and tuple(ty.shape) == jy.shape
    _close(ty, jy, 1e-5)
    _close(taux, jaux, 1e-6)
    T = x.shape[0] * x.shape[1]
    C = tmoe._capacity(cfg, T)
    _, idx, _ = tmoe.route(torch.from_numpy(x.reshape(T, -1)) @ tp["router"], cfg)
    _, keep = tmoe.assign_slots(idx, cfg.num_experts, C)
    assert bool(keep.all()) != drops


def test_capacity_is_jaxs():
    cfg = get_config("moonshot-v1-16b-a3b")
    for T in (1, 4, 8192, 1000, 8193):
        assert tmoe._capacity(cfg, T) == jmoe._capacity(cfg, T)
    assert tmoe._capacity(cfg, 4) == 8 and tmoe._capacity(cfg, 4 * 2048) == 960


# ------------------------------------------------------------------ model

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


@pytest.mark.parametrize("arch,n_params", [("moonshot-v1-16b-a3b", 28_888_467_456),
                                           ("grok-1-314b", None)])
def test_full_width_param_tree_is_jaxs_abstract(arch, n_params):
    """Keys and shapes against JAX's ``abstract()`` at full width, nothing
    materialised (the port builds on ``meta``)."""
    model = build_model(get_config(arch), device="meta")
    assert isinstance(model, tmoe.MoETransformerLM)
    jabs = dict(tree_paths(jax_build_model(jax_get_config(arch)).abstract()))
    tdefs = dict(tree_paths(model.param_defs()))
    assert jabs.keys() == tdefs.keys()
    for path, d in tdefs.items():
        assert d.shape == tuple(jabs[path].shape), path
    n = count_params(model.param_defs())
    assert n == sum(int(np.prod(a.shape)) for a in jabs.values())
    if n_params is not None:
        assert n == n_params                       # 28.89 G: 57.8 GB in bf16
    assert tdefs[("blocks", "mlp", "w_out")].shape[:2] == \
        (get_config(arch).num_layers, get_config(arch).num_experts)


def test_build_model_defaults_to_the_card():
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(cfg)
    model = build_model(cfg, device="cpu")
    assert isinstance(model, tmoe.MoETransformerLM) and model.device.type == "cpu"
    assert model.impl == "kernel"


def test_forward_train_logits_and_aux_match_jax(pair):
    jl, jx = pair["jm"].forward_train(pair["jp"], jnp.asarray(pair["tokens"]),
                                      dtype=jnp.float32)
    tl, tx = pair["tm"].forward_train(pair["tp"], _t(pair["tokens"]), dtype=torch.float32)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    assert tx.dtype == torch.float32 and float(tx) > 0.0
    _close(tl, jl, TOL32)
    _close(tx, jx, 1e-5)


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

    def jloss(p, tokens, labels):
        logits, extra = jm.forward_train(p, tokens, dtype=jnp.float32)
        loss, _ = jtrain.softmax_xent(logits, labels)
        return loss + jtrain.AUX_LOSS_WEIGHT * extra

    jl, jg = jax.jit(jax.value_and_grad(jloss))(pair["jp"], jnp.asarray(pair["tokens"]),
                                                jnp.asarray(pair["labels"]))
    live, params = _live(pair["tp"])
    logits, extra = pair["tm"].forward_train(params, _t(pair["tokens"]), dtype=torch.float32)
    loss, _ = ttrain.softmax_xent(logits, torch.from_numpy(pair["labels"]))
    loss = loss + ttrain.AUX_LOSS_WEIGHT * extra
    grads = torch.autograd.grad(loss, list(live.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=TOL32)
    jgrads = dict(tree_paths(jax.tree.map(np.asarray, jg)))
    assert ("blocks", "mlp", "router") in live
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


@pytest.mark.parametrize("name", ["moonshot", "grok"])
def test_bf16_train_step_with_grad_accum_matches_jax(name):
    """As the dense family's: loss, aux and grad norm within 3e-2, every
    parameter within 2·lr·(1 + wd) of JAX's after one bf16 step."""
    p = _pair(name)
    jplan, tplan = _plans(p["cfg"], "selective", grad_accum=2)
    jhp = jtrain.construct_hybrid_parallel_model(p["jm"], jplan)
    thp = ttrain.construct_hybrid_parallel_model(p["tm"], tplan)
    jbatch = {k: jnp.asarray(v) for k, v in JaxSyntheticDataset(p["jcfg"], 32, 4).batch(0).items()}
    tbatch = SyntheticDataset(p["cfg"], 32, 4).batch(0)
    jp, _, jm = jhp.jit_train_step(donate=False)(p["jp"], jhp.init_opt_state(p["jp"]), jbatch)
    tp, ts, tm = thp.train_step(p["tp"], thp.init_opt_state(p["tp"]), tbatch)
    assert int(ts.step) == 1 and set(tm) == set(jm)
    for key in ("loss", "grad_norm", "aux"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=3e-2)
    assert float(tm["aux"]) > 0.0
    oc = thp.opt_cfg
    bound = 2 * oc.lr * (1 + oc.weight_decay)
    jflat = dict(tree_paths(jax.tree.map(np.asarray, jp)))
    for path, t in tree_paths(tp):
        assert t.dtype == torch.float32
        assert np.abs(t.numpy() - jflat[path]).max() <= bound, path


def test_selective_remat_gives_nones_grads_and_saves_no_expert_product(monkeypatch):
    """``selective`` saves the router's and the shared expert's plain
    products (``aten.mm``) and recomputes the experts' batched ones
    (``aten.bmm``), as JAX's ``dots_with_no_batch_dims_saveable``; the grads
    are ``none``'s and ``full``'s."""
    p = _pair("moonshot-drops")
    cfg = p["cfg"]
    batch = SyntheticDataset(cfg, 32, 4, seed=2).batch(0)
    decided = []
    policy_fn = remat.selective_policy

    def recording(ctx, op, *args, **kwargs):
        decision = policy_fn(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            last = args[-1] if args else None
            decided.append((op, decision,
                            tuple(last.shape) if isinstance(last, torch.Tensor) else ()))
        return decision

    grads = {}
    for policy in ("none", "selective", "full"):
        if policy == "selective":
            monkeypatch.setattr(remat, "selective_policy", recording)
        _, plan = _plans(cfg, policy)
        hp = ttrain.construct_hybrid_parallel_model(p["tm"], plan)
        loss, _, grads[policy] = hp.value_and_grad(p["tp"], batch, torch.float32)
        monkeypatch.undo()
    aten = torch.ops.aten
    saved = [op for op, d, _ in decided if d == remat.CheckpointPolicy.MUST_SAVE]
    bmms = [(d, shape) for op, d, shape in decided if op == aten.bmm.default]
    E, f = cfg.num_experts, cfg.d_ff
    assert set(saved) <= {aten.mm.default, aten.addmm.default} and saved
    assert any(shape == (E, cfg.d_model, f) for _, shape in bmms)      # the expert products
    assert all(d == remat.CheckpointPolicy.PREFER_RECOMPUTE for d, _ in bmms)
    for policy in ("selective", "full"):
        for a, b in zip(tree_leaves(grads[policy]), tree_leaves(grads["none"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


def test_kernel_route_on_cpu_gives_the_plain_paths_grads():
    """``impl="kernel"`` on CPU tensors (K1's and K2's autograd functions
    with their plain forwards) gives ``impl="ref"``'s loss and grads."""
    k, r = _pair("moonshot-drops", "kernel"), _pair("moonshot-drops", "ref")
    _, plan = _plans(k["cfg"], "selective")
    batch = SyntheticDataset(k["cfg"], 32, 2, seed=4).batch(0)
    lk, mk, gk = ttrain.construct_hybrid_parallel_model(k["tm"], plan).value_and_grad(
        k["tp"], batch, torch.float32)
    lr, mr, gr = ttrain.construct_hybrid_parallel_model(r["tm"], plan).value_and_grad(
        r["tp"], batch, torch.float32)
    np.testing.assert_allclose(float(lk), float(lr), rtol=1e-6)
    np.testing.assert_allclose(float(mk["aux"]), float(mr["aux"]), rtol=1e-6)
    for (path, a), (_, b) in zip(tree_paths(gk), tree_paths(gr)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5, err_msg=str(path))


def test_entry_points_take_the_moe_family():
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    _, plan = _plans(cfg)
    hp = ttrain.construct_hybrid_parallel_model(build_model(cfg, device="cpu"), plan)
    assert hp.plan is plan
    with pytest.raises(NotImplementedError, match="dense cache layout"):
        serving.build(serving.ServeConfig(arch="moonshot-v1-16b-a3b", device="cpu"))


# ------------------------------------------------------------------ serving

def test_prefill_logits_and_cache_match_jax(pair):
    cfg = pair["cfg"]
    toks = _tokens(1, (2, 12), cfg.vocab_size)
    jl, jc = pair["jm"].forward_prefill(pair["jp"], jnp.asarray(toks), max_len=20,
                                        dtype=jnp.float32)
    tl, tc = pair["tm"].forward_prefill(pair["tp"], _t(toks), max_len=20, dtype=torch.float32)
    assert tl.shape == jl.shape and tc["k"].shape == jc["k"].shape
    _close(tl, jl, TOL32)
    _close(tc["k"], jc["k"], TOL32)
    _close(tc["v"], jc["v"], TOL32)


def test_decode_steps_match_jax(pair):
    """Three decode steps at a scalar cache_index after a prefill."""
    cfg = pair["cfg"]
    prompts = _tokens(2, (3, 10), cfg.vocab_size)
    _, jc = pair["jm"].forward_prefill(pair["jp"], jnp.asarray(prompts), max_len=16,
                                       dtype=jnp.float32)
    tc = {k: torch.tensor(np.asarray(v)) for k, v in jc.items()}
    tok = _tokens(3, (3, 1), cfg.vocab_size)
    for i in range(3):
        jl, jc = pair["jm"].forward_decode(pair["jp"], jnp.asarray(tok), jc, 10 + i,
                                           dtype=jnp.float32)
        tl, tc = pair["tm"].forward_decode(pair["tp"], _t(tok), tc, 10 + i,
                                           dtype=torch.float32)
        _close(tl, jl, TOL32)
        _close(tc["k"], jc["k"], TOL32)
        _close(tc["v"], jc["v"], TOL32)
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)


def test_batched_decode_per_row_cache_index_matches_jax(pair):
    """One decode step for three rows at three write positions against JAX
    per-row calls (no row is dropped: 3 tokens fill no expert's 8 slots)."""
    cfg = pair["cfg"]
    Bq, Sp, M = 3, 12, 20
    prompts = _tokens(2, (Bq, Sp), cfg.vocab_size)
    _, jc = pair["jm"].forward_prefill(pair["jp"], jnp.asarray(prompts), max_len=M,
                                       dtype=jnp.float32)
    cache_np = {k: np.asarray(v) for k, v in jc.items()}
    ci = np.asarray([12, 9, 11], np.int32)
    tok = _tokens(3, (Bq, 1), cfg.vocab_size)
    t_cache = {k: torch.tensor(v) for k, v in cache_np.items()}
    tl, tc = pair["tm"].forward_decode(pair["tp"], _t(tok), t_cache, torch.from_numpy(ci),
                                       kv_len=torch.from_numpy(ci + 1), dtype=torch.float32)
    for b in range(Bq):
        jl, jcb = pair["jm"].forward_decode(
            pair["jp"], jnp.asarray(tok[b:b + 1]),
            {k: jnp.asarray(v[:, b:b + 1]) for k, v in cache_np.items()}, int(ci[b]),
            kv_len=jnp.asarray(ci[b:b + 1] + 1), dtype=jnp.float32)
        _close(tl[b:b + 1], jl, TOL32)
        _close(tc["k"][:, b:b + 1], jcb["k"], TOL32)
        _close(tc["v"][:, b:b + 1], jcb["v"], TOL32)


def _jax_greedy(jm, jp, prompts, max_new):
    Sp = prompts.shape[1]
    decode = jax.jit(lambda p, t, c, ci, kl: jm.forward_decode(p, t, c, ci, kv_len=kl,
                                                               dtype=jnp.float32))
    logits, cache = jm.forward_prefill(jp, jnp.asarray(prompts), max_len=Sp + max_new,
                                       dtype=jnp.float32)
    out = [np.asarray(jnp.argmax(logits[:, -1], axis=-1))]
    kv_len = jnp.full((prompts.shape[0],), Sp, jnp.int32)
    for i in range(max_new - 1):
        logits, cache = decode(jp, jnp.asarray(out[-1][:, None]), cache, jnp.int32(Sp + i),
                               kv_len + i + 1)
        out.append(np.asarray(jnp.argmax(logits[:, -1], axis=-1)))
    return np.stack(out, axis=1)


def test_step_engine_greedy_matches_jax_greedy_loop(pair):
    cfg = pair["cfg"]
    prompts = _tokens(6, (3, 12), cfg.vocab_size)
    engine = serving.step_engine(pair["tm"], serving.single_device_plan(cfg),
                                 dtype=torch.float32, device="cpu")
    out = engine.greedy_generate(pair["tp"], prompts, max_new=6, max_len=18)
    assert out.dtype == torch.int32 and out.shape == (3, 6)
    np.testing.assert_array_equal(out.numpy(), _jax_greedy(pair["jm"], pair["jp"], prompts, 6))
    assert len(engine.latencies["prefill_s"]) == 1 and len(engine.latencies["decode_s"]) == 5


# ------------------------------------------------------------------ init

def test_init_draws_a_large_leaf_in_pieces(monkeypatch):
    """A leaf past ``DRAW_ELEMENTS`` is drawn piece by piece into a tensor
    of the target dtype: right shape, dtype, mean and std, the same values
    for the same seed; a leaf that fits one piece keeps, bit for bit, the
    values of a whole draw of its shape cast to the dtype."""
    d = ParamDef((6, 50, 40), ("experts", "embed", "ff"), scale=0.5)
    small = ParamDef((10, 20), ("embed", "ff"))
    for leaf, seed in ((d, 3), (small, 1)):
        whole = torch.randn(leaf.shape, generator=torch.Generator().manual_seed(seed),
                            dtype=torch.float32).mul_(leaf.std())
        for dtype in (torch.float32, torch.bfloat16):
            x = leaf.materialize(torch.Generator().manual_seed(seed), torch.device("cpu"), dtype)
            assert x.dtype == dtype and torch.equal(x, whole.to(dtype)), (leaf.shape, dtype)
    monkeypatch.setattr(common, "DRAW_ELEMENTS", 700)          # 12 000 elements: 18 pieces
    draws = [d.materialize(torch.Generator().manual_seed(3), torch.device("cpu"), dtype)
             for dtype in (torch.bfloat16, torch.bfloat16, torch.float32)]
    for x in draws:
        assert tuple(x.shape) == d.shape
    assert draws[0].dtype == torch.bfloat16 and draws[2].dtype == torch.float32
    assert torch.equal(draws[0], draws[1])
    assert torch.equal(draws[0], draws[2].to(torch.bfloat16))
    x = draws[2]
    assert abs(float(x.mean())) < 0.02 and abs(float(x.std()) - 0.5) < 0.02
    assert not torch.equal(x[:1], x[1:2])                      # the pieces differ


def test_init_params_of_a_reduced_moe_model_in_bf16():
    """``model.init`` in bf16 builds every leaf in bf16 with the defs' std
    (the experts' explicit 1/sqrt(fan-in) scales)."""
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b").reduced(), num_experts=16)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0), torch.bfloat16)
    defs = dict(tree_paths(model.param_defs()))
    for path, t in tree_paths(params):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == defs[path].shape, path
    w = params["blocks"]["mlp"]["w_out"].float()
    assert abs(float(w.std()) - 1.0 / np.sqrt(cfg.d_ff)) < 0.01 * float(w.std()) + 1e-3
