"""Training the SSM and hybrid families in the port on the CPU against the
JAX package, on the same weights (JAX ``model.init`` -> numpy, the zero and
one inits perturbed -> ``params_from_jax``) and the same numpy inputs.

* ``ssd_autograd`` (K3 under autograd; on CPU tensors its forward is the
  plain ``ssd_chunked``, its backward the fp32 recompute): dx, ddt, dA, dB
  and dC against ``jax.vjp`` of JAX's ``ssd_chunked`` at G 1 and G 2, N 16,
  and a ragged S (JAX at a chunk that divides S, the port at 64 padded),
  with and without a cotangent on the final state: 1e-3 · max(1, max
  |JAX|), the SSD rule.  bf16 x/B/C get their grads in bf16, dt and A in
  fp32; ``ops.ssd`` takes this route only when a grad is wanted, and the
  recompute runs under the profiler span ``ssd_vjp``.
* mamba2 ``reduced()`` under each remat policy (``none``, ``selective``,
  ``full``) and zamba2 ``reduced()`` and ``num_layers=7`` (a trailing Mamba
  layer): the fp32 loss and every grad against ``jax.value_and_grad`` of
  JAX's ``loss_fn`` formula, 2e-3 of each grad's scale; a bf16
  ``train_step`` with grad_accum 2 against JAX's; the kernel route's grads
  against the plain route's; the scan's reruns under each policy; a donated
  step equal to the functional one.
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
from repro.kernels.ssd.ref import ssd_chunked as jax_ssd_chunked
from repro.models import build_model as jax_build_model
from repro.runtime import train as jtrain
from repro.runtime.data import SyntheticDataset as JaxSyntheticDataset
from repro_torch.configs.registry import get_config
from repro_torch.core.strategy import LayerStrategy, uniform_plan
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.models import build_model
from repro_torch.models.common import params_from_jax, tree_leaves, tree_map, tree_paths
from repro_torch.runtime import optimizer as opt_lib
from repro_torch.runtime import train as ttrain
from repro_torch.runtime.data import SyntheticDataset

SSD_TOL = 1e-3
TOL32 = 1e-4
TOL_GRAD = 2e-3
B, S = 2, 24
POLICIES = ("none", "selective", "full")
MODELS = {
    "mamba2": ("mamba2-2.7b", {}),
    "zamba2": ("zamba2-7b", {}),                          # 6 layers, 3 sites
    "zamba2-layers7": ("zamba2-7b", {"num_layers": 7}),   # 3 sites + 1 trailing layer
}

# (B, S, H, P, G, N, JAX's chunk): G 1, G 2, a ragged S (80 = 64 + 16)
SSD_SHAPES = [(2, 128, 4, 16, 1, 16, 64), (2, 128, 4, 16, 2, 16, 64),
              (1, 80, 4, 16, 2, 16, 16)]


# ------------------------------------------------------------------ ssd_autograd

def _ssd_inputs(seed, Bs, Sq, H, P, G, N):
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    x = normal(Bs, Sq, H, P)
    dt = np.log1p(np.exp(normal(Bs, Sq, H))).astype(np.float32)       # softplus
    A = -np.exp(normal(H, scale=0.3)).astype(np.float32)
    return (x, dt, A, normal(Bs, Sq, G, N, scale=0.3), normal(Bs, Sq, G, N, scale=0.3),
            normal(Bs, Sq, H, P), normal(Bs, H, N, P))


def _close_ssd(got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= SSD_TOL * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize("with_final", [False, True])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_autograd_grads_match_jax_vjp(shape, with_final):
    *dims, chunk = shape
    x, dt, A, Bm, Cm, gy, gs = _ssd_inputs(0, *dims)
    (jy, jfinal), vjp = jax.vjp(lambda *a: jax_ssd_chunked(*a, chunk=chunk),
                                x, dt, A, Bm, Cm)
    jgrads = vjp((jnp.asarray(gy), jnp.asarray(gs if with_final else np.zeros_like(gs))))
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, Bm, Cm)]
    y, final = ssd_ops.ssd_autograd(*ins)
    _close_ssd(y, jy)
    _close_ssd(final, jfinal)
    outs, cots = [y], [torch.from_numpy(gy)]
    if with_final:
        outs.append(final)
        cots.append(torch.from_numpy(gs))
    grads = torch.autograd.grad(outs, ins, cots)
    for got, want, t in zip(grads, jgrads, ins):
        assert got.dtype == torch.float32 and got.shape == t.shape
        _close_ssd(got, want)


def test_ssd_autograd_takes_bf16_inputs_and_returns_their_dtypes():
    """bf16 x, B, C (what the bf16 model passes): y in bf16, dx/dB/dC in
    bf16, ddt/dA in fp32, each the fp32 recompute's grad rounded once."""
    x, dt, A, Bm, Cm, gy, _ = _ssd_inputs(1, 2, 128, 4, 16, 2, 16)
    bf = [torch.from_numpy(a).bfloat16() for a in (x, Bm, Cm)]
    ins = [bf[0].requires_grad_(), torch.from_numpy(dt).requires_grad_(),
           torch.from_numpy(A).requires_grad_(), bf[1].requires_grad_(),
           bf[2].requires_grad_()]
    y, _ = ssd_ops.ssd_autograd(*ins)
    assert y.dtype == torch.bfloat16
    g = torch.from_numpy(gy).bfloat16()
    grads = torch.autograd.grad(y, ins, g)
    assert [t.dtype for t in grads] == [torch.bfloat16, torch.float32, torch.float32,
                                        torch.bfloat16, torch.bfloat16]
    f32 = [t.detach().float().requires_grad_() for t in ins]
    y32, _ = ssd_ref.ssd_chunked(*f32)
    want = torch.autograd.grad(y32, f32, g.float())
    for got, w, t in zip(grads, want, ins):
        torch.testing.assert_close(got, w.to(t.dtype), atol=0, rtol=0)


def test_ssd_takes_the_autograd_route_only_when_a_grad_is_wanted():
    x, dt, A, Bm, Cm, _, _ = _ssd_inputs(2, 1, 64, 2, 16, 1, 16)
    ts = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    y, _ = ssd_ops.ssd(*ts)
    assert y.grad_fn is None
    live = [ts[0].requires_grad_()] + ts[1:]
    y, _ = ssd_ops.ssd(*live)
    assert type(y.grad_fn).__name__ == "_SSDBackward"
    with torch.no_grad():
        assert ssd_ops.ssd(*live)[0].grad_fn is None
    y_ref, _ = ssd_ops.ssd(*live, impl="ref")                 # the plain autograd
    assert type(y_ref.grad_fn).__name__ != "_SSDBackward"
    assert ssd_ops.ssd_autograd.launches == 0                 # CPU tensors launch nothing


def test_ssd_backward_recomputes_under_the_ssd_vjp_span():
    x, dt, A, Bm, Cm, gy, _ = _ssd_inputs(3, 1, 64, 2, 16, 1, 16)
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, Bm, Cm)]
    y, _ = ssd_ops.ssd_autograd(*ins)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.autograd.grad(y, ins, torch.from_numpy(gy))
    assert "ssd_vjp" in {e.key for e in prof.key_averages()}


# ------------------------------------------------------------------ the models

def _perturbed(tree, rng):
    """Numpy param tree with the zero/one inits of a fresh init (A_log,
    dt_bias, D, the norm scales and the attention biases) perturbed."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturbed(v, rng)
        elif k in ("A_log", "dt_bias", "bq", "bk", "bv"):
            out[k] = (v + 0.3 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k in ("D", "scale", "q_norm", "k_norm"):
            out[k] = (v * (1 + 0.1 * rng.standard_normal(v.shape))).astype(np.float32)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def _pair(name, impl="kernel"):
    arch, kw = MODELS[name]
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **kw)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm = jax_build_model(jcfg)
    np_params = _perturbed(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                           np.random.default_rng(0))
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (B, S + 1), dtype=np.int32)
    labels = toks[:, 1:].copy()
    labels[1, :5] = -1                      # masked positions
    return dict(name=name, jcfg=jcfg, cfg=tcfg, jm=jm,
                tm=build_model(tcfg, impl=impl, device="cpu"),
                tokens=toks[:, :-1], labels=labels,
                jp=jax.tree.map(jnp.asarray, np_params),
                tp=params_from_jax(np_params, "cpu", torch.float32))


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def jax_grads(pair):
    """JAX's fp32 loss and grads (the ``loss_fn`` formula), once per model."""
    jm = pair["jm"]

    def jloss(p, tokens, labels):
        logits, extra = jm.forward_train(p, tokens, dtype=jnp.float32)
        loss, _ = jtrain.softmax_xent(logits, labels)
        return loss + jtrain.AUX_LOSS_WEIGHT * extra

    jl, jg = jax.jit(jax.value_and_grad(jloss))(pair["jp"], jnp.asarray(pair["tokens"]),
                                                jnp.asarray(pair["labels"]))
    return float(jl), dict(tree_paths(jax.tree.map(np.asarray, jg)))


def _plans(cfg, remat_policy="none", grad_accum=1):
    jplan = jax_uniform_plan(cfg.name, "train_4k", (1,), ("data",), cfg.num_layers,
                             JaxLayerStrategy(remat=remat_policy), grad_accum=grad_accum)
    tplan = uniform_plan(cfg.name, "train_4k", (1,), ("data",), cfg.num_layers,
                         LayerStrategy(remat=remat_policy), grad_accum=grad_accum)
    return jplan, tplan


def _batch(pair):
    return {"tokens": torch.from_numpy(pair["tokens"]).long(),
            "labels": torch.from_numpy(pair["labels"])}


def _close_to_scale(a, b, tol):
    """|a - b| <= tol · max |b|: a grad's error against its own scale."""
    b = np.asarray(b, np.float32)
    err = np.abs(a.detach().float().numpy() - b).max()
    assert err <= tol * np.abs(b).max(), (err, np.abs(b).max())


@pytest.mark.parametrize("policy", POLICIES)
def test_loss_and_every_grad_match_jax_value_and_grad(pair, jax_grads, policy):
    """``value_and_grad`` in fp32 under each remat policy (mamba2 applies
    it per layer through ``layer_runner``; zamba2 takes none, as JAX's)."""
    jl, jgrads = jax_grads
    _, plan = _plans(pair["cfg"], policy)
    hp = ttrain.construct_hybrid_parallel_model(pair["tm"], plan)
    loss, metrics, grads = hp.value_and_grad(pair["tp"], _batch(pair), torch.float32)
    np.testing.assert_allclose(float(loss), jl, rtol=TOL32)
    assert float(metrics["aux"]) == 0.0
    paths = dict(tree_paths(grads))
    assert paths.keys() == jgrads.keys()
    for path, g in paths.items():
        assert g.dtype == torch.float32, path
        assert np.abs(jgrads[path]).max() > 0.0, path
        _close_to_scale(g, jgrads[path], TOL_GRAD)


@pytest.mark.parametrize("name", list(MODELS))
def test_bf16_train_step_with_grad_accum_matches_jax(name):
    """As the dense family's: loss and grad norm within 3e-2, every
    parameter within 2·lr·(1 + wd) of JAX's after one bf16 step over
    ``SyntheticDataset`` batches, bitwise JAX's."""
    p = _pair(name)
    jplan, tplan = _plans(p["cfg"], "selective", grad_accum=2)
    jhp = jtrain.construct_hybrid_parallel_model(p["jm"], jplan)
    thp = ttrain.construct_hybrid_parallel_model(p["tm"], tplan)
    jbatch = {k: jnp.asarray(v) for k, v in JaxSyntheticDataset(p["jcfg"], 16, 4).batch(0).items()}
    tbatch = SyntheticDataset(p["cfg"], 16, 4).batch(0)
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


@pytest.mark.parametrize("name", ["mamba2", "zamba2-layers7"])
def test_kernel_route_on_cpu_gives_the_plain_paths_grads(name):
    """``impl="kernel"`` on CPU tensors (``ssd_autograd``, K1's and K2's
    autograd functions, the gate norm composed under a grad) gives
    ``impl="ref"``'s loss and grads (plain autograd through
    ``ssd_chunked``)."""
    k, r = _pair(name, "kernel"), _pair(name, "ref")
    _, plan = _plans(k["cfg"], "selective")
    batch = SyntheticDataset(k["cfg"], 70, 2, seed=4).batch(0)      # S 70: a ragged chunk
    lk, _, gk = ttrain.construct_hybrid_parallel_model(k["tm"], plan).value_and_grad(
        k["tp"], batch, torch.float32)
    lr, _, gr = ttrain.construct_hybrid_parallel_model(r["tm"], plan).value_and_grad(
        r["tp"], batch, torch.float32)
    np.testing.assert_allclose(float(lk), float(lr), rtol=1e-6)
    for (path, a), (_, b) in zip(tree_paths(gk), tree_paths(gr)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5, err_msg=str(path))


@pytest.mark.parametrize("policy,forwards", [("none", 1), ("selective", 2), ("full", 2)])
def test_recomputing_policies_rerun_the_scan(monkeypatch, policy, forwards):
    """Per mamba2 layer of a step: the scan's forward runs once, and again
    in the backward under a recomputing policy (it is not an ``aten.mm``,
    so ``selective`` does not keep it), plus one fp32 recompute for its
    grads under every policy."""
    p = _pair("mamba2")
    calls = []
    chunked = ssd_ref.ssd_chunked
    monkeypatch.setattr(ssd_ref, "ssd_chunked",
                        lambda *a, **kw: calls.append(torch.is_grad_enabled()) or chunked(*a, **kw))
    _, plan = _plans(p["cfg"], policy)
    hp = ttrain.construct_hybrid_parallel_model(p["tm"], plan)
    hp.value_and_grad(p["tp"], _batch(p), torch.bfloat16)
    layers = p["cfg"].num_layers
    assert calls.count(False) == forwards * layers       # the autograd forwards
    assert calls.count(True) == layers                   # the backward's recomputes


def test_donated_step_writes_the_functional_steps_numbers_in_place():
    """``train_step(..., donate=True)`` updates params and opt state in
    place with exactly ``adamw_update``'s values over two steps."""
    p = _pair("zamba2-layers7")
    _, plan = _plans(p["cfg"], "selective", grad_accum=2)
    hp = ttrain.construct_hybrid_parallel_model(p["tm"], plan)
    ds = SyntheticDataset(p["cfg"], 16, 4)
    clone = lambda tree: tree_map(torch.clone, tree)
    fp, fs = clone(p["tp"]), hp.init_opt_state(p["tp"])
    dp, ds_ = clone(p["tp"]), hp.init_opt_state(p["tp"])
    before = [t.data_ptr() for t in tree_leaves(dp) + tree_leaves(ds_.m)]
    for step in range(2):
        fp, fs, fm = hp.train_step(fp, fs, ds.batch(step))
        dp, ds_, dm = hp.train_step(dp, ds_, ds.batch(step), donate=True)
        assert float(fm["loss"]) == float(dm["loss"])
    assert [t.data_ptr() for t in tree_leaves(dp) + tree_leaves(ds_.m)] == before
    assert int(ds_.step) == int(fs.step) == 2
    leaves = lambda *trees: [t for tree in trees for t in tree_leaves(tree)]
    for a, b in zip(leaves(dp, ds_.m, ds_.v), leaves(fp, fs.m, fs.v)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_adamw_update_in_place_equals_the_functional_update():
    rng = np.random.default_rng(8)
    params = {"w": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
              "b": torch.from_numpy(rng.standard_normal(5).astype(np.float32))}
    grads = tree_map(lambda t: 3 * torch.ones_like(t), params)
    cfg = opt_lib.AdamWConfig()
    state = opt_lib.adamw_init(params, cfg)
    new_p, new_s, stats = opt_lib.adamw_update(params, grads, state, cfg)
    inp = tree_map(torch.clone, params)
    ip, is_, istats = opt_lib.adamw_update_(inp, grads, opt_lib.adamw_init(params, cfg), cfg)
    assert ip is inp and float(istats["grad_norm"]) == float(stats["grad_norm"])
    leaves = lambda *trees: [t for tree in trees for t in tree_leaves(tree)]
    for a, b in zip(leaves(ip, is_.m, is_.v), leaves(new_p, new_s.m, new_s.v)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
