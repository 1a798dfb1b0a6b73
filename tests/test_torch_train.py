"""The port's training runtime (``repro_torch.runtime.{data,train}``,
``parallel.remat``) on the CPU against the JAX package, on the same weights
and batches:

* ``SyntheticDataset`` batches bitwise equal to JAX's (llama3.2-1b tokens
  and labels, internvl2-26b ``vis_embeds``, whisper-tiny ``frames`` as bf16
  bits) at steps 0 and 3;
* one bf16 ``train_step`` with ``grad_accum`` 2 against JAX's
  ``construct_hybrid_parallel_model(...).train_step``: loss and grad norm
  within 3e-2, parameters within 2·lr·(1 + wd);
* ``train_step`` with ``grad_accum`` 1, 2 and 4 is AdamW on the mean of
  its microbatches' losses and grads (1e-6), and in fp32 with two
  microbatches matches the same step composed from JAX's functions (loss and
  grad norm 1e-5, first moments 2e-3 of their scale);
* a 5-step fp32 loss trajectory (forward, ``softmax_xent``, AdamW) at 1e-4;
* ``none``, ``selective`` and ``full`` remat give the same fp32 grads
  (1e-5), and keep less for the backward in that order;
* the kernel route on CPU tensors (the autograd functions of K1 and K2 with
  their plain forwards and recomputing backwards) gives the plain path's
  grads;
* the entry points refuse what one device cannot run: a plan over more
  than one device without a mesh, and pipeline parallelism;
* ``train_step`` leaves no tensor in a reference cycle: the initial
  parameters go as soon as a step replaces them, with the cyclic collector
  off.
"""
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core.strategy import LayerStrategy as JaxLayerStrategy
from repro.core.strategy import uniform_plan as jax_uniform_plan
from repro.models import build_model as jax_build_model
from repro.runtime import optimizer as jopt
from repro.runtime import train as jtrain
from repro.runtime.data import SyntheticDataset as JaxSyntheticDataset
from repro_torch.configs.registry import get_config
from repro_torch.core.strategy import LayerStrategy, uniform_plan
from repro_torch.models import build_model
from repro_torch.models.common import params_from_jax, tree_leaves, tree_map, tree_paths
from repro_torch.parallel import remat
from repro_torch.runtime import optimizer as topt
from repro_torch.runtime import train as ttrain
from repro_torch.runtime.data import SyntheticDataset
from tests._torch_params import perturbed

ARCH = "llama3.2-1b"
SEQ, BATCH = 32, 4


def _pair(arch, impl="kernel"):
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm = jax_build_model(jcfg)
    np_params = perturbed(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                           np.random.default_rng(0))
    return dict(cfg=tcfg, jm=jm, tm=build_model(tcfg, impl=impl, device="cpu"), np=np_params,
                jp=jax.tree.map(jnp.asarray, np_params),
                tp=params_from_jax(np_params, "cpu", torch.float32))


@pytest.fixture(scope="module")
def pair():
    return _pair(ARCH)


def _plans(cfg, remat_policy="none", grad_accum=1):
    jplan = jax_uniform_plan(cfg.name, "train_4k", (1,), ("data",), cfg.num_layers,
                             JaxLayerStrategy(remat=remat_policy), grad_accum=grad_accum)
    tplan = uniform_plan(cfg.name, "train_4k", (1,), ("data",), cfg.num_layers,
                         LayerStrategy(remat=remat_policy), grad_accum=grad_accum)
    return jplan, tplan


def _value_and_grad(model, params, batch, plan, dtype=torch.float32):
    """The runtime's loss and grads of one batch, in ``dtype``."""
    hp = ttrain.construct_hybrid_parallel_model(model, plan)
    loss, _, grads = hp.value_and_grad(params, batch, dtype)
    return loss, grads


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("arch,seq", [("llama3.2-1b", 33), ("internvl2-26b", 48),
                                      ("whisper-tiny", 20)])
@pytest.mark.parametrize("step", [0, 3])
def test_synthetic_batches_are_bitwise_jax_batches(arch, seq, step):
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jb = JaxSyntheticDataset(jcfg, seq, 3, seed=5).batch(step)
    tb = SyntheticDataset(tcfg, seq, 3, seed=5).batch(step)
    assert jb.keys() == tb.keys()
    for k in ("tokens", "labels"):
        assert tb[k].dtype == np.int32 and np.array_equal(tb[k], jb[k]), k
    for k in set(jb) - {"tokens", "labels"}:
        assert tb[k].dtype == torch.bfloat16 and tuple(tb[k].shape) == jb[k].shape
        bits = tb[k].view(torch.int16).numpy().view(np.uint16)
        assert np.array_equal(bits, np.asarray(jb[k]).view(np.uint16)), k
    if arch == "whisper-tiny":
        assert float(tb["frames"].float().std()) > 0.5      # real draws, not zeros


def test_batches_of_different_hosts_tile_the_global_batch():
    ds = SyntheticDataset(get_config(ARCH).reduced(), 16, 4, seed=1)
    whole = ds.batch(2)["tokens"]
    halves = [ds.batch(2, host_id=h, num_hosts=2)["tokens"] for h in range(2)]
    assert np.array_equal(whole[0::2], halves[0]) and np.array_equal(whole[1::2], halves[1])


# ------------------------------------------------------------------ train step

def test_bf16_train_step_with_grad_accum_matches_jax(pair):
    cfg = pair["cfg"]
    jplan, tplan = _plans(cfg, "selective", grad_accum=2)
    jhp = jtrain.construct_hybrid_parallel_model(pair["jm"], jplan)
    thp = ttrain.construct_hybrid_parallel_model(pair["tm"], tplan)
    jbatch = {k: jnp.asarray(v) for k, v in
              JaxSyntheticDataset(jax_get_config(ARCH).reduced(), SEQ, BATCH).batch(0).items()}
    tbatch = SyntheticDataset(cfg, SEQ, BATCH).batch(0)
    jp, _, jm = jhp.jit_train_step(donate=False)(pair["jp"], jhp.init_opt_state(pair["jp"]),
                                                jbatch)
    tp, ts, tm = thp.train_step(pair["tp"], thp.init_opt_state(pair["tp"]), tbatch)
    assert int(ts.step) == 1
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=3e-2)
    assert set(tm) == set(jm)
    oc = thp.opt_cfg
    bound = 2 * oc.lr * (1 + oc.weight_decay)
    jflat = dict(tree_paths(jax.tree.map(np.asarray, jp)))
    for path, t in tree_paths(tp):
        assert t.dtype == torch.float32
        assert np.abs(t.numpy() - jflat[path]).max() <= bound, path


@pytest.mark.parametrize("k", [1, 2, 4])
def test_train_step_is_adamw_on_the_mean_of_its_microbatches(pair, k):
    """``train_step`` with ``grad_accum`` k (bf16, as it runs) against the
    same step composed here: ``value_and_grad`` of each of the k slices of
    the batch, the mean of their losses and fp32 grads, then ``adamw_update``.
    Loss, grad norm, parameters and moments within 1e-6; ``apply_grads``
    (the step's optimizer half) on the same mean is ``adamw_update``
    bitwise."""
    cfg = pair["cfg"]
    _, tplan = _plans(cfg, "selective", grad_accum=k)
    hp = ttrain.construct_hybrid_parallel_model(pair["tm"], tplan)
    batch = SyntheticDataset(cfg, SEQ, BATCH, seed=3).batch(0)
    state = hp.init_opt_state(pair["tp"])
    tp, ts, tm = hp.train_step(pair["tp"], state, batch)

    n = BATCH // k
    parts = [hp.value_and_grad(pair["tp"], {key: v[i * n:(i + 1) * n] for key, v in
                                            batch.items()}) for i in range(k)]
    loss = sum(float(p[0]) for p in parts) / k
    mean = tree_map(lambda *g: sum(x.float() for x in g) / k, *(p[2] for p in parts))
    rp, rs, rm = topt.adamw_update(pair["tp"], mean, state, hp.opt_cfg)
    ap, a_s, am = hp.apply_grads(pair["tp"], mean, state)
    assert float(am["grad_norm"]) == float(rm["grad_norm"])
    for got, want in ((ap, rp), (a_s.m, rs.m), (a_s.v, rs.v)):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))
    np.testing.assert_allclose(float(tm["loss"]), loss, rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-6)
    for got, want in ((tp, rp), (ts.m, rs.m), (ts.v, rs.v)):
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)


def test_fp32_grad_accum_step_matches_jax_composed_step(pair):
    """Two microbatches in fp32: the port's ``train_step`` against the mean
    of JAX's ``value_and_grad`` over the two halves followed by JAX's
    ``adamw_update``.  Loss and grad norm within 1e-5; the first moments
    (0.1 x the clipped accumulated grads) within 2e-3 of each leaf's scale,
    the grads' tolerance in the value-and-grad parity test."""
    cfg = pair["cfg"]
    jplan, tplan = _plans(cfg, "none", grad_accum=2)
    jm = pair["jm"]
    runner = jtrain.make_layer_runner(jplan, None)

    def jloss(p, tokens, labels):
        logits, extra = jm.forward_train(p, tokens, layer_runner=runner, dtype=jnp.float32)
        loss, _ = jtrain.softmax_xent(logits, labels)
        return loss + jtrain.AUX_LOSS_WEIGHT * extra

    batch = SyntheticDataset(cfg, SEQ, BATCH, seed=6).batch(0)
    n = BATCH // 2
    halves = [jax.value_and_grad(jloss)(pair["jp"], jnp.asarray(batch["tokens"][i * n:(i + 1) * n]),
                                        jnp.asarray(batch["labels"][i * n:(i + 1) * n]))
              for i in range(2)]
    jgrads = jax.tree.map(lambda a, b: (a + b) / 2, halves[0][1], halves[1][1])
    jcfg = jopt.AdamWConfig()
    _, js, jstats = jopt.adamw_update(pair["jp"], jgrads, jopt.adamw_init(pair["jp"], jcfg), jcfg)

    hp = ttrain.construct_hybrid_parallel_model(pair["tm"], tplan)
    _, ts, tm = hp.train_step(pair["tp"], hp.init_opt_state(pair["tp"]), batch,
                              dtype=torch.float32)
    np.testing.assert_allclose(float(tm["loss"]), (float(halves[0][0]) + float(halves[1][0])) / 2,
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jstats["grad_norm"]), rtol=1e-5)
    jflat = dict(tree_paths(jax.tree.map(np.asarray, js.m)))
    for path, t in tree_paths(ts.m):
        ref = jflat[path]
        assert np.abs(t.numpy() - ref).max() <= 2e-3 * np.abs(ref).max(), path


def test_fp32_five_step_loss_trajectory_matches_jax(pair):
    cfg = pair["cfg"]
    jplan, tplan = _plans(cfg, "full")
    jm = pair["jm"]
    runner = jtrain.make_layer_runner(jplan, None)

    def jloss(p, tokens, labels):
        logits, extra = jm.forward_train(p, tokens, layer_runner=runner, dtype=jnp.float32)
        loss, _ = jtrain.softmax_xent(logits, labels)
        return loss + jtrain.AUX_LOSS_WEIGHT * extra

    jvg = jax.jit(jax.value_and_grad(jloss))
    jcfg, tcfg = jopt.AdamWConfig(lr=3e-3), topt.AdamWConfig(lr=3e-3)
    jp, tp = pair["jp"], pair["tp"]
    js, ts = jopt.adamw_init(jp, jcfg), topt.adamw_init(tp, tcfg)
    ds = SyntheticDataset(cfg, SEQ, BATCH, seed=2)
    jl_all, tl_all = [], []
    for step in range(5):
        batch = ds.batch(step)
        jl, jg = jvg(jp, jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"]))
        jp, js, _ = jopt.adamw_update(jp, jg, js, jcfg)
        tl, tg = _value_and_grad(pair["tm"], tp, batch, tplan)
        tp, ts, _ = topt.adamw_update(tp, tg, ts, tcfg)
        jl_all.append(float(jl))
        tl_all.append(float(tl))
    np.testing.assert_allclose(tl_all, jl_all, rtol=1e-4)
    assert all(np.isfinite(tl_all))


def test_train_step_reduces_the_loss_on_a_repeated_batch(pair):
    _, tplan = _plans(pair["cfg"], "full", grad_accum=2)
    hp = ttrain.construct_hybrid_parallel_model(pair["tm"], tplan)
    batch = SyntheticDataset(pair["cfg"], SEQ, BATCH).batch(0)
    step = hp.jit_train_step()
    p, s = pair["tp"], hp.init_opt_state(pair["tp"])
    losses = []
    for _ in range(3):
        p, s, m = step(p, s, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert abs(losses[0] - np.log(pair["cfg"].vocab_size)) < 1.0


# ------------------------------------------------------------------ remat

def _kept_for_backward(pair, policy, monkeypatch):
    """Bytes the forward keeps for the backward: distinct storages packed by
    an outer ``saved_tensors_hooks`` (the tensors saved outside any
    checkpoint; a checkpoint's own hooks take the ones inside), plus the
    matmul outputs the selective policy caches."""
    _, plan = _plans(pair["cfg"], policy)
    storages = {}
    cached = []
    policy_fn = remat.selective_policy

    def counting(ctx, op, *args, **kwargs):
        decision = policy_fn(ctx, op, *args, **kwargs)
        if decision == remat.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            a, b = args[-2], args[-1]
            cached.append(a.shape[0] * b.shape[1] * a.element_size())
        return decision

    def pack(t):
        storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    monkeypatch.setattr(remat, "selective_policy", counting)
    batch = SyntheticDataset(pair["cfg"], SEQ, BATCH).batch(1)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, grads = _value_and_grad(pair["tm"], pair["tp"], batch, plan)
    return sum(storages.values()) + sum(cached), loss, grads


def test_remat_policies_give_the_same_grads_and_keep_less(pair, monkeypatch):
    kept, results = {}, {}
    for policy in ("none", "selective", "full"):
        kept[policy], *results[policy] = _kept_for_backward(pair, policy, monkeypatch)
    assert kept["full"] < kept["selective"] < kept["none"], kept
    base_loss, base = results["none"]
    for policy in ("selective", "full"):
        loss, grads = results[policy]
        assert float(loss) == float(base_loss)
        for a, b in zip(tree_leaves(grads), tree_leaves(base)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch,policy", [("llama3.2-1b", "selective"),
                                         ("moonshot-v1-16b-a3b", "selective"),
                                         ("moonshot-v1-16b-a3b", "full")])
def test_train_step_leaves_no_tensor_in_a_reference_cycle(arch, policy):
    """With the cyclic collector off, the initial parameters (and their
    optimizer state) are freed once two non-donated steps replace them, and
    a collection afterwards finds no tensor: nothing of a step waits for the
    collector to release it (``init_params`` once kept every fresh leaf in
    a closure cycle, ~7.4 GB for moonshot cut to 2 layers)."""
    cfg = get_config(arch).reduced()
    plan = uniform_plan(cfg.name, "t", (1,), ("data",), cfg.num_layers,
                        LayerStrategy(remat=policy), grad_accum=2)
    hp = ttrain.construct_hybrid_parallel_model(build_model(cfg, device="cpu"), plan)
    data = SyntheticDataset(cfg, SEQ, BATCH)
    gc.collect()
    gc.disable()
    try:
        params = hp.init_params(torch.Generator().manual_seed(0))
        opt = hp.init_opt_state(params)
        first = [weakref.ref(t) for t in tree_leaves(params) + tree_leaves(opt.m)]
        for i in range(2):
            params, opt, _ = hp.train_step(params, opt, data.batch(i))
        assert all(ref() is None for ref in first)
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        held = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
        assert not held, [tuple(t.shape) for t in held]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()


def test_selective_policy_saves_only_plain_matmuls():
    aten = torch.ops.aten
    must, prefer = remat.CheckpointPolicy.MUST_SAVE, remat.CheckpointPolicy.PREFER_RECOMPUTE
    assert remat.selective_policy(None, aten.mm.default) == must
    assert remat.selective_policy(None, aten.addmm.default) == must
    for op in (aten.bmm.default, aten.mul.Tensor, aten.exp.default, aten._softmax.default):
        assert remat.selective_policy(None, op) == prefer
    with pytest.raises(ValueError, match="remat"):
        remat.apply_remat(lambda x: x, "most")


@pytest.mark.parametrize("arch", ["qwen3-14b", "qwen2.5-3b"])
def test_kernel_route_on_cpu_gives_the_plain_paths_grads(arch):
    """``impl="kernel"`` on CPU tensors runs K1's and K2's autograd
    functions (plain forwards, recomputing backwards); ``impl="ref"``
    differentiates the plain math.  Same fp32 loss and grads (1e-5), qk-norm
    and qkv biases included."""
    k, r = _pair(arch, "kernel"), _pair(arch, "ref")
    _, plan = _plans(k["cfg"], "selective")
    batch = SyntheticDataset(k["cfg"], SEQ, 2, seed=4).batch(0)
    lk, gk = _value_and_grad(k["tm"], k["tp"], batch, plan)
    lr, gr = _value_and_grad(r["tm"], r["tp"], batch, plan)
    np.testing.assert_allclose(float(lk), float(lr), rtol=1e-6)
    for (path, a), (_, b) in zip(tree_paths(gk), tree_paths(gr)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5, err_msg=str(path))


# ------------------------------------------------------------------ refusals

def test_entry_points_refuse_what_one_device_cannot_run(pair):
    cfg = pair["cfg"]
    _, plan = _plans(cfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ttrain.construct_hybrid_parallel_model(build_model(cfg), plan)
    # a plan over more than one device needs a mesh: none falls back to one
    # device (the parallel runtime's cases: tests/test_torch_parallel_mp*.py)
    tp2 = uniform_plan(cfg.name, "train_4k", (2,), ("model",), cfg.num_layers,
                       LayerStrategy(tp=2))
    with pytest.raises(ValueError, match="needs a mesh"):
        ttrain.construct_hybrid_parallel_model(pair["tm"], tp2)
    with pytest.raises(TypeError, match="ProcessMesh"):
        ttrain.construct_hybrid_parallel_model(pair["tm"], plan, mesh=object())
    dp2 = uniform_plan(cfg.name, "train_4k", (2,), ("data",), cfg.num_layers, LayerStrategy())
    with pytest.raises(ValueError, match="needs a mesh"):
        ttrain.construct_hybrid_parallel_model(pair["tm"], dp2)
    cp2 = uniform_plan(cfg.name, "train_4k", (1,), ("data",), cfg.num_layers,
                       LayerStrategy(cp=2))
    with pytest.raises(ValueError, match="cp up to 2 needs a mesh"):
        ttrain.construct_hybrid_parallel_model(pair["tm"], cp2)
    pp2 = uniform_plan(cfg.name, "train_4k", (1,), ("data",), cfg.num_layers,
                       LayerStrategy(), pp=2)
    with pytest.raises(NotImplementedError, match="runtime.train_pp.PipelineTrainer"):
        ttrain.construct_hybrid_parallel_model(pair["tm"], pp2)
    z3 = uniform_plan(cfg.name, "train_4k", (1,), ("data",), cfg.num_layers,
                      LayerStrategy(zero=3))
    assert ttrain.construct_hybrid_parallel_model(pair["tm"], z3).plan is z3
    for arch in ("mamba2-2.7b", "zamba2-7b", "internvl2-26b"):     # every family trains
        other = build_model(get_config(arch).reduced(), device="cpu")
        assert ttrain.construct_hybrid_parallel_model(other, plan).model is other


def test_softmax_xent_masks_labels_as_jax_does():
    rng = np.random.default_rng(9)
    logits = (3 * rng.standard_normal((2, 7, 11))).astype(np.float32)
    labels = rng.integers(0, 11, (2, 7)).astype(np.int32)
    labels[0, :4] = -1
    jl, jmet = jtrain.softmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    tl, tmet = ttrain.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for key in ("nll", "zloss", "tokens"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-6)
    all_masked = ttrain.softmax_xent(torch.from_numpy(logits), torch.full((2, 7), -1))
    assert float(all_masked[0]) == 0.0
