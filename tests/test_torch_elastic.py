"""The port's elastic replanning and one-device migration
(``runtime/elastic.py``, ``runtime/resize.py``) against the JAX package's,
in one process:

* ``surviving_mesh``, ``replan_pp_candidates`` and ``replan_cp_candidates``
  equal JAX's over a property sweep of JAX's own ranges;
* ``replan`` gives JAX's plan for reduced llama3.2-1b on 4 / 8 / 12 / 16
  surviving devices at seq 512 and 4096, on a cluster built from JAX's
  ``TPU_V5E_POD`` fields: mesh, strategies, pp, schedule, grad_accum and
  the notes' suffix equal, the predicted step time within 1e-9 relative;
* ``diff_plans`` and ``MigrationSpec.summary()`` equal JAX's on JAX's three
  plan pairs, and ``MigrationReport.summary()`` is JAX's text;
* JAX's one-device regroup migration: the port's ``migrate`` of JAX's state
  (``params_from_jax``) gives canonical trees bitwise JAX's ``migrate``'s,
  bitwise ``migrate_via_checkpoint``'s (sync and async), the canonical
  round trip is bitwise, and the next fp32 steps of both — the in-memory
  one donated — give the same loss and state;
* ``CarryState.carried`` copies the host generator.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jget
from repro.core.cluster import TPU_V5E_POD
from repro.core.strategy import ExecutionPlan as JPlan
from repro.core.strategy import LayerStrategy as JStrategy
from repro.core.strategy import uniform_plan as juniform
from repro.models import build_model as jbuild
from repro.runtime import elastic as jelastic
from repro.runtime import resize as jresize
from repro.runtime.data import SyntheticDataset as JDataset
from repro.runtime.train import construct_hybrid_parallel_model as jconstruct
from repro_torch.configs.registry import get_config
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.strategy import ExecutionPlan, LayerStrategy, uniform_plan
from repro_torch.models import build_model
from repro_torch.models.common import params_from_jax, tree_leaves
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime import elastic, resize
from repro_torch.runtime.data import SyntheticDataset
from repro_torch.runtime.optimizer import AdamWState
from tests._prop import given, settings, st

ARCH = "llama3.2-1b"


# ------------------------------------------------------------ pure planning

@settings(max_examples=60, deadline=None)
@given(devices=st.integers(min_value=1, max_value=512),
       model_axis=st.sampled_from([1, 2, 4, 8, 16]),
       pp=st.sampled_from([1, 2, 4]),
       cp=st.sampled_from([1, 2, 4]),
       batch=st.sampled_from([None, 1, 8, 24, 256]))
def test_surviving_mesh_is_jaxs(devices, model_axis, pp, cp, batch):
    kw = dict(model_axis=model_axis, pp=pp, cp=cp, global_batch=batch)
    assert elastic.surviving_mesh(devices, **kw) == jelastic.surviving_mesh(devices, **kw)


@settings(max_examples=40, deadline=None)
@given(devices=st.integers(min_value=1, max_value=64),
       seq=st.sampled_from([512, 4095, 4096, 6144, 32768]),
       max_deg=st.sampled_from([2, 4, 8]))
def test_replan_candidates_are_jaxs(devices, seq, max_deg):
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget(arch)
        for c, j in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
            assert (elastic.replan_pp_candidates(c, devices, max_pp=max_deg)
                    == jelastic.replan_pp_candidates(j, devices, max_pp=max_deg)), arch
            assert (elastic.replan_cp_candidates(c, seq, devices, max_cp=max_deg)
                    == jelastic.replan_cp_candidates(j, seq, devices, max_cp=max_deg)), arch


def _plan_fields(plan) -> tuple[dict, float, str]:
    d = json.loads(plan.to_json())
    d.pop("predicted_memory")
    return d, d.pop("predicted_step_time"), d.pop("notes").split("|")[-1].strip()


@pytest.mark.parametrize("devices", [4, 8, 12, 16])
@pytest.mark.parametrize("seq", [512, 4096])
def test_replan_is_jaxs(devices, seq):
    cluster = ClusterSpec(**dataclasses.asdict(TPU_V5E_POD))
    event = lambda E: E(32, devices, "prop")
    got = elastic.replan(get_config(ARCH).reduced(), event(elastic.ElasticEvent), seq, 8,
                         cluster=cluster)
    want = jelastic.replan(jget(ARCH).reduced(), event(jelastic.ElasticEvent), seq, 8)
    (gd, gt, gn), (wd, wt, wn) = _plan_fields(got), _plan_fields(want)
    assert gd == wd
    assert gn == wn == f"elastic replan: 32->{devices} (prop)"
    assert abs(gt - wt) <= 1e-9 * abs(wt)
    assert got.num_devices <= devices
    new, spec = elastic.replan_and_diff(get_config(ARCH).reduced(), event(elastic.ElasticEvent),
                                        seq, 8, got, cluster=cluster)
    assert not spec.mesh_changed and new.mesh_shape == got.mesh_shape


def _pairs(mod_plan, mod_uniform, S):
    """JAX's three ``diff_plans`` pairs (tests/test_elastic_resize.py), in
    one package's types."""
    mk = lambda shape, axes, strat, layers=2, **kw: mod_uniform("a", "t", shape, axes, layers,
                                                                strat, **kw)
    strats = [S(remat="selective")] * 2 + [S()] * 2
    return {
        "axes": (mk((4, 2), ("data", "model"), S(tp=2)), mk((1, 4), ("data", "model"), S(tp=4))),
        "restage": (mk((2, 2, 2), ("pod", "data", "model"), S(), pp=2, grad_accum=2),
                    mk((2, 2), ("data", "model"), S())),
        "no restage": (mk((2, 2), ("data", "model"), S()), mk((2, 2), ("data", "model"), S())),
        "regroup": (mk((1,), ("data",), S(), layers=4),
                    mod_plan(arch="a", shape="t", mesh_axes=("data",), mesh_shape=(1,),
                             layer_strategies=strats, default_strategy=strats[0])),
    }


@pytest.mark.parametrize("pair", ["axes", "restage", "no restage", "regroup"])
def test_diff_plans_and_summaries_are_jaxs(pair):
    old, new = _pairs(ExecutionPlan, uniform_plan, LayerStrategy)[pair]
    jold, jnew = _pairs(JPlan, juniform, JStrategy)[pair]
    got, want = resize.diff_plans(old, new), jresize.diff_plans(jold, jnew)
    fields = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == fields
    assert all(getattr(got, f) == getattr(want, f) for f in fields), (got, want)
    assert (got.mesh_changed, got.devices, got.summary()) == (
        want.mesh_changed, want.devices, want.summary())
    for path in ("in-memory", "checkpoint"):
        assert (resize.MigrationReport(got, 0.01234, 4_136_452, path).summary()
                == jresize.MigrationReport(want, 0.01234, 4_136_452, path).summary())


def test_carried_rng_is_a_copy():
    gen = torch.Generator().manual_seed(3)
    torch.rand(2, generator=gen)
    carry = resize.CarryState(step=2, samples_seen=8, rng=gen).carried()
    assert (carry.step, carry.samples_seen) == (2, 8) and carry.rng is not gen
    first = torch.rand(4, generator=gen)           # draws on the old generator ...
    assert torch.equal(torch.rand(4, generator=carry.rng), first)   # ... leave the copy's


# ------------------------------------------------------------ one device

@functools.lru_cache(maxsize=1)
def _jax_state():
    """JAX's test: reduced llama, ga 2, two steps on 4 x 16; then its
    ``migrate`` onto a plan with two remat groups."""
    cfg = jget(ARCH).reduced()
    plan_a = juniform(cfg.name, "t", (1,), ("data",), cfg.num_layers, JStrategy(), grad_accum=2)
    hp_a = jconstruct(jbuild(cfg), plan_a)
    params = hp_a.init_params(jax.random.PRNGKey(0))
    opt = hp_a.init_opt_state(params)
    ds = JDataset(cfg, seq_len=16, global_batch=4)
    step = hp_a.jit_train_step(donate=False)
    for i in range(2):
        params, opt, _ = step(params, opt, {k: jnp.asarray(v) for k, v in ds.batch(i).items()})
    half = cfg.num_layers // 2
    strats = [JStrategy(remat="selective")] * half + [JStrategy()] * (cfg.num_layers - half)
    plan_b = JPlan(arch=cfg.name, shape="t", mesh_axes=("data",), mesh_shape=(1,),
                   layer_strategies=strats, default_strategy=strats[0])
    hp_b = jconstruct(jbuild(cfg), plan_b)
    p_mem, o_mem, _, rep = jresize.migrate(hp_a, hp_b, params, opt,
                                           jresize.CarryState(step=2, samples_seen=8))
    canon = jresize.canonical_state(hp_b, p_mem, o_mem)
    return params, opt, jax.tree.map(np.asarray, canon), rep


def _flat_equal(a, b) -> bool:
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k]) for k in fa)


@pytest.mark.parametrize("async_write", [True, False])
def test_one_device_regroup_migration(async_write, tmp_path):
    jparams, jopt, (jcanon_p, jcanon_o), jrep = _jax_state()
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg, device="cpu")
    to = lambda tree: params_from_jax(jax.tree.map(np.asarray, tree), "cpu")
    params = to(jparams)
    opt = AdamWState(step=torch.tensor(int(jopt.step), dtype=torch.int32), m=to(jopt.m),
                     v=to(jopt.v))
    plan_a = uniform_plan(cfg.name, "t", (1,), ("data",), cfg.num_layers, LayerStrategy(),
                          grad_accum=2)
    half = cfg.num_layers // 2
    strats = [LayerStrategy(remat="selective")] * half + [LayerStrategy()] * (cfg.num_layers - half)
    plan_b = ExecutionPlan(arch=cfg.name, shape="t", mesh_axes=("data",), mesh_shape=(1,),
                           layer_strategies=strats, default_strategy=strats[0])
    hp_a = resize.make_trainer(model, plan_a, None)
    hp_b = resize.make_trainer(model, plan_b, None)

    carry = resize.CarryState(step=2, samples_seen=8)
    p_mem, o_mem, carry_mem, rep_mem = resize.migrate(hp_a, hp_b, params, opt, carry)
    p_ck, o_ck, _, rep_ck = resize.migrate_via_checkpoint(
        hp_a, hp_b, params, opt, carry, directory=str(tmp_path / "ck"), step=2,
        async_write=async_write)
    assert (rep_mem.path, rep_ck.path) == ("in-memory", "checkpoint")
    assert rep_mem.spec.regroup and rep_mem.spec.summary() == jrep.spec.summary()
    assert rep_mem.bytes_moved == rep_ck.bytes_moved == jrep.bytes_moved > 0
    assert (carry_mem.step, carry_mem.samples_seen) == (2, 8)
    assert _flat_equal((p_mem, o_mem), (p_ck, o_ck))
    assert int(o_mem.step) == int(jopt.step) == 2

    # the canonical trees are JAX's, bitwise, and the round trip is exact
    canon_p, canon_o = resize.canonical_state(hp_b, p_mem, o_mem)
    want = ckpt._flatten((jcanon_p, jcanon_o))
    for key, x in ckpt._flatten((canon_p, canon_o)).items():
        np.testing.assert_array_equal(x.numpy(), np.asarray(want[key], dtype=x.numpy().dtype),
                                      err_msg=key)
    assert _flat_equal(resize.canonical_state(hp_b, p_mem, None)[0], hp_a.ungroup(params))

    # both migrated states train on identically; the in-memory one donated
    batch = SyntheticDataset(cfg, seq_len=16, global_batch=4).batch(2)
    p1, o1, m1 = hp_b.train_step(p_mem, o_mem, batch, torch.float32, donate=True)
    p2, o2, m2 = hp_b.train_step(p_ck, o_ck, batch, torch.float32)
    assert torch.equal(m1["loss"], m2["loss"])
    assert _flat_equal((p1, o1), (p2, o2))
    assert all(torch.isfinite(x).all() for x in tree_leaves(p1))
