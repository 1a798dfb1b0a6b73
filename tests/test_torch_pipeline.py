"""The pipeline's pieces without ranks, on the CPU:

* ``stage_stack`` / ``unstage_stack`` against JAX's on the same numpy
  trees, bitwise, at interleave 1, 2 and 3, and the round trip;
* the schedule as data, for a grid of (S, grad_accum, schedule, v) through
  ``tests/_prop.py``: every stage runs each of its window's (microbatch,
  chunk) forwards and backwards once, every forward before its backward,
  each microbatch through the chunks in order (0 .. S·v - 1 forward, back
  down backward), every send met by a receive of the same tick, its
  consumer on a later tick, and ``max_in_flight`` M under gpipe and at
  most S under 1f1b and interleaved;
* ``Mamba2LM.block_apply`` (the uniform block interface) against JAX's at
  reduced width in fp32, train and prefill;
* the refusals, with JAX's exception types where JAX raises (a
  ``ValueError`` where it asserts): MoE, the hybrid and audio families,
  L % S, an interleave that cannot be realised, cp on a non-dense family
  and a cp plan without a mesh.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core.strategy import ExecutionPlan as JPlan
from repro.core.strategy import LayerStrategy as JStrategy
from repro.models import build_model as jax_build_model
from repro.parallel import pipeline as jpipe
from repro.runtime.train_pp import PipelineTrainer as JTrainer
from repro_torch.configs.registry import get_config
from repro_torch.core.strategy import ExecutionPlan, LayerStrategy
from repro_torch.models import build_model
from repro_torch.models.common import params_from_jax, take_layer, tree_paths
from repro_torch.parallel import pipeline
from repro_torch.runtime.train_pp import PipelineTrainer
from tests._prop import given, settings, st
from tests._torch_params import perturbed


def _tree(rng, L):
    return {"a": rng.standard_normal((L, 3, 2)).astype(np.float32),
            "b": {"c": rng.integers(0, 100, (L, 5)).astype(np.int64),
                  "d": rng.standard_normal((L,)).astype(np.float32)}}


@pytest.mark.parametrize("interleave", [1, 2, 3])
def test_stage_stack_is_jaxs_layout(interleave):
    rng = np.random.default_rng(interleave)
    tree = _tree(rng, 12)
    want = jax.tree.map(np.asarray, jpipe.stage_stack(tree, 2, interleave))
    got = pipeline.stage_stack({k: (torch.from_numpy(v) if not isinstance(v, dict) else
                                    {kk: torch.from_numpy(vv) for kk, vv in v.items()})
                                for k, v in tree.items()}, 2, interleave)
    for (path, g), (_, w) in zip(tree_paths(got), tree_paths(want)):
        assert g.shape == w.shape, path
        np.testing.assert_array_equal(g.numpy(), w)
    back = pipeline.unstage_stack(got, interleave)
    jback = jax.tree.map(np.asarray, jpipe.unstage_stack(want, interleave))
    for (path, b), (_, jb), (_, orig) in zip(tree_paths(back), tree_paths(jback),
                                            tree_paths(tree)):
        np.testing.assert_array_equal(b.numpy(), jb)
        np.testing.assert_array_equal(b.numpy(), orig)


def test_stage_stack_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="do not split"):
        pipeline.stage_stack({"a": torch.zeros(6, 2)}, 2, 2)


@settings(max_examples=60, deadline=None)
@given(S=st.integers(2, 5), ga=st.integers(1, 12),
       kind=st.sampled_from(list(pipeline.SCHEDULES)), v=st.integers(2, 3))
def test_schedule_as_data(S, ga, kind, v):
    M = max(ga, S)
    W = pipeline.num_windows(kind, S, M)
    Mw = M // W
    assert W * Mw == M and (W == 1 or (kind != "gpipe" and Mw == S))
    sched = pipeline.build_schedule(kind, S, Mw, v)
    assert sched.interleave == (v if kind == "interleaved" else 1)
    C = S * sched.interleave
    tick_of = {}
    for t, row in enumerate(sched.ticks):
        for s, a in enumerate(row):
            if a is not None:
                assert a.chunk % S == s
                tick_of[(a.kind, a.micro, a.chunk)] = t
    for s in range(S):
        acts = [(a.kind, a.micro, a.chunk) for a in sched.order[s]]
        assert sorted(acts) == sorted((k, m, c) for k in "FB" for m in range(Mw)
                                      for c in range(s, C, S))
        assert [x for row in sched.ticks for x in [row[s]] if x is not None] == \
            list(sched.order[s])
    for m in range(Mw):
        fwd = [tick_of[("F", m, c)] for c in range(C)]
        bwd = [tick_of[("B", m, c)] for c in reversed(range(C))]
        assert fwd == sorted(fwd) and len(set(fwd)) == C
        assert bwd == sorted(bwd) and len(set(bwd)) == C
        for c in range(C):
            assert tick_of[("F", m, c)] < tick_of[("B", m, c)]
    # every send lands on the stage that consumes it, on a later tick; each
    # receive of a tick is a send of that tick
    for t, row in enumerate(sched.ticks):
        for s in range(S):
            for b in sched.arrivals(t, s):
                nxt = (b.kind, b.micro, b.chunk + (1 if b.kind == "F" else -1))
                assert nxt[2] % S == s and tick_of[nxt] > t
                consumer = sched.order[s][[(a.kind, a.micro, a.chunk)
                                           for a in sched.order[s]].index(nxt)]
                assert consumer.recv == b.chunk % S
    # per ordered pair of stages, the receiver expects exactly the sender's messages
    for src in range(S):
        for dst in range(S):
            sent = [(t, a.kind, a.micro, a.chunk) for t, row in enumerate(sched.ticks)
                    for a in [row[src]] if a is not None and a.send == dst]
            got = [(t, b.kind, b.micro, b.chunk) for t in range(len(sched.ticks))
                   for b in sched.arrivals(t, dst) if b.chunk % S == src]
            assert sent == got
    for s in range(S):
        most = sched.max_in_flight(s)
        if kind == "gpipe":
            assert most == M
        else:
            assert most <= S


def test_schedules_run_only_real_work():
    """No garbage lanes: the tick table holds 2·M·v actions a stage, and
    1f1b on 2 stages and 4 microbatches interleaves after one warm-up."""
    sched = pipeline.build_schedule("1f1b", 2, 4)
    order = [(a.kind, a.micro) for a in sched.order[0]]
    assert order == [("F", 0), ("F", 1), ("B", 0), ("F", 2), ("B", 1), ("F", 3), ("B", 2),
                     ("B", 3)]
    assert [(a.kind, a.micro) for a in sched.order[1]] == [
        ("F", 0), ("B", 0), ("F", 1), ("B", 1), ("F", 2), ("B", 2), ("F", 3), ("B", 3)]
    inter = pipeline.build_schedule("interleaved", 2, 2, 2)
    assert [a.chunk for a in inter.order[0]] == [0, 0, 2, 2, 2, 2, 0, 0]
    wrap = next(a for a in inter.order[1] if a.kind == "F" and a.chunk == 1)
    assert wrap.send == 0                    # the wrap from the last stage to the first
    for s in (0, 1):
        assert sum(a is not None for row in inter.ticks for a in [row[s]]) == 2 * 2 * 2


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_mamba2_block_apply_is_jaxs(mode):
    jcfg = jax_get_config("mamba2-2.7b").reduced()
    jm = jax_build_model(jcfg)
    params = perturbed(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3))),
                       np.random.default_rng(3))
    layer = jax.tree.map(lambda a: a[1], params["blocks"])
    x = np.random.default_rng(4).standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    jout, jstate, jzero = jm.block_apply(jax.tree.map(jnp.asarray, layer), jnp.asarray(x),
                                         mode=mode)
    tm = build_model(get_config("mamba2-2.7b").reduced(), device="cpu")
    tlayer = take_layer(params_from_jax(params["blocks"], "cpu"), 1)
    out, state, zero = tm.block_apply(tlayer, torch.from_numpy(x), mode=mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5, rtol=1e-5)
    assert float(zero) == float(jzero) == 0.0 and zero.dtype == torch.float32
    if mode == "train":
        assert state is None and jstate is None
    else:
        for k in ("conv_x", "conv_B", "conv_C", "ssm"):
            np.testing.assert_allclose(state[k].numpy(), np.asarray(jstate[k]),
                                       atol=1e-5, rtol=1e-5)


AXES = ("pod", "data", "model")


def _plans(arch, strategy, schedule="gpipe", v=1, layers=None):
    cfg = get_config(arch).reduced()
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    kw = dict(arch=arch, shape="t", mesh_axes=AXES, mesh_shape=(2, 1, 1), pp=2,
              pp_schedule=schedule, pp_interleave=v, grad_accum=2)
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), num_layers=cfg.num_layers)
    js = JStrategy(**dataclasses.asdict(strategy))
    return (cfg, ExecutionPlan(layer_strategies=[strategy] * cfg.num_layers,
                               default_strategy=strategy, **kw),
            jcfg, JPlan(layer_strategies=[js] * cfg.num_layers, default_strategy=js, **kw))


# name: (arch, strategy, schedule, v, layers, the port's type, its words)
REFUSALS = {
    "moe": ("moonshot-v1-16b-a3b", LayerStrategy(), "gpipe", 1, None,
            "NotImplementedError", "MoE"),
    "hybrid": ("zamba2-7b", LayerStrategy(), "gpipe", 1, None, "ValueError",
               "supports_layer_grouping"),
    "audio": ("whisper-tiny", LayerStrategy(), "gpipe", 1, None, "ValueError",
              "supports_layer_grouping"),
    "layers_mod_stages": ("llama3.2-1b", LayerStrategy(), "gpipe", 1, 3, "ValueError",
                          "3 layers do not split into 2 stages"),
    "interleave": ("llama3.2-1b", LayerStrategy(), "interleaved", 2, None, "ValueError",
                   "virtual chunks"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_keep_jaxs_exception_types(name):
    """JAX's ``PipelineTrainer`` refuses before it reads its mesh, so both
    are built with none: the port raises JAX's type, and a ``ValueError``
    naming ``supports_layer_grouping`` where JAX asserts."""
    arch, strategy, schedule, v, layers, kind, words = REFUSALS[name]
    cfg, plan, jcfg, jplan = _plans(arch, strategy, schedule, v, layers)
    with pytest.raises(Exception) as jerr:
        JTrainer(jax_build_model(jcfg), jplan, None)
    with pytest.raises(Exception) as err:
        PipelineTrainer(build_model(cfg, device="cpu"), plan, None)
    assert type(err.value).__name__ == kind and words in str(err.value), err.value
    jkind = type(jerr.value).__name__
    assert kind == ("ValueError" if jkind == "AssertionError" else jkind), jerr.value


def test_refusals_of_cp_pp1_and_no_mesh():
    """The cp refusals that stay under pp x cp: cp on mamba2 (GALV031, as
    JAX's verifier), a dense cp plan without a mesh; then pp 1 and a plan
    without a mesh."""
    cfg, plan, _, _ = _plans("mamba2-2.7b", LayerStrategy(cp=2))
    with pytest.raises(ValueError, match="GALV031"):
        PipelineTrainer(build_model(cfg, device="cpu"), plan, None)
    cfg, plan, _, _ = _plans("llama3.2-1b", LayerStrategy(cp=2))
    with pytest.raises(ValueError, match="needs a mesh"):
        PipelineTrainer(build_model(cfg, device="cpu"), plan, None)
    cfg, plan, _, _ = _plans("llama3.2-1b", LayerStrategy())
    with pytest.raises(ValueError, match="needs a mesh"):
        PipelineTrainer(build_model(cfg, device="cpu"), plan, None)
    with pytest.raises(ValueError, match="needs pp > 1"):
        PipelineTrainer(build_model(cfg, device="cpu"), dataclasses.replace(plan, pp=1), None)
