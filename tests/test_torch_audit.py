"""The port's step audit against the JAX package's, in one process (no
process group):

* ``cost_model.predicted_comm_census`` entry for entry against JAX's, on
  dp, ZeRO 0-3, tp, tp + sp, cp 2, ep 2 and pp 2 with ga 4 over
  ("data", "model"), ("cp", "data", "model") and ("pod", "data", "model");
* the abstract inputs (``models.common.abstract_params``,
  ``runtime.optimizer.abstract_adamw_state``, ``runtime.data.input_specs``)
  with JAX's global shapes and dtypes for every arch and shape;
* each kernel entry's fake path on fake CUDA tensors: its plain version's
  shapes and dtypes, no build, no launch counted, one kernel event;
* GALV091-093 of a traced one-device step equal to JAX's ``audit_jaxpr``
  of ``jax.make_jaxpr(hp.train_step)`` for ``none`` and ``selective``, dense
  and MoE (the existing remat tests hold that the mark that GALV092 reads
  changes nothing a policy saves).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.analysis.jaxpr_audit import audit_jaxpr
from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jget
from repro.configs.shapes import SHAPES as JSHAPES
from repro.core import cost_model as jcm
from repro.core import profiler_model as jpm
from repro.core import strategy as jst
from repro.models import build_model as jbuild
from repro.models.common import abstract_params as jabstract
from repro.runtime import data as jdata
from repro.runtime import optimizer as jopt
from repro.runtime.train import construct_hybrid_parallel_model as jconstruct
from repro_torch.analysis.op_audit import audit_ops
from repro_torch.analysis.step_trace import materialize, trace_step
from repro_torch.configs.registry import get_config as tget
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.core import cost_model as tcm
from repro_torch.core import profiler_model as tpm
from repro_torch.core import strategy as tst
from repro_torch.kernels import _build, _fake
from repro_torch.kernels.flash_attention import ops as k1
from repro_torch.kernels.rmsnorm import ops as k2
from repro_torch.kernels.ssd import ops as k3
from repro_torch.models import build_model as tbuild
from repro_torch.models.common import abstract_params as tabstract
from repro_torch.models.common import tree_paths
from repro_torch.runtime import data as tdata
from repro_torch.runtime import optimizer as topt
from repro_torch.runtime.train import construct_hybrid_parallel_model as tconstruct

# --------------------------------------------------------------------------
# the cost model's census
# --------------------------------------------------------------------------

CENSUS_CASES = [  # (id, arch, mesh axes, devices, pp, grad_accum, strategy kwargs)
    ("dp", "llama3.2-1b", ("data", "model"), 8, 1, 1, {}),
    ("z0-ga2", "llama3.2-1b", ("data", "model"), 8, 1, 2, dict(zero=0)),
    ("z1", "llama3.2-1b", ("data", "model"), 8, 1, 1, dict(zero=1)),
    ("z2", "llama3.2-1b", ("data", "model"), 8, 1, 1, dict(zero=2)),
    ("z3-full", "llama3.2-1b", ("data", "model"), 8, 1, 2, dict(zero=3, remat="full")),
    ("tp", "qwen3-14b", ("data", "model"), 8, 1, 1, dict(tp=2)),
    ("tp-sp-full", "qwen3-14b", ("data", "model"), 8, 1, 2,
     dict(tp=4, sp=True, zero=1, remat="full")),
    ("cp2", "llama3.2-1b", ("cp", "data", "model"), 8, 1, 1, dict(cp=2, zero=2)),
    ("cp2-tp2", "llama3.2-1b", ("cp", "data", "model"), 8, 1, 2,
     dict(cp=2, tp=2, sp=True, zero=1)),
    ("ep2", "moonshot-v1-16b-a3b", ("data", "model"), 8, 1, 1, dict(ep=2, zero=1)),
    ("pp2-ga4", "llama3.2-1b", ("pod", "data", "model"), 8, 2, 4, dict(tp=2, zero=1)),
]


@pytest.mark.parametrize("case", CENSUS_CASES, ids=[c[0] for c in CENSUS_CASES])
def test_predicted_comm_census_matches_jax(case):
    _, arch, axes, devices, pp, ga, kw = case
    seq, batch = 4096, 64
    jprof, tprof = jpm.profile_model(jget(arch), seq), tpm.profile_model(tget(arch), seq)
    n = len(jprof.layers)
    stage_devices = devices // pp
    j = jcm.predicted_comm_census(jprof, [jst.LayerStrategy(**kw)] * n, devices=stage_devices,
                                  micro_batch=batch / ga, grad_accum=ga, pp=pp,
                                  mesh_axes=axes)
    t = tcm.predicted_comm_census(tprof, [tst.LayerStrategy(**kw)] * n, devices=stage_devices,
                                  micro_batch=batch / ga, grad_accum=ga, pp=pp,
                                  mesh_axes=axes)
    assert j, "an empty census proves nothing"
    assert [dataclasses.astuple(e) for e in t] == [dataclasses.astuple(e) for e in j]


# --------------------------------------------------------------------------
# abstract inputs
# --------------------------------------------------------------------------

def _jdesc(tree) -> dict:
    return {"/".join(map(str, path)): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
            for path in [tuple(getattr(k, "key", getattr(k, "name", k)) for k in path)]}


def _tdesc(tree) -> dict:
    out = {}

    def walk(x, prefix):
        if isinstance(x, torch.Tensor):
            out["/".join(prefix)] = (tuple(x.shape), str(x.dtype).replace("torch.", ""))
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, prefix + (str(k),))
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for k, v in zip(x._fields, x):
                walk(v, prefix + (k,))
    walk(tree, ())
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_and_optimizer_state_match_jax(arch):
    jm, tm = jbuild(jget(arch)), tbuild(tget(arch), device="cpu")
    jp, tp = jabstract(jm.param_defs()), tabstract(tm.param_defs())
    assert all(t.device.type == "meta" for _, t in tree_paths(tp))
    assert _tdesc(tp) == _jdesc(jp)
    jo = jopt.abstract_adamw_state(jp, jopt.AdamWConfig())
    to = topt.abstract_adamw_state(tp, topt.AdamWConfig())
    assert _tdesc(to) == _jdesc(jo._asdict())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax(arch):
    jm, tm = jbuild(jget(arch)), tbuild(tget(arch), device="cpu")
    for name, jspec in JSHAPES.items():
        j = jdata.input_specs(jget(arch), jspec, jm)
        t = tdata.input_specs(tget(arch), SHAPES[name], tm)
        assert _tdesc(t) == _jdesc(j), name
        assert all(x.device.type == "meta" for x in _tdesc_tensors(t))


def _tdesc_tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for v in (tree.values() if isinstance(tree, dict) else ()) for t in
            _tdesc_tensors(v)]


# --------------------------------------------------------------------------
# the kernels' fake paths
# --------------------------------------------------------------------------

def _k1(dev):
    q = torch.empty(2, 40, 8, 64, dtype=torch.bfloat16, device=dev)
    k = torch.empty(2, 40, 2, 64, dtype=torch.bfloat16, device=dev)
    return k1.flash_attention_fwd, (q, k, k), {"return_residuals": True}


def _k2(name):
    def make(dev):
        x = torch.empty(3, 5, 256, dtype=torch.bfloat16, device=dev)
        s = torch.empty(256, dtype=torch.float32, device=dev)
        st = torch.empty(3, 5, dtype=torch.float32, device=dev)
        return {"rmsnorm": (k2.rmsnorm, (x, s), {"gate": x}),
                "rmsnorm_backward": (k2.rmsnorm_backward, (x, s, x), {}),
                "rmsnorm_split_sumsq": (k2.rmsnorm_split_sumsq, (x,), {}),
                "rmsnorm_split": (k2.rmsnorm_split, (x, s, st, 512), {}),
                "rmsnorm_split_dot": (k2.rmsnorm_split_dot, (x, s, x, st, 512), {}),
                "rmsnorm_split_backward": (k2.rmsnorm_split_backward,
                                           (x, s, x, st, st, 512), {})}[name]
    return make


def _k3(dev):
    x = torch.empty(2, 100, 4, 64, dtype=torch.bfloat16, device=dev)
    dt = torch.empty(2, 100, 4, dtype=torch.float32, device=dev)
    A = torch.empty(4, dtype=torch.float32, device=dev)
    B = torch.empty(2, 100, 2, 64, dtype=torch.bfloat16, device=dev)
    return k3._ssd_kernel, (x, dt, A, B, B), {"chunk": k3.CHUNK, "initial_state": None}


KERNEL_ENTRIES = {"flash_attention_fwd": _k1, **{n: _k2(n) for n in (
    "rmsnorm", "rmsnorm_backward", "rmsnorm_split_sumsq", "rmsnorm_split",
    "rmsnorm_split_dot", "rmsnorm_split_backward")}, "ssd": _k3}
COUNTERS = (*k1.COUNTERS, *k2.COUNTERS, *k2.SPLIT_COUNTERS, *k3.COUNTERS)


def _shapes(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in outs]


@pytest.mark.parametrize("name", list(KERNEL_ENTRIES))
def test_kernel_fake_path_gives_the_plain_shapes(name, monkeypatch):
    """On fake CUDA tensors each entry returns its plain version's shapes
    and dtypes (the plain version run on small real CPU tensors of the same
    shapes), reaches no build, counts no launch and reports one event."""
    def refuse(*a, **k):
        raise AssertionError("the fake path reached _build.function")

    monkeypatch.setattr(_build, "function", refuse)
    fn, args, kw = KERNEL_ENTRIES[name]("cpu")
    real = [torch.randn(a.shape).to(a.dtype) if isinstance(a, torch.Tensor) else a
            for a in args]
    if name == "ssd":
        plain = k3.ssd(*real)
    elif name in ("flash_attention_fwd",):
        plain = fn(*real, **kw)
    elif name == "rmsnorm":
        plain = fn(*real, gate=real[0])
    else:
        plain = fn(*real, **kw)
    before = [getattr(f, a) for f, a in COUNTERS]
    events = []
    with FakeTensorMode(), _fake.listen(events.append):
        fn, args, kw = KERNEL_ENTRIES[name]("cuda")
        out = fn(*args, **kw)
    assert _shapes(out) == _shapes(plain)
    assert [getattr(f, a) for f, a in COUNTERS] == before
    assert len(events) == 1 and events[0].name == name
    assert events[0].flops > 0 and events[0].bytes > 0


# --------------------------------------------------------------------------
# GALV091-093 against JAX's jaxpr audit on one device
# --------------------------------------------------------------------------

def _single_plans(jcfg, tcfg, remat):
    kw = dict(remat=remat)
    jplan = jst.uniform_plan(jcfg.name, "train", (1,), ("data",), jcfg.num_layers,
                             jst.LayerStrategy(**kw))
    tplan = tst.uniform_plan(tcfg.name, "train", (1,), ("data",), tcfg.num_layers,
                             tst.LayerStrategy(**kw))
    return jplan, tplan


@pytest.mark.parametrize("arch", ["llama3.2-1b", "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("remat", ["none", "selective"])
def test_op_audit_codes_match_jaxpr_audit(arch, remat):
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    spec = ShapeSpec("t", "train", 32, 4)
    jplan, tplan = _single_plans(jcfg, tcfg, remat)
    jhp = jconstruct(jbuild(jcfg), jplan)
    jargs = (jhp.abstract_params(), jhp.abstract_opt_state(),
             jdata.input_specs(jcfg, dataclasses.replace(JSHAPES["train_4k"], seq_len=32,
                                                        global_batch=4), jhp.model))
    jcodes = sorted(d.code for d in audit_jaxpr(jax.make_jaxpr(jhp.train_step)(*jargs), jplan))
    hp = tconstruct(tbuild(tcfg, device="cpu"), tplan)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = materialize(hp.abstract_params(), "cpu")
        opt = materialize(hp.abstract_opt_state(), "cpu")
        batch = materialize(tdata.input_specs(tcfg, spec, hp.model), "cpu")
        tr = trace_step(lambda: hp.train_step(params, opt, batch, donate=True),
                        (params, opt, batch))
    tcodes = sorted(d.code for d in audit_ops(tr.ops.summary(), tplan))
    assert tcodes == jcodes
    if remat == "selective":
        assert tr.ops.summary().remat_dots > 0


@pytest.mark.parametrize("arch", ["llama3.2-1b", "internvl2-26b", "mamba2-2.7b"])
def test_engine_abstract_params_are_jaxs_in_bf16(arch):
    """``ServingEngine.abstract_params`` off a mesh: JAX's serving tree,
    every floating leaf in bf16 (``repro.runtime.serve``'s rule)."""
    from repro_torch import serving

    cfg = tget(arch)
    engine = serving.step_engine(tbuild(cfg, device="cpu"), serving.single_device_plan(cfg),
                                 device="cpu")
    jtree = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, jnp.bfloat16)
                         if jnp.issubdtype(a.dtype, jnp.floating) else a,
                         jabstract(jbuild(jget(arch)).param_defs()))
    assert _tdesc(engine.abstract_params()) == _jdesc(jtree)
