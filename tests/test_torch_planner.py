"""The port's planner (``repro_torch.core`` search, cost and memory models,
decision tree, dynamic program, ``analysis.plan_check``) against the JAX
package's on the CPU: the same inputs go to both, compared field by field.

* ``SearchEngine.search`` for every arch at full size on three clusters —
  one H100 at mesh (1, 1), the 16-card H100 preset at (2, 8), and the TPU
  pod's spec (built from the JAX preset's fields) at (16, 16) — with the
  analytic calibration and with one measured from a synthetic profile
  cache: the same feasibility, plan (grad_accum, pp, schedule, mesh, every
  layer's strategy), rejection counts, and predicted step time and memory
  within a relative 1e-9; plus a free-mode search with pp options (the
  bf16-Adam retry runs for grok-1-314b on the pod, infeasible in both);
* ``profile_model`` per layer for every family; the cost and memory models
  per layer on a grid of strategies and environments; the decision tree's
  candidates and Pareto pruning; the dynamic program;
* ``check_plan``'s codes on the JAX verifier's failing/passing fixtures;
* ``search_serve``'s choice on one H100 and on the 16-card preset.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro.analysis import plan_check as jpc
from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jget
from repro.core import calibrate as jcal
from repro.core import cluster as jcluster
from repro.core import cost_model as jcm
from repro.core import decision_tree as jdt
from repro.core import dynamic_programming as jdp
from repro.core import memory_model as jmm
from repro.core import profile_cache as jpcache
from repro.core import profiler_model as jpm
from repro.core import search as jsearch
from repro.core import strategy as jst
from repro_torch.analysis import plan_check as tpc
from repro_torch.configs.registry import get_config as tget
from repro_torch.core import calibrate as tcal
from repro_torch.core import cluster as tcluster
from repro_torch.core import cost_model as tcm
from repro_torch.core import decision_tree as tdt
from repro_torch.core import dynamic_programming as tdp
from repro_torch.core import memory_model as tmm
from repro_torch.core import profile_cache as tpcache
from repro_torch.core import profiler_model as tpm
from repro_torch.core import search as tsearch
from repro_torch.core import strategy as tst
from tests.test_plan_verifier import PAIRS

REL = 1e-9
SEQ, BATCH = 4096, 256
POD = jcluster.TPU_V5E_POD


def _pair_cluster(spec):
    """(jax, torch) ClusterSpec with the fields of ``spec`` (either package's)."""
    fields = dataclasses.asdict(spec)
    return jcluster.ClusterSpec(**fields), tcluster.ClusterSpec(**fields)


CLUSTERS = {   # name -> (spec, mesh shape over ("data", "model"), global batch)
    "h100-1": (tcluster.H100_1, (1, 1), 8),
    "h100-16": (tcluster.H100_NODE8, (2, 8), 64),
    "tpu-pod": (POD, (16, 16), BATCH),
}


@pytest.fixture(scope="module")
def calibrations(tmp_path_factory):
    """{"analytic": (jax, torch), "measured": (jax, torch)}: the measured pair
    is each package's ``calibrate`` of one synthetic cache file, written by
    the port (cells of llama3.2-1b and qwen3-14b in bf16 and fp32, and an
    8-device all-reduce fit)."""
    path = tmp_path_factory.mktemp("cal") / "cuda.json"
    cache = tpcache.ProfileCache(path=path)
    rng = np.random.default_rng(0)
    for arch in ("llama3.2-1b", "qwen3-14b"):
        cfg = tget(arch)
        for dtype, thr in (("bf16", 2.9e14), ("fp32", 4.1e13)):
            for seq, mb in ((1024, 2), (4096, 2), (4096, 1)):
                lp = tpm.profile_model(cfg, seq).layers[0]
                fwd = lp.flops * mb / thr * (1.0 + 0.05 * rng.standard_normal())
                act = (lp.act_inner + lp.act_boundary) * mb
                cache.put(tpcache.ProfileEntry(
                    key=tpcache.ProfileKey("cuda", tpcache.model_key(cfg), dtype, 1, 1, seq, mb),
                    fwd_time_s=fwd, bwd_time_s=fwd * (2.7 + 0.1 * rng.standard_normal()),
                    remat_extra_s=fwd * 0.9, peak_bytes=act * (1.6 + 0.1 * rng.random()),
                    flops_fwd=lp.flops * mb, act_bytes_pred=act, iters=3))
    cache.put_comm(tpcache.CommEntry("cuda", "bf16", 8, alpha=3e-5, beta=1 / 2.1e11, r2=0.99))
    cache.save()
    jc = jcal.calibrate(jpcache.ProfileCache.load(path))
    tc = tcal.calibrate(tpcache.ProfileCache.load(path))
    assert tc.source == jc.source == "measured"
    return {"analytic": (jcal.DEFAULT_CALIBRATION, tcal.DEFAULT_CALIBRATION),
            "measured": (jc, tc)}


def _plan_dict(plan):
    d = json.loads(plan.to_json())
    floats = {k: d.pop(k) for k in ("predicted_step_time", "predicted_memory")}
    return d, floats


def assert_same_search(jres, tres):
    assert tres.feasible == jres.feasible
    assert tres.evaluated == jres.evaluated
    assert tres.rejections == jres.rejections
    (jd, jf), (td, tf) = _plan_dict(jres.plan), _plan_dict(tres.plan)
    assert td == jd
    for k in jf:
        assert tf[k] == pytest.approx(jf[k], rel=REL), k


# ---------------------------------------------------------------- search

@pytest.mark.parametrize("cal", ["analytic", "measured"])
@pytest.mark.parametrize("cluster", list(CLUSTERS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_search_matches_jax(arch, cluster, cal, calibrations):
    spec, mesh, batch = CLUSTERS[cluster]
    jspec, tspec = _pair_cluster(spec)
    jcalib, tcalib = calibrations[cal]
    kw = dict(mesh_shape=mesh, mesh_axes=("data", "model"), arch=arch, shape_name="t")
    jres = jsearch.SearchEngine(jget(arch), jspec, calibration=jcalib).search(SEQ, batch, **kw)
    tres = tsearch.SearchEngine(tget(arch), tspec, calibration=tcalib).search(SEQ, batch, **kw)
    assert_same_search(jres, tres)
    if arch == "grok-1-314b" and cluster == "tpu-pod":
        # fp32 Adam states fit nowhere on one pod, so both retry with bf16
        # m/v (opt_bytes 4), which fits nowhere either: the flagged fallback
        assert not tres.feasible and tres.plan.predicted_step_time == float("inf")


@pytest.mark.parametrize("cal", ["analytic", "measured"])
def test_free_mode_search_with_pp_options_matches_jax(cal, calibrations):
    jspec, tspec = _pair_cluster(tcluster.H100_NODE8)
    jcalib, tcalib = calibrations[cal]
    kw = dict(mesh_shape=(2, 8), mesh_axes=("data", "model"), mesh_constrained=False,
              pp_options=[1, 2, 4], arch="llama3.2-1b")
    jres = jsearch.SearchEngine(jget("llama3.2-1b"), jspec,
                                calibration=jcalib).search(SEQ, 64, **kw)
    tres = tsearch.SearchEngine(tget("llama3.2-1b"), tspec,
                                calibration=tcalib).search(SEQ, 64, **kw)
    assert_same_search(jres, tres)


def test_defaults_name_one_card():
    """The port's engine and entry point default to one H100 and a (1, 1)
    mesh, where the JAX package's name the TPU pod."""
    import inspect

    from repro_torch import core

    cfg = tget("llama3.2-1b")
    eng = tsearch.SearchEngine(cfg)
    assert eng.cluster is tcluster.H100_1 and eng.cluster.chips == 1
    assert inspect.signature(eng.search).parameters["mesh_shape"].default == (1, 1)
    plan = core.get_hybrid_parallel_configs(cfg, SEQ, 8)
    assert plan.num_devices == 1
    assert tpc.check_plan(plan, tcluster.H100_1, cfg, seq_len=SEQ, global_batch=8).ok()
    assert not any("tpu" in name for name in tcluster.CLUSTERS)


# ---------------------------------------------------------------- lower layers

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_profile_model_matches_jax(arch):
    assert dataclasses.asdict(tget(arch)) == dataclasses.asdict(jget(arch))
    for causal_frac in (1.0, 0.5):
        j = jpm.profile_model(jget(arch), SEQ, causal_frac=causal_frac)
        t = tpm.profile_model(tget(arch), SEQ, causal_frac=causal_frac)
        assert [dataclasses.asdict(lp) for lp in t.layers] == \
            [dataclasses.asdict(lp) for lp in j.layers]
        for f in ("embed_params", "head_flops", "logits_bytes", "d_model", "seq_len"):
            assert getattr(t, f) == getattr(j, f), f
        assert t.total_params() == j.total_params()
        assert t.model_flops_per_token() == j.model_flops_per_token()


def _strategy_grid(cfg):
    out = []
    for tp in (1, 2, 8):
        for zero in (0, 1, 2, 3):
            for remat in ("none", "selective", "full"):
                out.append(dict(tp=tp, zero=zero, remat=remat))
                if tp > 1:
                    out.append(dict(tp=tp, sp=True, zero=zero, remat=remat))
    out += [dict(cp=2, zero=1), dict(tp=2, cp=4, remat="full", zero=3)]
    if cfg.num_experts:
        out += [dict(ep=4, zero=1), dict(tp=2, ep=2, zero=3, remat="selective")]
    return out


ENVS = [  # CostEnv fields besides cluster and calibration
    dict(devices=16, pp=1, micro_batch=8, grad_accum=4),
    dict(devices=8, pp=2, micro_batch=8, grad_accum=4, pp_schedule="1f1b"),
    dict(devices=8, pp=4, micro_batch=4, grad_accum=8, pp_schedule="interleaved",
         pp_interleave=2, opt_bytes=4.0),
    dict(devices=1, pp=1, micro_batch=2, grad_accum=4),
]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-14b", "grok-1-314b",
                                  "mamba2-2.7b", "zamba2-7b", "whisper-tiny",
                                  "internvl2-26b"])
def test_cost_and_memory_models_match_jax(arch, calibrations):
    jprof = jpm.profile_model(jget(arch), SEQ, causal_frac=0.5)
    tprof = tpm.profile_model(tget(arch), SEQ, causal_frac=0.5)
    kinds = {}
    for i, lp in enumerate(tprof.layers):
        kinds.setdefault(lp.kind, i)
    for cal_name, (jcalib, tcalib) in calibrations.items():
        for env_kw in ENVS:
            jspec, tspec = _pair_cluster(tcluster.H100_NODE8)
            jenv = jcm.CostEnv(cluster=jspec, calibration=jcalib, **env_kw)
            tenv = tcm.CostEnv(cluster=tspec, calibration=tcalib, **env_kw)
            for s_kw in _strategy_grid(tget(arch)):
                js, ts = jst.LayerStrategy(**s_kw), tst.LayerStrategy(**s_kw)
                where = (cal_name, env_kw, s_kw)
                for i in kinds.values():
                    jl, tl = jprof.layers[i], tprof.layers[i]
                    for fn in ("layer_step_time", "compute_time", "tp_comm_time",
                               "cp_comm_time", "dp_comm_time", "ep_comm_time"):
                        assert getattr(tcm, fn)(tl, ts, tenv) == pytest.approx(
                            getattr(jcm, fn)(jl, js, jenv), rel=REL), (fn, where)
                    for fn in ("layer_memory", "layer_state_bytes", "layer_act_bytes"):
                        assert getattr(tmm, fn)(tl, ts, tenv) == pytest.approx(
                            getattr(jmm, fn)(jl, js, jenv), rel=REL), (fn, where)
                for fn, jargs, targs in (
                        ("head_time", (jprof, js, jenv), (tprof, ts, tenv)),
                        ("pipeline_extras", (jprof, jenv, 1e-3, js), (tprof, tenv, 1e-3, ts))):
                    assert getattr(tcm, fn)(*targs) == pytest.approx(
                        getattr(jcm, fn)(*jargs), rel=REL), (fn, where)
                assert tmm.fixed_memory(tprof, ts, tenv) == pytest.approx(
                    jmm.fixed_memory(jprof, js, jenv), rel=REL), where
                assert tmm.plan_memory(tprof, [ts] * len(tprof.layers), tenv) == \
                    pytest.approx(jmm.plan_memory(jprof, [js] * len(jprof.layers), jenv),
                                  rel=REL), where
                other_j, other_t = jst.LayerStrategy(tp=8, sp=True), tst.LayerStrategy(tp=8, sp=True)
                assert tcm.transition_time(ts, other_t, tprof.layers[0], tenv) == \
                    pytest.approx(jcm.transition_time(js, other_j, jprof.layers[0], jenv),
                                  rel=REL), where
        for tp in (1, 2, 8):
            jspec, tspec = _pair_cluster(tcluster.H100_NODE8)
            for fn, kw in (("decode_step_time", dict(kv_len=2048, tp=tp, batch=32)),
                           ("prefill_time", dict(prompt_len=1024, tp=tp))):
                jv = getattr(jcm, fn)(jprof, jspec, calibration=jcalib, **kw)
                tv = getattr(tcm, fn)(tprof, tspec, calibration=tcalib, **kw)
                if fn == "decode_step_time":
                    jv, tv = dataclasses.asdict(jv), dataclasses.asdict(tv)
                assert tv == jv, (fn, cal_name, tp)
    assert tmm.kv_cache_bytes(tget(arch), 8, SEQ) == jmm.kv_cache_bytes(jget(arch), 8, SEQ)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-14b", "grok-1-314b",
                                  "mamba2-2.7b", "zamba2-7b"])
def test_decision_tree_matches_jax(arch):
    def as_tuples(strats):
        return [tuple(sorted(dataclasses.asdict(s).items())) for s in strats]

    for devices, kw in ((1, {}), (16, dict(max_tp=8)),
                        (256, dict(max_tp=16, mesh_constrained_tp=16, mesh_data_axis=16)),
                        (64, dict(max_tp=8, seq_len=SEQ, max_cp=4)),
                        (64, dict(max_tp=8, seq_len=SEQ, mesh_constrained_cp=2,
                                  mesh_constrained_tp=8))):
        for kind in ("attn_block", "moe_block", "mamba_block"):
            j = jdt.candidate_strategies(jget(arch), devices, layer_kind=kind, **kw)
            t = tdt.candidate_strategies(tget(arch), devices, layer_kind=kind, **kw)
            assert as_tuples(t) == as_tuples(j), (devices, kw, kind)
    rng = np.random.default_rng(1)
    strats = tdt.candidate_strategies(tget(arch), 16, max_tp=8)
    times, mems = list(rng.random(len(strats))), list(rng.random(len(strats)))
    jstrats = [jst.LayerStrategy(**dataclasses.asdict(s)) for s in strats]
    assert tdt.prune_dominated(strats, times, mems) == jdt.prune_dominated(jstrats, times, mems)


@pytest.mark.parametrize("seed", range(4))
def test_dynamic_program_matches_jax(seed):
    rng = np.random.default_rng(seed)
    L, C = 24, 6
    times = rng.random((L, C)) + 0.1
    mems = rng.random((L, C)) * 1e9
    trans = rng.random((C, C)) * 1e-2
    np.fill_diagonal(trans, 0.0)
    for budget in (4e9, 12e9, 30e9):
        j = jdp.optimize(times, mems, budget, trans, n_buckets=256)
        t = tdp.optimize(times, mems, budget, trans, n_buckets=256)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for pp, ga in ((1, 1), (2, 4), (4, 2), (4, 8)):
        assert tdp.schedule_space(pp, ga, 24) == jdp.schedule_space(pp, ga, 24)


# ---------------------------------------------------------------- plan_check

def _to_torch(obj):
    """The port's twin of one of the JAX verifier's fixtures' values."""
    if isinstance(obj, jst.ExecutionPlan):
        return tst.ExecutionPlan.from_json(obj.to_json())
    if isinstance(obj, jcal.Calibration):
        return tcal.Calibration(**dataclasses.asdict(obj))
    if isinstance(obj, jpc.ServeSpec):
        return tpc.ServeSpec(**dataclasses.asdict(obj))
    if dataclasses.is_dataclass(obj) and type(obj).__name__ == "ModelConfig":
        return tget(obj.name)
    return obj


@pytest.mark.parametrize("code,bad,good", PAIRS,
                         ids=[f"{c}-{i}" for i, (c, _, _) in enumerate(PAIRS)])
def test_check_plan_codes_match_jax(code, bad, good):
    """The JAX verifier's failing and passing fixture of each code give the
    same diagnostics (code, severity, where) in both packages."""
    jspec, tspec = _pair_cluster(POD)
    for plan, kw in (bad, good):
        kw = dict(kw)
        cfg = kw.pop("cfg", jget("qwen3-14b"))
        kw.setdefault("seq_len", SEQ)
        j = jpc.check_plan(plan, jspec, cfg, **kw)
        t = tpc.check_plan(_to_torch(plan), tspec, _to_torch(cfg),
                           **{k: _to_torch(v) for k, v in kw.items()})
        assert [(d.code, d.severity, d.where, d.message) for d in t.diagnostics] == \
            [(d.code, d.severity, d.where, d.message) for d in j.diagnostics]
    assert code in tpc.CATALOG


def test_catalog_is_jaxs_less_the_auditor_codes():
    assert set(tpc.CATALOG) == {c for c in jpc.CATALOG if not c.startswith("GALV09")}
    for code, entry in tpc.CATALOG.items():
        assert entry == jpc.CATALOG[code]


def test_galv020_in_flight_memory_matches_jax():
    """The schedule-aware memory check (GALV020) on the PR-2 GPipe shape and
    its 1f1b twin, with a profile."""
    cfg = "qwen3-14b"
    jspec, tspec = _pair_cluster(POD)
    for sched in ("gpipe", "1f1b"):
        jplan = jst.uniform_plan(cfg, "t", (4, 4, 16), ("pod", "data", "model"), 40,
                                 jst.LayerStrategy(tp=16, zero=3, remat="full"), pp=4,
                                 grad_accum=32, pp_schedule=sched)
        j = jpc.check_plan(jplan, jspec, jget(cfg), seq_len=SEQ, global_batch=BATCH,
                           profile=jpm.profile_model(jget(cfg), SEQ))
        t = tpc.check_plan(_to_torch(jplan), tspec, tget(cfg), seq_len=SEQ,
                           global_batch=BATCH, profile=tpm.profile_model(tget(cfg), SEQ))
        assert t.codes() == j.codes()
        assert t.error_codes() == (["GALV020"] if sched == "gpipe" else [])


def test_boundary_dtype_mismatch_detected(monkeypatch):
    """GALV040 (the mirror of JAX's test of that name): the cost model's
    boundary bytes per element against the pipeline's ``BOUNDARY_DTYPE`` —
    none at 4 B, an error once the cost model's constant drifts to 2."""
    from repro_torch.core import cost_model as tcm

    plan = tst.uniform_plan("qwen3-14b", "t", (2, 8, 16), ("pod", "data", "model"), 40,
                            tst.LayerStrategy(tp=16), pp=2, grad_accum=2)
    check = lambda: tpc.check_plan(plan, tcluster.ClusterSpec(**dataclasses.asdict(POD)),
                                   tget("qwen3-14b"), seq_len=SEQ)
    assert tpc._boundary_dtype_diag() is None
    assert "GALV040" not in check().codes()
    monkeypatch.setattr(tcm, "PIPELINE_BOUNDARY_BYTES_PER_ELEM", 2.0)
    assert "GALV040" in check().error_codes()


# ---------------------------------------------------------------- search_serve

@pytest.mark.parametrize("cluster", ["h100-1", "h100-16"])
@pytest.mark.parametrize("arch", ["qwen3-14b", "llama3.2-1b"])
def test_search_serve_matches_jax(arch, cluster):
    jspec, tspec = _pair_cluster(CLUSTERS[cluster][0])
    kw = dict(max_context=4096, prompt_len=1024)
    j = jsearch.SearchEngine(jget(arch), jspec).search_serve(**kw)
    t = tsearch.SearchEngine(tget(arch), tspec).search_serve(**kw)
    assert (t.feasible, t.evaluated, t.rejections) == (j.feasible, j.evaluated, j.rejections)
    assert [dataclasses.asdict(c) for c in t.candidates] == \
        [dataclasses.asdict(c) for c in j.candidates]
    assert t.choice is not None and dataclasses.asdict(t.choice) == dataclasses.asdict(j.choice)
    if cluster == "h100-1":
        assert t.choice.tp == 1          # one card: its fast domain is itself
