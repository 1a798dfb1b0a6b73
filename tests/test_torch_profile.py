"""The port's profiler, profile cache and launchers on the CPU, at reduced
width (``device="cpu"``: the kernels' plain versions):

* ``measure_block`` returns positive times and, off the card, no peak
  memory, for dense, vlm, moe, mamba2 and zamba2 blocks with JAX's FLOP
  bases; the moe block's fp32 grads match ``jax.grad`` of JAX's
  ``block_apply`` loss on the same weights (2e-3 of each grad's scale);
  the audio family raises, as JAX's ``measure_block`` does; the compiled
  steps (``compile_step``'s plumbing on the CPU) give the eager steps'
  outputs and grads bitwise, for every family measured;
* a profile cache written by either package loads in the other and fits an
  equal calibration (1e-12); a second profiling pass measures nothing and a
  stale schema is reset;
* moonshot's search on one H100 at 48 layers (infeasible) and cut to 2
  layers is JAX's, analytic and calibrated;
* ``launch.train`` trains two steps with finite losses, builds the plan the
  JAX launcher builds for the same flags, prices it as JAX's cost model does
  on the same one-H100 spec, and ``--validate-only`` exits with JAX's
  ``check_plan`` verdict; ``launch.profile`` measures, then reads its cache;
  ``launch.serve search`` makes JAX's choice; without ``--device`` and
  without a GPU the entry points raise.
"""
import dataclasses
import json
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import plan_check as jpc
from repro.configs.registry import get_config as jget
from repro.core import calibrate as jcal
from repro.core import cluster as jcluster
from repro.core import profile_cache as jpcache
from repro.core import profiler_model as jpm
from repro.core import search as jsearch
from repro.core.strategy import LayerStrategy as JLayerStrategy
from repro.core.strategy import uniform_plan as juniform_plan
from repro.models import build_model as jbuild_model
from repro.models.common import init_params as jinit_params
from repro_torch.configs.registry import get_config
from repro_torch.core import calibrate as tcal
from repro_torch.core import cluster as tcluster
from repro_torch.core import profile_cache as tpcache
from repro_torch.core import profiler_model as tpm
from repro_torch.launch import profile as profile_cli
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models.common import params_from_jax, tree_paths
from tests._torch_params import perturbed

ARCH = "llama3.2-1b"
JAX_H100_1 = jcluster.ClusterSpec(**dataclasses.asdict(tcluster.H100_1))


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda entry points run there")


# ---------------------------------------------------------------- measure_block

def test_measure_block_on_cpu_times_the_block_and_reads_no_peak():
    cfg = get_config(ARCH).reduced()
    tpm.measure_block(cfg, 16, device="cpu", iters=1, with_remat=False)   # warm the process
    m = tpm.measure_block(cfg, 64, batch=2, iters=5, device="cpu")
    assert m.fwd_time_s > 0.0 and m.bwd_time_s > 0.0 and m.remat_extra_s >= 0.0
    assert m.peak_bytes == 0.0
    lp = jpm.profile_model(jget(ARCH).reduced(), 64, causal_frac=1.0).layers[0]
    assert m.flops_fwd == lp.flops * 2
    assert m.act_bytes_pred == (lp.act_inner + lp.act_boundary) * 2
    assert m.iters == 5
    assert tpm.measure_block_time(cfg, 32, iters=2, device="cpu") > 0.0


@pytest.mark.parametrize("arch", ["internvl2-26b", "mamba2-2.7b", "zamba2-7b"])
def test_measure_block_times_the_vlm_ssm_and_hybrid_blocks(arch):
    """JAX's branches: a vlm model measures its decoder block, mamba2 and
    zamba2 a Mamba2 block (K3 and the gate norm under autograd in the
    grad); the FLOP and activation bases are JAX's first profiled layer."""
    cfg = get_config(arch).reduced()
    m = tpm.measure_block(cfg, 32, batch=2, iters=1, device="cpu")
    assert m.fwd_time_s > 0.0 and m.bwd_time_s >= 0.0 and m.remat_extra_s >= 0.0
    assert m.peak_bytes == 0.0
    lp = jpm.profile_model(jget(arch).reduced(), 32, causal_frac=1.0).layers[0]
    assert m.flops_fwd == lp.flops * 2
    assert m.act_bytes_pred == (lp.act_inner + lp.act_boundary) * 2


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "grok-1-314b"])
def test_measure_block_times_the_moe_block(arch):
    """JAX's moe branch (``block_defs`` / ``block_apply``): positive times,
    the FLOP and activation bases of JAX's ``_moe_block``."""
    cfg = get_config(arch).reduced()
    m = tpm.measure_block(cfg, 32, batch=2, iters=1, device="cpu")
    assert m.fwd_time_s > 0.0 and m.bwd_time_s >= 0.0 and m.remat_extra_s >= 0.0
    assert m.peak_bytes == 0.0
    lp = jpm.profile_model(jget(arch).reduced(), 32, causal_frac=1.0).layers[0]
    assert lp.kind == "moe_block"
    assert m.flops_fwd == lp.flops * 2
    assert m.act_bytes_pred == (lp.act_inner + lp.act_boundary) * 2


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "grok-1-314b"])
def test_moe_block_grads_match_jax(arch):
    """The measured moe block's fp32 grads (``_grad_fn`` of the port's
    ``block_apply``) against ``jax.grad`` of JAX's ``sum(block_apply(p,
    x)[0])`` on the same weights and a seeded input: 2e-3 of each grad's
    largest magnitude; the block's outputs 1e-4."""
    jcfg = jget(arch).reduced()
    jm = jbuild_model(jcfg)
    np_params = perturbed(jax.tree.map(np.asarray, jinit_params(jm.block_defs(),
                                                                jax.random.PRNGKey(0))),
                          np.random.default_rng(0))
    x = np.random.default_rng(1).standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, np_params)
    apply_j = lambda p: jm.block_apply(p, jnp.asarray(x), mode="train")[0]
    want_y = np.asarray(apply_j(jp))
    want = jax.grad(lambda p: jnp.sum(apply_j(p).astype(jnp.float32)))(jp)

    _, apply = tpm._block_apply_fn(get_config(arch).reduced(), "cpu", "fp32")
    tp = params_from_jax(np_params, "cpu", torch.float32)
    y = apply(tp, torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), want_y, atol=1e-4, rtol=1e-4)
    got = tpm._grad_fn(apply)(tp, torch.from_numpy(x))
    wanted = dict(tree_paths(jax.tree.map(np.asarray, want)))
    assert len(got) == len(wanted)
    for (path, _), g in zip(tree_paths(tp), got):
        w = wanted[path]
        err = np.abs(g.numpy() - w).max()
        assert err <= 2e-3 * np.abs(w).max(), (path, err, np.abs(w).max())


@pytest.mark.parametrize("arch", ["whisper-tiny"])
def test_measure_block_takes_dense_blocks_only(arch):
    """The audio family has no block to measure in either package: JAX's
    ``measure_block`` reaches ``block_apply``, which ``EncDecLM`` lacks."""
    with pytest.raises(AttributeError, match="block_apply"):
        jpm.measure_block(jget(arch).reduced(), 32, iters=1, with_remat=False)
    with pytest.raises(NotImplementedError, match="EncDecLM lacks"):
        tpm.measure_block(get_config(arch).reduced(), 32, device="cpu")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "internvl2-26b", "mamba2-2.7b",
                                  "zamba2-7b", "moonshot-v1-16b-a3b"])
def test_compiled_block_steps_are_the_eager_steps(arch):
    """``block_steps(compiled=True)`` on the CPU (``compile_step``'s
    plumbing: parameters held, ``x`` fed through a static buffer, direct
    calls) against ``compiled=False``: the forward and both grads bitwise,
    twice over (a later call replays the same key)."""
    cfg = get_config(arch).reduced()
    steps = {c: tpm.block_steps(cfg, 32, batch=2, dtype="fp32", device="cpu", compiled=c,
                                input_seed=3) for c in (True, False)}
    eager = steps[False]
    for _ in range(2):
        for name in ("forward", "grad", "grad_remat"):
            got = getattr(steps[True], name)(steps[True].params, steps[True].x)
            want = getattr(eager, name)(eager.params, eager.x)
            got, want = (t if isinstance(t, tuple) else (t,) for t in (got, want))
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                assert torch.equal(a, b), (arch, name)
    assert len(steps[True].grad.entries) == 1


# ---------------------------------------------------------------- cache + calibration

def _fake_measure(cfg, seq, *, batch, iters, dtype, with_remat):
    """A deterministic stand-in for the block measurement: no clock enters
    the cross-package comparison."""
    lp = tpm.profile_model(cfg, seq, causal_frac=1.0).layers[0]
    thr = {"bf16": 3.1e14, "fp32": 4.3e13}[dtype] * (1.0 - seq / 1e5)
    fwd = lp.flops * batch / thr
    act = (lp.act_inner + lp.act_boundary) * batch
    return tpm.BlockMeasurement(
        fwd_time_s=fwd, bwd_time_s=fwd * (2.5 + seq / 1e4),
        remat_extra_s=fwd * (0.8 + batch / 10) if with_remat else 0.0,
        peak_bytes=act * (1.3 + seq / 1e4), flops_fwd=lp.flops * batch,
        act_bytes_pred=act, iters=iters)


def _cells(pcache, backend, archs=(ARCH, "qwen3-14b")):
    out = []
    for arch in archs:
        cfg = get_config(arch)
        for dt in ("bf16", "fp32"):
            for seq, mb in ((512, 1), (1024, 2), (4096, 2)):
                out.append((cfg, pcache.ProfileKey(backend, pcache.model_key(cfg), dt,
                                                   1, 1, seq, mb)))
    return out


def _assert_same_calibration(a, b):
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.keys() == db.keys()
    for k in da:
        if isinstance(da[k], dict) and k != "provenance":
            assert da[k].keys() == db[k].keys(), k
            for kk in da[k]:
                assert da[k][kk] == pytest.approx(db[k][kk], rel=1e-12), (k, kk)
        elif isinstance(da[k], float):
            assert da[k] == pytest.approx(db[k], rel=1e-12), k
        else:
            assert da[k] == db[k], k


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_profile_cache_crosses_between_packages(writer, tmp_path):
    """A cache one package writes loads in the other, entry for entry, and
    both fit the same calibration from it."""
    path = tmp_path / "cuda.json"
    w_pcache, w_cal = (tpcache, tcal) if writer == "torch" else (jpcache, jcal)
    cache = w_pcache.ProfileCache.load_or_create(path)
    n, cached = w_cal.run_profile_cells(_cells(w_pcache, "cuda"), cache, iters=3,
                                        measure_fn=_fake_measure)
    assert (n, cached) == (12, 0)
    cache.put_comm(w_pcache.CommEntry("cuda", "bf16", 4, alpha=2e-5, beta=1 / 3e11, r2=0.98))
    cache.save()
    tc, jc = tpcache.ProfileCache.load(path), jpcache.ProfileCache.load(path)
    assert sorted(tc.entries) == sorted(jc.entries) and len(tc.entries) == 12
    for k in tc.entries:
        assert dataclasses.asdict(tc.entries[k]) == dataclasses.asdict(jc.entries[k])
    assert [dataclasses.asdict(c) for c in tc.comm.values()] == \
        [dataclasses.asdict(c) for c in jc.comm.values()]
    t_cal, j_cal = tcal.load_calibration(path), jcal.load_calibration(path)
    assert t_cal.source == "measured" and t_cal.link_bw is not None
    _assert_same_calibration(t_cal, j_cal)
    assert t_cal.format_table() == j_cal.format_table()
    for e in tc.entries.values():
        je = jc.entries[e.key.id()]
        assert tcal.predict_entry_time(e, t_cal, tcluster.H100_1) == pytest.approx(
            jcal.predict_entry_time(je, j_cal, JAX_H100_1), rel=1e-12)
    assert tpcache.SCHEMA_VERSION == jpcache.SCHEMA_VERSION
    assert tpcache.default_path("cuda").parts[-3:] == ("results", "profiles", "cuda.json")


def test_second_pass_measures_nothing_and_a_stale_schema_is_reset(tmp_path):
    path = tmp_path / "cuda.json"
    calls = []

    def counting(cfg, seq, **kw):
        calls.append(seq)
        return _fake_measure(cfg, seq, **kw)

    cells = _cells(tpcache, "cuda", archs=(ARCH,))
    cache = tpcache.ProfileCache.load_or_create(path)
    assert tcal.run_profile_cells(cells, cache, measure_fn=counting) == (6, 0)
    cache.save()
    again = tpcache.ProfileCache.load(path)
    assert tcal.run_profile_cells(cells, again, measure_fn=counting) == (0, 6)
    assert len(calls) == 6

    doc = json.loads(path.read_text())
    doc["schema"] = tpcache.SCHEMA_VERSION - 1
    path.write_text(json.dumps(doc))
    stale = tpcache.ProfileCache.load(path)
    assert stale.stale and not stale.entries
    with pytest.raises(tpcache.StaleProfileCacheError):
        tcal.load_calibration(path)
    assert tcal.load_calibration(path, allow_stale=True).provenance["cache_schema"] == \
        tpcache.SCHEMA_VERSION - 1
    assert tcal.run_profile_cells(cells, stale, measure_fn=counting) == (6, 0)
    assert not stale.stale and len(calls) == 12
    path.write_text("{not json")
    with pytest.raises(tpcache.CorruptProfileCacheError):
        tpcache.ProfileCache.load(path)


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("layers", [48, 2])
def test_moe_search_on_one_h100_matches_jax(layers, calibrated, tmp_path):
    """moonshot's search on ``H100_1`` at S 4096, global batch 8: at full
    depth neither package finds a plan that fits, cut to 2 layers both find
    the same one, analytic and calibrated (from moonshot cells of a
    synthetic cache): feasibility, plan, rejections, predicted step and
    memory within 1e-9.  The mesh is one card's, (1, 1), for both (JAX's
    default is the TPU pod's)."""
    from repro_torch.core.search import SearchEngine

    arch = "moonshot-v1-16b-a3b"
    jcfg = dataclasses.replace(jget(arch), num_layers=layers)
    tcfg = dataclasses.replace(get_config(arch), num_layers=layers)
    jcalib, tcalib = jcal.DEFAULT_CALIBRATION, tcal.DEFAULT_CALIBRATION
    if calibrated:
        path = tmp_path / "cuda.json"
        cache = tpcache.ProfileCache.load_or_create(path)
        tcal.run_profile_cells(_cells(tpcache, "cuda", archs=(arch,)), cache,
                               measure_fn=_fake_measure)
        cache.save()
        jcalib, tcalib = jcal.load_calibration(path), tcal.load_calibration(path)
    kw = dict(mesh_shape=(1, 1), mesh_axes=("data", "model"), arch=arch,
              shape_name="train_4k")
    jres = jsearch.SearchEngine(jcfg, JAX_H100_1, calibration=jcalib).search(4096, 8, **kw)
    tres = SearchEngine(tcfg, tcluster.H100_1, calibration=tcalib).search(4096, 8, **kw)
    assert tres.feasible == jres.feasible == (layers == 2)
    assert (tres.evaluated, tres.rejections) == (jres.evaluated, jres.rejections)
    jd, td = json.loads(jres.plan.to_json()), json.loads(tres.plan.to_json())
    floats = ("predicted_step_time", "predicted_memory")
    assert {k: v for k, v in td.items() if k not in floats} == \
        {k: v for k, v in jd.items() if k not in floats}
    for k in floats:
        if math.isinf(jd[k]):
            assert math.isinf(td[k])
        else:
            assert td[k] == pytest.approx(jd[k], rel=1e-9), k


def test_profile_launcher_measures_then_reads_its_cache(tmp_path, capsys):
    cache = tmp_path / "cpu.json"
    argv = ["--device", "cpu", "--cache", str(cache), "--seq", "16,32", "--dtype", "bf16",
            "--iters", "1"]
    assert profile_cli.main(argv) == 0
    first = capsys.readouterr().out
    assert "profile: 2 cell(s) measured, 0 from cache" in first
    assert "calibration: source=measured" in first and "backends=cpu" in first
    assert profile_cli.main(argv) == 0
    assert "profile: 0 cell(s) measured, 3 from cache" in capsys.readouterr().out
    comm = tpcache.ProfileCache.load(cache).get_comm("cpu", "bf16", 1)
    assert (comm.alpha, comm.beta, comm.r2) == (0.0, 0.0, 1.0)


# ---------------------------------------------------------------- launchers

FLAGS = ["--reduced", "--seq", "32", "--batch", "4"]


def _jax_plan_line(argv, capsys):
    """The plan line JAX's launcher prints for ``argv`` (its
    ``--validate-only`` path builds the plan and initialises nothing)."""
    from repro.launch import train as jtrain

    with pytest.raises(SystemExit):
        jtrain.main(argv + ["--validate-only"])
    out = capsys.readouterr().out
    return next(line for line in out.splitlines() if line.startswith("plan["))


def test_train_launcher_trains_the_plan_jax_builds(capsys):
    argv = FLAGS + ["--grad-accum", "2", "--remat", "selective"]
    assert train_cli.main(argv + ["--device", "cpu", "--steps", "2", "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"^step \d+ loss (\S+)", out, re.MULTILINE)]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert abs(losses[0] - math.log(get_config(ARCH).reduced().vocab_size)) < 1.0
    assert re.search(r"^GALV070: median step .* ms vs predicted", out, re.MULTILINE)
    assert out.rstrip().endswith("done")
    ours = next(line for line in out.splitlines() if line.startswith("plan["))
    assert ours.split("]: ", 1)[1] == _jax_plan_line(argv, capsys).split("]: ", 1)[1]
    assert ours.split("]: ", 1)[1] == "tp1-z1-selective ga=2 mesh=(1,) groups=1"


@pytest.mark.parametrize("calibrated", [False, True])
def test_train_launcher_prices_the_plan_as_jax_does(calibrated, tmp_path, monkeypatch):
    """The predicted breakdown and step time are JAX's cost model on the same
    plan with the one-H100 spec (built from the port's fields)."""
    from repro.launch import train as jtrain

    jcalib = tcalib = None
    argv = FLAGS + ["--grad-accum", "2", "--remat", "full", "--device", "cpu",
                    "--validate-only"]
    if calibrated:
        path = tmp_path / "cuda.json"
        cache = tpcache.ProfileCache.load_or_create(path)
        tcal.run_profile_cells(_cells(tpcache, "cuda"), cache, measure_fn=_fake_measure)
        cache.save()
        argv += ["--profile-cache", str(path)]
        jcalib, tcalib = jcal.load_calibration(path), tcal.load_calibration(path)
    jcalib = jcalib or jcal.DEFAULT_CALIBRATION
    tcalib = tcalib or tcal.DEFAULT_CALIBRATION
    jcfg, tcfg = jget(ARCH).reduced(), get_config(ARCH).reduced()
    strat = JLayerStrategy(remat="full")
    jplan = juniform_plan(jcfg.name, "train", (1,), ("data",), jcfg.num_layers, strat,
                          grad_accum=2)
    step, mem, _ = jsearch.evaluate_uniform(jcfg, JAX_H100_1, 32, 4, 1, strat, grad_accum=2,
                                            calibration=jcalib)
    jplan = dataclasses.replace(jplan, predicted_step_time=step, predicted_memory=mem)
    monkeypatch.setattr(jtrain, "TPU_V5E_POD", JAX_H100_1)
    want = jtrain._predicted_breakdown(jplan, jcfg, 32, 4, jcalib)
    from repro_torch.core.strategy import ExecutionPlan

    tplan = ExecutionPlan.from_json(jplan.to_json())
    got = train_cli._predicted_breakdown(tplan, tcfg, 32, 4, tcalib)
    for k in ("compute_s", "comm_s", "predicted_step_time_s"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    assert got["predicted_memory_bytes"] == pytest.approx(mem, rel=1e-12)
    assert train_cli.main(argv) == 0


@pytest.mark.parametrize("grad_accum,rc", [(3, 1), (2, 0)])
def test_validate_only_gives_jaxs_verdict(grad_accum, rc, capsys):
    """``--validate-only`` exits with, and prints, JAX's ``check_plan`` report
    for the same plan on the same one-H100 spec (``--grad-accum 3`` does not
    divide the batch of 4: GALV013)."""
    argv = FLAGS + ["--grad-accum", str(grad_accum), "--validate-only", "--device", "cpu"]
    assert train_cli.main(argv) == rc
    out = capsys.readouterr().out
    jcfg = jget(ARCH).reduced()
    jplan = juniform_plan(jcfg.name, "train", (1,), ("data",), jcfg.num_layers,
                          JLayerStrategy(), grad_accum=grad_accum)
    report = jpc.check_plan(jplan, JAX_H100_1, jcfg, seq_len=32, global_batch=4,
                            profile=jpm.profile_model(jcfg, 32),
                            calibration=jcal.DEFAULT_CALIBRATION)
    assert (0 if report.ok() else 1) == rc
    assert report.format_table() in out
    assert ("GALV013" in report.codes()) == (grad_accum == 3)


@pytest.mark.parametrize("arch", ["qwen3-14b", "llama3.2-1b"])
def test_serve_search_makes_jaxs_choice(arch, capsys):
    assert serve_cli.main(["search", "--arch", arch]) == 0
    out = capsys.readouterr().out
    c = jsearch.SearchEngine(jget(arch), JAX_H100_1).search_serve(
        max_context=4096, prompt_len=1024).choice
    assert "cluster h100-1: evaluated" in out
    assert (f"tp={c.tp} num_slots={c.num_slots} page_size={c.page_size} "
            f"num_pages={c.num_pages} ({c.pool_gb:.2f} GB pool/chip)") in out


def test_launchers_refuse_cuda_without_a_gpu(no_gpu, tmp_path):
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main(FLAGS + ["--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        profile_cli.main(["--cache", str(tmp_path / "c.json"), "--seq", "16"])
    with pytest.raises(RuntimeError, match="cuda"):
        tpm.measure_block(get_config(ARCH).reduced(), 16)
