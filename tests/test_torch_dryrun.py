"""The dry run and the step audit on fake worlds, in this process (torch's
``fake`` process-group backend: one process is one rank of any world).

* JAX's planted-defect corpus (``benchmarks/hlo_audit.py:8-22``), code for
  code, each defect beside its clean twin, on reduced llama3.2-1b (S 64,
  global batch 8) over (data 2, model 2) or (data 4, model 1):
  forced-f32 -> GALV091, a ``selective`` plan whose runner wraps no layer
  -> GALV092, an ``.item()`` in the step -> GALV093 at its ``file:line``,
  a pure-DP plan whose step all-gathers its params over ``data`` ->
  GALV090 as an error, and the plan searched on (data 2, model 2) on
  JAX's cluster clean;
* ``launch.dryrun.run_cell`` on reduced configs: a train cell (audited), a
  ``--pp 2`` cell (both stages traced), a ``--cp 2`` cell, a dense decode
  cell; full-size ssm and hybrid serve cells on the mesh engine; the MoE
  ep cell's trace stopping at the exchange's host read with GALV093 at
  ``models/moe.py``; ``main``'s JSON for an error cell (the audio family's
  serve cell, refused on a mesh).
"""
from __future__ import annotations

import dataclasses
import json

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.analysis.step_audit import audit_step
from repro_torch.analysis.step_trace import materialize, trace_step
from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core.search import SearchEngine
from repro_torch.core.strategy import LayerStrategy, uniform_plan
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.models.common import tree_map
from repro_torch.parallel import collectives
from repro_torch.runtime import train as train_lib
from repro_torch.runtime.data import input_specs

SEQ, BATCH = 64, 8
SPEC = ShapeSpec("corpus", "train", SEQ, BATCH)
CFG = get_config("llama3.2-1b").reduced()


@pytest.fixture
def world4():
    """Rank 0 of a 4-rank fake world for the test, torn down after it."""
    dryrun.fake_world(4, 0)
    yield
    dist.destroy_process_group()


@pytest.fixture
def no_world():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _trace(plan, shape, model=None, wrap=None):
    mesh = make_mesh(shape, ("data", "model"), device="cpu", backend=dryrun.FAKE_BACKEND)
    hp = train_lib.construct_hybrid_parallel_model(
        model or build_model(CFG, device="cpu"), plan, mesh)
    step = hp.train_step if wrap is None else wrap(hp, mesh)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = materialize(hp.abstract_params(), "cpu")
        opt = materialize(hp.abstract_opt_state(), "cpu")
        batch = materialize(input_specs(CFG, SPEC, hp.model), "cpu")
        return trace_step(lambda: step(params, opt, batch), (params, opt, batch), mesh)


def _audit(plan, tr):
    rep = audit_step(plan, CFG, seq_len=SEQ, global_batch=BATCH, trace=tr)
    return sorted(set(rep.codes())), sorted(set(rep.error_codes()))


def _uniform(shape, **kw):
    return uniform_plan(CFG.name, "train", shape, ("data", "model"), CFG.num_layers,
                        LayerStrategy(**kw))


PLAN_TP = dict(tp=2, sp=True, zero=2, remat="none")


def test_corpus_clean_searched_plan(world4):
    """JAX's clean case: the plan searched on (data 2, model 2) on JAX's
    cluster (the port's ``ClusterSpec`` of the TPU preset's fields, as the
    planner tests build it): tp2-sp-z2, audited with no diagnostic."""
    from repro.core.cluster import TPU_V5E_POD
    from repro_torch.core.cluster import ClusterSpec

    cluster = ClusterSpec(**dataclasses.asdict(TPU_V5E_POD))
    plan = SearchEngine(CFG, cluster=cluster).search(
        SEQ, BATCH, mesh_shape=(2, 2), mesh_axes=("data", "model"), pp_options=[1]).plan
    assert _audit(plan, _trace(plan, (2, 2))) == ([], [])


def test_corpus_forced_f32_and_twin(world4):
    base = build_model(CFG, device="cpu")

    class F32Model:
        def __getattr__(self, k):
            return getattr(base, k)

        def forward_train(self, params, tokens, *, dtype=torch.bfloat16, layer_runner=None):
            return base.forward_train(params, tokens, dtype=torch.float32,
                                      layer_runner=layer_runner)

    plan = _uniform((2, 2), **PLAN_TP)
    codes, errors = _audit(plan, _trace(plan, (2, 2), model=F32Model()))
    assert "GALV091" in errors
    assert _audit(plan, _trace(plan, (2, 2))) == ([], [])


def test_corpus_remat_stripped_and_twin(world4, monkeypatch):
    plan = _uniform((2, 2), **dict(PLAN_TP, remat="selective"))
    assert _audit(plan, _trace(plan, (2, 2))) == ([], [])
    monkeypatch.setattr(train_lib, "apply_remat", lambda fn, policy: fn)
    codes, errors = _audit(plan, _trace(plan, (2, 2)))
    assert "GALV092" in errors


def test_corpus_host_read_with_its_site(world4):
    plan = _uniform((2, 2), **PLAN_TP)

    def with_item(hp, _mesh):
        def step(params, opt, batch):
            params, opt, metrics = hp.train_step(params, opt, batch)
            print(f"loss={metrics['loss'].item()}")      # the planted read
            return params, opt, metrics
        return step

    tr = _trace(plan, (2, 2), wrap=with_item)
    codes, errors = _audit(plan, tr)
    assert "GALV093" in errors
    assert tr.stopped is not None and tr.stopped.endswith(
        f"test_torch_dryrun.py:{with_item.__code__.co_firstlineno + 3}")


def test_corpus_mis_sharded_and_twin(world4):
    plan = _uniform((4, 1), zero=0)

    def misshard(hp, mesh):
        data = mesh.group("data")

        def step(params, opt, batch):
            params = tree_map(lambda v: collectives.all_gather(v, 0, data)[:v.shape[0]]
                              if v.dim() else v, params)
            return hp.train_step(params, opt, batch)
        return step

    codes, errors = _audit(plan, _trace(plan, (4, 1), wrap=misshard))
    assert "GALV090" in errors
    assert _audit(plan, _trace(plan, (4, 1))) == ([], [])


# --------------------------------------------------------------------------
# run_cell on reduced configs
# --------------------------------------------------------------------------

@pytest.fixture
def reduced(monkeypatch):
    """``run_cell`` on each arch's ``reduced()`` config."""
    monkeypatch.setattr(dryrun, "get_config", lambda arch: get_config(arch).reduced())


def test_run_cell_train_audited(no_world, reduced):
    out = dryrun.run_cell("llama3.2-1b", "train_4k", device="meta", audit=True, verbose=False)
    assert out["devices"] == 256 and out["mesh"] == "pod16x16"
    assert out["audit"]["ok"] and set(out["audit"]) >= {
        "ok", "codes", "error_codes", "predicted_bytes", "measured_bytes",
        "unresolved_loops", "axes"}
    ma = out["memory_analysis"]
    assert set(ma) == {"argument_size_in_bytes", "output_size_in_bytes",
                       "alias_size_in_bytes", "temp_size_in_bytes",
                       "generated_code_size_in_bytes"}
    assert ma["argument_size_in_bytes"] > 0 and ma["temp_size_in_bytes"] > 0
    assert out["cost_analysis"]["flops_per_device"] > 0
    assert out["kernels"]["flash_attention_fwd"] > 0 and out["kernels"]["rmsnorm"] > 0
    assert out["collectives"]["collective_bytes"] > 0
    assert {r["axis"] for r in out["collectives_by_axis"]} <= {"data", "model", "data+model"}


def test_run_cell_pipeline_traces_every_stage(no_world, reduced):
    out = dryrun.run_cell("llama3.2-1b", "train_4k", device="meta", pp=2, verbose=False)
    assert out["mesh"] == "pod2x16x16" and out["plan"]["pp"] == 2
    assert [s["rank"] for s in out["stages"]] == [0, 256]
    for s in out["stages"]:
        assert s["collectives"]["collective-permute_bytes"] > 0
    assert out["memory_analysis"]["temp_size_in_bytes"] == max(
        s["memory_analysis"]["temp_size_in_bytes"] for s in out["stages"])


def test_run_cell_context_parallel(no_world, reduced):
    out = dryrun.run_cell("llama3.2-1b", "train_4k", device="meta", cp=2, verbose=False)
    assert out["mesh"] == "cp2x16x16" and out["plan"]["cp"] == 2
    axes = {r["axis"] for r in out["collectives_by_axis"]
            if r["kind"] == "collective-permute"}
    assert axes == {"cp"}


def test_run_cell_dense_decode_on_the_mesh_engine(no_world, reduced):
    out = dryrun.run_cell("qwen2.5-3b", "decode_32k", device="meta", verbose=False)
    assert out["kind"] == "decode" and out["plan"]["default"].startswith("tp16")
    assert out["memory_analysis"]["alias_size_in_bytes"] > 0      # the cache, in place
    assert out["kernels"]["flash_attention_fwd"] > 0


def test_run_cell_moe_ep_stops_at_the_host_read(no_world, reduced):
    out: dict = {}
    with pytest.raises(ValueError, match="reads the host at .*models/moe.py"):
        dryrun.run_cell("moonshot-v1-16b-a3b", "train_4k", device="meta", audit=True,
                        verbose=False, force_strategy="tp1-z1-ep2", out=out)
    assert "GALV093" in out["audit"]["error_codes"]
    assert "models/moe.py" in out["stopped_at"]


@pytest.mark.parametrize("arch, shape, multi_pod", [
    ("mamba2-2.7b", "decode_32k", False), ("mamba2-2.7b", "prefill_32k", True),
    ("zamba2-7b", "decode_32k", False), ("zamba2-7b", "long_500k", True)])
def test_run_cell_ssm_and_hybrid_serve_cells_on_the_mesh_engine(no_world, arch, shape,
                                                                multi_pod):
    """Full-size ssm and hybrid serve cells trace on the mesh engine: the
    SSD state by heads (K3 on a rank's heads at prefill), the gate norm
    through K2's split-row passes, zamba2's sites by flash-decode over a
    sequence-sharded cache (K1 with residuals), long_500k's batch of 1
    whole on every rank of the 512-rank mesh."""
    out = dryrun.run_cell(arch, shape, multi_pod=multi_pod, device="meta", verbose=False)
    assert out["plan"]["default"].startswith("tp16") and "error" not in out
    kernels = out["kernels"]
    assert kernels["rmsnorm_split_sumsq"] > 0 and kernels["rmsnorm_split"] > 0
    assert (kernels.get("ssd", 0) > 0) == (shape == "prefill_32k")
    assert (kernels.get("flash_attention_fwd", 0) > 0) == (arch == "zamba2-7b")
    if out["kind"] == "decode":
        assert out["memory_analysis"]["alias_size_in_bytes"] > 0      # the state, in place


def test_main_writes_a_json_for_a_cell_and_an_error(tmp_path, no_world, capsys):
    rc = dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k", "--device", "meta",
                      "--skip-unrolled", "--out", str(tmp_path)])
    assert rc == 1
    res = json.loads((tmp_path / "whisper-tiny__decode_32k__pod16x16.json").read_text())
    assert res["error"].startswith("NotImplementedError") and "Queue 1 item 4" in res["error"]
    assert res["traceback"] and res["plan"]["default"].startswith("tp16")
