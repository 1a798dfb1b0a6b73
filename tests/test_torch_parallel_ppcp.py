"""Pipeline × context parallelism in the port's runtime over gloo on the
CPU: ``PipelineTrainer`` with the zig-zag cp ring inside every stage.
Spawned ranks train the reduced llama3.2-1b (seq 64, a global batch of 8
whose row 1 has its first ``MASKED`` labels masked) in fp32 on (pod, cp,
data, model) meshes, each run held to the references of
``test_torch_parallel_mp.py`` (the port's single-device step at
grad_accum 1 and JAX's ``value_and_grad``, grads within 2e-3 of scale):

* (pod 2, cp 2, data 1, model 1), 4 layers, ZeRO-1, ``selective``, under
  gpipe, 1f1b (2 windows of 2) and interleaved v 2 (stage 0 holds layers 0
  and 2), grad_accum 4;
* (pod 2, cp 2, data 1, model 2), 4 layers, tp 2 + sp, ZeRO-1, 1f1b: the
  boundary block is (b, S/(cp·tp), d), ``seq`` nested over ("cp",
  "model");
* JAX's own case (``tests/test_context_parallel.py::
  test_pipeline_with_cp_matches_single_device``): the reduced llama's 2
  layers on (pod 2, cp 2, data 2, model 1), ``LayerStrategy(cp=2,
  zero=1)``, pp 2, grad_accum 4, gpipe; and ZeRO-3 under ``full`` on the
  same mesh.

Three hazard guards, each the first case under 1f1b with one fault brought
in (``_torch_dist.inject_fault``): the valid-token count over the batch
axes alone (the masked labels give the two cp ranks different counts, so
each rank divides by its own), the totals summed without cp (each rank
reports its shard's share), and the ring's rules carrying the shard's
local length in place of the microbatch's global one, which the
attention layer refuses (the ranks raise).  Then the local boundary shape,
the stage hop's bytes against the cost model's ``pipeline_boundary_bytes``,
the refusals that stay (a plan mixing cp degrees, cp on mamba2, a mesh
without a cp axis), and the copied planner's pp × cp plan through
``check_plan``.  The launcher's ``--pp 2 --cp 2`` is
``test_torch_parallel_cp.py``'s.
"""
import numpy as np
import pytest

from repro_torch.core.strategy import LayerStrategy
from tests._torch_dist import references, run_ranks
from tests.test_torch_parallel_mp import check_jax, check_single_device

AXES = ("pod", "cp", "data", "model")
MASKED = 5                       # of row 1's labels: all in cp rank 0's first chunk
ACCUM = 4
SEQ = 64

ZERO1 = LayerStrategy(cp=2, zero=1, remat="selective")
CASES = {
    # name: (mesh, strategy, schedules, layers)
    "cp2": ((2, 2, 1, 1), ZERO1, [("gpipe", 1), ("1f1b", 1), ("interleaved", 2)], 4),
    "cp2_tp2_sp": ((2, 2, 1, 2), LayerStrategy(cp=2, tp=2, sp=True, zero=1), [("1f1b", 1)], 4),
    "cp2_dp2_jax": ((2, 2, 2, 1), LayerStrategy(cp=2, zero=1), [("gpipe", 1)], 2),
    "cp2_dp2_zero3_full": ((2, 2, 2, 1), LayerStrategy(cp=2, zero=3, remat="full"),
                           [("1f1b", 1)], 2),
}
RUNS = [f"{name}/{sched}" for name, case in CASES.items() for sched, _ in case[2]]
FAULTS = ("count", "totals")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import dataclasses

    from repro_torch.configs.registry import get_config

    refs_of = {layers: references(f"llama_{layers}", "llama3.2-1b", [ZERO1], 1, seq=SEQ,
                                  overrides={"num_layers": layers}, masked=MASKED)
               for layers in {c[3] for c in CASES.values()}}
    built = {}
    for name, (mesh, strategy, schedules, layers) in CASES.items():
        case, refs = refs_of[layers]
        built[name] = (dict(case, name=name, mesh=mesh, axes=AXES, strategies=[strategy],
                            schedules=schedules, grad_accum=ACCUM), refs)
    base = built["cp2"][0]
    faulty = [dict(base, name=f"fault_{f}", fault=f, schedules=[("1f1b", 1)]) for f in FAULTS]
    llama = dataclasses.replace(get_config("llama3.2-1b").reduced(), num_layers=4)
    mamba = get_config("mamba2-2.7b").reduced()
    refused = {
        "mixed_cp": (llama, (2, 2, 1, 1), [ZERO1, LayerStrategy(zero=1)] * 2, "gpipe", 1,
                     AXES),
        "mamba2_cp": (mamba, (2, 2, 1, 1), LayerStrategy(cp=2), "gpipe", 1, AXES),
        "no_cp_axis": (llama, (2, 2, 1), LayerStrategy(cp=2), "gpipe", 1,
                       ("pod", "data", "model")),
    }
    opt = refs_of[4][1]["opt"]
    four = [c for c, _ in built.values() if np.prod(c["mesh"]) == 4] + faulty
    eight = [c for c, _ in built.values() if np.prod(c["mesh"]) == 8]
    ranks = run_ranks(4, "pipeline_cases", {"cases": four, "opt": opt, "refused": refused},
                      tmp_path_factory.mktemp("four"), timeout=240)
    ranks8 = run_ranks(8, "pipeline_cases", {"cases": eight, "opt": opt},
                       tmp_path_factory.mktemp("eight"), timeout=240)
    return {"built": built, "ranks": ranks, "ranks8": ranks8}


def _run(results, key):
    name = key.split("/")[0]
    case, refs = results["built"][name]
    ranks = results["ranks8" if np.prod(case["mesh"]) == 8 else "ranks"]
    return ranks[0]["runs"][key], refs, case


@pytest.mark.parametrize("key", RUNS)
def test_ppcp_step_matches_the_ports_single_device_step(results, key):
    check_single_device(*_run(results, key))


@pytest.mark.parametrize("key", RUNS)
def test_ppcp_grads_match_jax_value_and_grad(results, key):
    got, refs, _ = _run(results, key)
    check_jax(got, refs)


@pytest.mark.parametrize("key", RUNS)
def test_in_flight_is_the_schedules(results, key):
    """Every rank of a stage holds what its schedule holds: M = 4 under
    gpipe, at most S = 2 under 1f1b and interleaved."""
    name, schedule = key.split("/")
    ranks = results["ranks8" if np.prod(CASES[name][0]) == 8 else "ranks"]
    for rank in ranks:
        stage, got, static, windows = rank["in_flight"][key]
        assert got == static
        assert got == ACCUM if schedule == "gpipe" else got <= 2


@pytest.mark.parametrize("fault", FAULTS)
def test_each_hazard_guard_fails_under_its_fault(results, fault):
    case, refs = results["built"]["cp2"]
    got = results["ranks"][0]["runs"][f"fault_{fault}/1f1b"]
    with pytest.raises(AssertionError):
        check_single_device(got, refs, case)
    with pytest.raises(AssertionError):
        check_jax(got, refs)


def test_masked_labels_give_the_cp_ranks_different_counts(results):
    """The count fault shows only where the two cp ranks of a stage hold
    different valid counts: row 1's masked labels sit in cp rank 0's first
    zig-zag chunk."""
    counts = {}
    for rank in results["ranks"]:
        index, n = rank["counts"]["cp2/1f1b"]
        counts.setdefault(index, set()).add(n)
    assert len(counts[0]) == len(counts[1]) == 1 and counts[0] != counts[1], counts
    assert sum(counts[0]) + sum(counts[1]) == 8 * SEQ - MASKED


def test_seq_len_guard_fails_under_its_fault(results, tmp_path):
    """The ring's rules with the shard's local length: the attention layer
    refuses a shard that is not 1/cp of the microbatch, and the spawn
    fails naming it (the other stage's ranks lose their peer)."""
    base, refs = results["built"]["cp2"]
    case = dict(base, schedules=[("1f1b", 1)], fault="seq_len", name="fault_seq_len")
    with pytest.raises(RuntimeError, match="is not 1/2 of the microbatch's 32"):
        run_ranks(4, "pipeline_cases", {"cases": [case], "opt": refs["opt"]}, tmp_path,
                  timeout=120)


def test_boundary_shape_and_hop_bytes_are_the_cost_models(results):
    """The boundary block is a rank's rows of a microbatch by its zig-zag
    shard (b 2, S/cp 32, d 128), cut again over the model axis under SP (16);
    stage 0's hop sends it once a microbatch and receives its cotangent
    once: over ``value_and_grad`` and ``train_step`` 2 x M x
    ``pipeline_boundary_bytes`` each way (the cost model divides by dp·cp;
    under SP the runtime also cuts by tp, which the cost model does not
    count)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import cost_model as cm
    from repro_torch.core.cluster import H100_NODE8
    from repro_torch.core.profiler_model import profile_model

    cfg = get_config("llama3.2-1b").reduced()
    prof = profile_model(cfg, SEQ)
    env = cm.CostEnv(cluster=H100_NODE8, devices=2, pp=2, micro_batch=8 // ACCUM,
                     grad_accum=ACCUM)
    block = cm.pipeline_boundary_bytes(prof, env, ZERO1)
    assert block == 2 * (SEQ // 2) * cfg.d_model * 4
    run = results["ranks"][0]["runs"]["cp2/gpipe"]
    assert run["boundary_shape"] == (2, SEQ // 2, cfg.d_model)
    assert run["hop_bytes"]["sent"] == run["hop_bytes"]["received"] == 2 * ACCUM * block
    sp = results["ranks8"][0]["runs"]["cp2_tp2_sp/1f1b"]
    assert sp["boundary_shape"] == (2, SEQ // 4, cfg.d_model)
    assert sp["hop_bytes"]["sent"] == 2 * ACCUM * block // 2


def test_states_shard_over_dp_times_cp(results):
    """ZeRO-1 in a stage: params whole on each rank of the stage (its 2
    layers); ZeRO-3 on (pod 2, cp 2, data 2): the embed dim cut over the
    four ranks of data and cp."""
    got = results["ranks"][0]["runs"]["cp2/gpipe"]["local_shapes"]
    assert got["blocks.attn.wq"] == (1, 2, 128, 4, 32)
    z3 = results["ranks8"][0]["runs"]["cp2_dp2_zero3_full/1f1b"]["local_shapes"]
    assert z3["blocks.attn.wq"] == (1, 1, 32, 4, 32)


def test_refusals_that_stay(results):
    got = results["ranks"][0]["refused"]
    assert got["mixed_cp"][0] == "NotImplementedError"
    assert "applies its default strategy" in got["mixed_cp"][1]
    assert got["mamba2_cp"][0] == "ValueError" and "GALV031" in got["mamba2_cp"][1]
    assert got["no_cp_axis"][0] == "ValueError" and "GALV032" in got["no_cp_axis"][1]


@pytest.mark.parametrize("world", [4, 8])
def test_searched_pp_cp_plan_passes_check_plan(world):
    """The copied planner's pp × cp plan on ``train_mesh_spec(world, pp=2,
    cp=2)`` (the launcher's search for ``--pp 2 --cp 2``): pp 2 with cp 2
    on every layer, and ``check_plan`` reports nothing (GALV001 tiles
    tp·cp in a stage, GALV040 holds, the memory check passes)."""
    import dataclasses

    from repro_torch.analysis import plan_check
    from repro_torch.configs.registry import get_config
    from repro_torch.core.cluster import H100_NODE8
    from repro_torch.core.profiler_model import profile_model
    from repro_torch.core.search import SearchEngine
    from repro_torch.launch.mesh import train_mesh_spec

    cfg = get_config("llama3.2-1b").reduced()
    shape, axes = train_mesh_spec(world, pp=2, cp=2)
    cluster = dataclasses.replace(H100_NODE8, chips=world, intra_size=min(world, 8))
    res = SearchEngine(cfg, cluster=cluster).search(
        32, 8, mesh_shape=shape, mesh_axes=axes, pp_options=[2], cp_options=[2],
        arch=cfg.name)
    plan = res.plan
    assert res.feasible and plan.pp == 2 and plan.mesh_shape == shape
    assert {s.cp for s in plan.layer_strategies} == {plan.default_strategy.cp} == {2}
    report = plan_check.check_plan(plan, cluster, cfg, seq_len=32, global_batch=8,
                                   profile=profile_model(cfg, 32))
    assert report.ok() and not report.diagnostics, report.format_table()
