"""The port's pipeline runtime (``runtime/train_pp.py``) over gloo on the
CPU: one spawn of four ranks runs every case, fp32, on the references'
batch of 8 x 32 with half of row 1's labels masked, grad_accum 4 (M 4
microbatches of 2; 1f1b and interleaved in 2 windows of 2), each held to

* the port's single-device step (``mesh=None``) at grad_accum 1: the
  ``value_and_grad`` and ``train_step`` losses within 1e-5 relative, the
  grad norm too, every update (AdamW eps 1e-4) within 2e-3 of its scale
  (``check_single_device``);
* JAX's single-device ``value_and_grad`` of its ``loss_fn`` formula: the
  loss within 1e-5 and every grad within 2e-3 of its scale (``check_jax``).

The cases: llama cut to 4 layers on (pod 2, data 1, model 2), tp 2 + sp,
ZeRO-1, under gpipe, 1f1b and interleaved v 2 (stage 0 holds layers 0 and
2), which must also agree with each other; llama on (2, 2, 1), ZeRO-3,
``full``, 1f1b; internvl2 (its ``vis_embeds`` prefix embedded on stage 0
and sliced off on the last) on (2, 2, 1), gpipe; mamba2 at tp 2 on (2, 1,
2), 1f1b.  The grad-accumulation reference (the mean of 4 microbatch
means) differs from the pipeline's global token mean on this batch.  Then
the refusals with JAX's exception types, the stage hop's ring shift (the
wrap from the last stage to the first), and the launcher under
``torchrun`` with ``--pp 2``.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.strategy import LayerStrategy
from repro_torch.models.common import tree_paths
from tests._torch_dist import references, run_ranks
from tests.test_torch_parallel_mp import check_jax, check_single_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
MASKED = 16                      # of row 1's 31 labels: microbatch 0 has 46 of 62
ACCUM = 4

SP_ZERO1 = LayerStrategy(tp=2, sp=True, zero=1)
CASES = {
    # name: (arch, mesh, strategy, schedules, overrides)
    "llama_tp2_sp_zero1": ("llama3.2-1b", (2, 1, 2), SP_ZERO1,
                           [("gpipe", 1), ("1f1b", 1), ("interleaved", 2)], {"num_layers": 4}),
    "llama_dp2_zero3_full": ("llama3.2-1b", (2, 2, 1), LayerStrategy(zero=3, remat="full"),
                             [("1f1b", 1)], {"num_layers": 4}),
    "internvl2_dp2": ("internvl2-26b", (2, 2, 1), LayerStrategy(zero=1), [("gpipe", 1)], {}),
    "mamba2_tp2": ("mamba2-2.7b", (2, 1, 2), LayerStrategy(tp=2, zero=1), [("1f1b", 1)], {}),
}
RUNS = [f"{name}/{sched}" for name, case in CASES.items() for sched, _ in case[3]]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import dataclasses

    from repro_torch.configs.registry import get_config

    built = {}
    for name, (arch, mesh, strategy, schedules, overrides) in CASES.items():
        case, refs = references(name, arch, [strategy], 1, overrides=overrides, masked=MASKED)
        case.update(mesh=mesh, schedules=schedules, grad_accum=ACCUM)
        built[name] = (case, refs)
    refused = {"zamba2_hybrid": (get_config("zamba2-7b").reduced(), (2, 1, 2), LayerStrategy(),
                                 "gpipe", 1)}
    llama = dataclasses.replace(get_config("llama3.2-1b").reduced(), num_layers=4)
    refused["llama_mesh_mismatch"] = (llama, (2, 2, 1), LayerStrategy(tp=2), "gpipe", 1)
    opt = next(iter(built.values()))[1]["opt"]
    ranks = run_ranks(4, "pipeline_cases", {"cases": [c for c, _ in built.values()],
                                            "opt": opt, "refused": refused, "ring": True},
                      tmp_path_factory.mktemp("pp"), timeout=240)
    return {"built": built, "ranks": ranks}


def _run(results, key):
    name = key.split("/")[0]
    case, refs = results["built"][name]
    return results["ranks"][0]["runs"][key], refs, case


@pytest.mark.parametrize("key", RUNS)
def test_pipeline_step_matches_the_ports_single_device_step(results, key):
    check_single_device(*_run(results, key))


@pytest.mark.parametrize("key", RUNS)
def test_pipeline_grads_match_jax_value_and_grad(results, key):
    got, refs, _ = _run(results, key)
    check_jax(got, refs)


@pytest.mark.parametrize("other", ["1f1b", "interleaved"])
def test_schedules_agree_with_gpipe(results, other):
    runs = results["ranks"][0]["runs"]
    a, b = runs["llama_tp2_sp_zero1/gpipe"], runs[f"llama_tp2_sp_zero1/{other}"]
    np.testing.assert_allclose(b["vg_loss"], a["vg_loss"], rtol=1e-5)
    want = dict(tree_paths(a["grads"]))
    for path, g in tree_paths(b["grads"]):
        assert float((g - want[path]).abs().max()) <= 2e-3 * float(want[path].abs().max()), path


@pytest.mark.parametrize("key", RUNS)
def test_in_flight_is_m_under_gpipe_and_at_most_s_otherwise(results, key):
    """Each rank's measured ``max_in_flight`` is its schedule's; gpipe holds
    all M = 4 microbatches, 1f1b and interleaved at most S = 2 (2 windows)."""
    schedule = key.split("/")[1]
    for rank in results["ranks"]:
        stage, got, static, windows = rank["in_flight"][key]
        assert got == static
        if schedule == "gpipe":
            assert (got, windows) == (ACCUM, 1)
        else:
            assert got <= 2 and windows == 2


def test_masked_batch_separates_the_token_mean_from_the_mean_of_microbatch_means(results):
    """The single-device step at grad_accum 4 averages 4 microbatch means;
    on this batch that is further from the pipeline's loss than the
    pipeline is from the global token mean (grad_accum 1)."""
    from repro_torch.core.strategy import uniform_plan
    from repro_torch.models import build_model
    from repro_torch.runtime.train import construct_hybrid_parallel_model

    case, refs = results["built"]["llama_tp2_sp_zero1"]
    cfg = case["cfg"]
    plan = uniform_plan(cfg.name, "t", (1,), ("data",), cfg.num_layers, LayerStrategy(),
                        grad_accum=ACCUM)
    hp = construct_hybrid_parallel_model(build_model(cfg, device="cpu"), plan)
    _, _, m = hp.train_step(case["params"], hp.init_opt_state(case["params"]), case["batch"],
                            torch.float32)
    pipe = results["ranks"][0]["runs"]["llama_tp2_sp_zero1/gpipe"]["step_loss"]
    off = abs(float(m["loss"]) - refs["loss"]) / refs["loss"]
    assert off > 1e-4 and off > 100 * abs(pipe - refs["loss"]) / refs["loss"], off


def test_stage_layout_and_hop_bytes(results):
    """tp 2: a stage's 2 layers with half the query heads; the hop moved
    fp32 boundary tensors of a rank's sequence shard (2 rows x 16 x 128)."""
    run = results["ranks"][0]["runs"]["llama_tp2_sp_zero1/gpipe"]
    assert run["local_shapes"]["blocks.attn.wq"] == (1, 2, 128, 2, 32)
    assert run["local_shapes"]["embed.tok"] == (256, 128)
    inter = results["ranks"][0]["runs"]["llama_tp2_sp_zero1/interleaved"]
    assert inter["local_shapes"]["blocks.attn.wq"] == (1, 2, 1, 128, 2, 32)
    # stage 0 under gpipe, two steps (value_and_grad, train_step): 4 sends, 4 receives each
    assert run["hop_bytes"]["sent"] == run["hop_bytes"]["received"] == 2 * 4 * 2 * 16 * 128 * 4
    assert run["hop_bytes"]["host_copies"] == 0


def test_refusals_on_the_mesh(results):
    got = results["ranks"][0]["refused"]
    assert got["zamba2_hybrid"][0] == "ValueError"
    assert "supports_layer_grouping" in got["zamba2_hybrid"][1]
    assert got["llama_mesh_mismatch"][0] == "ValueError"
    assert "model axis" in got["llama_mesh_mismatch"][1]


def test_stage_hop_ring_wraps_from_the_last_stage(results):
    """Ranks (stage, data, model): 0/1 on stage 0, 2/3 on stage 1; each
    receives the rank at its coordinates on the other stage."""
    for rank, res in enumerate(results["ranks"]):
        stage, got, both = res["ring"]
        peer = (rank + 2) % 4
        assert (stage, got, both) == (rank // 2, float(peer), float(peer + 10))


def _torchrun(*args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "4", "-m", "repro_torch.launch.train", "--arch", "llama3.2-1b", "--reduced",
         "--device", "cpu", "--seq", "32", "--batch", "8", *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


def test_torchrun_launcher_trains_a_pp2_plan_on_four_ranks():
    run = _torchrun("--pp", "2", "--pp-schedule", "1f1b", "--steps", "2", "--log-every", "1")
    assert run.returncode == 0, run.stdout + run.stderr
    plan_lines = [ln for ln in run.stdout.splitlines() if ln.startswith("plan[search]:")]
    assert len(plan_lines) == 1 and "pp=2/1f1b" in plan_lines[0], run.stdout
    assert "mesh=(2, 1, 2)" in plan_lines[0], run.stdout
    steps = [ln for ln in run.stdout.splitlines() if ln.startswith("step ")]
    assert len(steps) == 2 and "done" in run.stdout, run.stdout


def test_torchrun_launcher_refuses_an_infeasible_pp():
    """Interleaving 2 chunks over 2 stages needs 4 | the reduced llama's 2
    layers: no plan, and JAX's message."""
    run = _torchrun("--pp", "2", "--pp-schedule", "interleaved", "--steps", "1")
    assert run.returncode != 0
    assert "no feasible pp=2 cp=1 plan for --pp-schedule interleaved" in run.stderr, (
        run.stdout + run.stderr)
