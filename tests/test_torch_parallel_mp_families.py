"""The port's parallel runtime over gloo on the CPU, beyond the dense
decoder (see ``test_torch_parallel_mp.py`` for the references and their
tolerances): internvl2 at tp 2 (its ``vis_embeds`` prefix entering the
sequence), mamba2 at dp 4 with ZeRO-1 and ``full`` remat (K3's plain
version under the runner), and whisper at dp 4 with ZeRO-2 (its ``frames``
split with the batch), each on four ranks against the port's single-device
step and JAX's ``value_and_grad``.  Then, on two ranks: the runtime's
refusals of context parallelism (a plan mixing cp = 1 and cp > 1, naming its Queue 1
item, and cp on mamba2, which JAX's verifier rejects too), its errors for plans that are not
valid (ep on a family with no experts, a tp whose ranks' SSM heads
straddle B/C groups), and ``measure_allreduce``'s fit;
and the launcher under ``torchrun`` on four CPU ranks, which searches a
plan, prints its line once and trains (llama, moonshot: the moe family on
a mesh, and zamba2: the hybrid family), and whose ``--validate-only`` exits by ``check_plan``.
"""
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.core.strategy import LayerStrategy
from tests._torch_dist import run_ranks
from tests.test_torch_parallel_mp import check_jax, check_single_device, run_cases

ROOT = pathlib.Path(__file__).resolve().parents[1]

CASES = {
    "internvl2_tp2": ("internvl2-26b", [LayerStrategy(tp=2)], 1),
    "mamba2_dp4_zero1_full": ("mamba2-2.7b", [LayerStrategy(zero=1, remat="full")], 1),
    "whisper_dp4_zero2": ("whisper-tiny", [LayerStrategy(zero=2)], 1),
}

# pipelined plans (pp > 1) run: tests/test_torch_parallel_pp.py; dense
# plans with cp > 1: tests/test_torch_parallel_cp.py.  The last entry of
# each names the Queue 1 item its message must name, or None where JAX
# refuses the plan too (cp on a family other than dense: GALV031)
REFUSED = {
    "mamba2_cp2": ("mamba2-2.7b", (2, 1, 1), LayerStrategy(cp=2), 1,
                   "ValueError", "GALV031", None),
    "llama_cp2": ("llama3.2-1b", (2, 1, 1), [LayerStrategy(cp=2), LayerStrategy()], 1,
                  "NotImplementedError", "mixing cp = 1 and cp > 1", "Queue 1 item 4"),
}


# plans that are not valid: an error naming why, no Queue 1 item
INVALID = {
    "llama_ep2": ("llama3.2-1b", (2, 1), LayerStrategy(ep=2), 1,
                  "ValueError", "no layer has experts"),
    "moonshot_ep3": ("moonshot-v1-16b-a3b", (2, 1), LayerStrategy(ep=3), 1,
                     "ValueError", "GALV006"),
}

# a Mamba2 layout the port does not nest (GSPMD would reshard it): 12 SSM
# heads in 3 groups, so at tp 2 a rank's 6 heads read parts of two groups
LAYOUTS = {
    "zamba2_tp2_straddled_groups": ("zamba2-7b", (1, 2), LayerStrategy(tp=2), 1,
                                    "ValueError", "in 3 groups (ssm_groups)"),
}
OVERRIDES = {"zamba2_tp2_straddled_groups": {"d_model": 192, "ssm_groups": 3}}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(CASES, tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    payload = {"refused": {k: v[:4] + (OVERRIDES.get(k, {}),)
                           for k, v in {**REFUSED, **INVALID, **LAYOUTS}.items()}}
    return run_ranks(2, "refusals_and_fit", payload,
                     tmp_path_factory.mktemp("two"))[0]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_the_ports_single_device_step(results, name):
    check_single_device(*results[name])


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_grads_match_jax_value_and_grad(results, name):
    got, refs, _ = results[name]
    check_jax(got, refs)


@pytest.mark.parametrize("name", list(REFUSED))
def test_runtime_refuses_what_later_items_bring(two_ranks, name):
    kind, words, item = REFUSED[name][4:]
    got = two_ranks[name]
    assert got is not None, name
    assert got[0] == kind and words in got[1] and (item is None or item in got[1]), got


@pytest.mark.parametrize("name", list(INVALID))
def test_runtime_rejects_invalid_expert_plans(two_ranks, name):
    kind, words = INVALID[name][4:]
    got = two_ranks[name]
    assert got is not None, name
    assert got[0] == kind and words in got[1], got


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_runtime_rejects_layouts_it_cannot_nest(two_ranks, name):
    kind, words = LAYOUTS[name][4:]
    got = two_ranks[name]
    assert got is not None, name
    assert got[0] == kind and words in got[1] and "ssm_heads" in got[1], got


def test_measure_allreduce_fits_over_two_gloo_ranks(two_ranks):
    alpha, beta, r2 = two_ranks["fit"]
    assert beta > 0 and alpha >= 0 and r2 <= 1.0


ONE_RANK = {
    "moonshot_zero3": ("moonshot-v1-16b-a3b", LayerStrategy(zero=3)),
    "zamba2_zero3": ("zamba2-7b", LayerStrategy(zero=3)),
    "llama_zero3_selective": ("llama3.2-1b", LayerStrategy(zero=3, remat="selective")),
}


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    return run_ranks(1, "one_rank_steps", {"cases": ONE_RANK},
                     tmp_path_factory.mktemp("one"))[0]


@pytest.mark.parametrize("name", list(ONE_RANK))
def test_one_rank_zero3_bf16_steps_are_bitwise_the_single_device_steps(one_rank, name):
    """On a (1, 1) mesh ZeRO-3 gathers over one rank, so two bf16 steps
    must give ``mesh=None``'s losses and params bitwise: a leaf the layers
    read in fp32 (the MoE router) must reach them unrounded, and one they
    cast (``ParamDef.cast``) must take the same values; zamba2 gathers its
    whole model outside the runner."""
    l_mesh, l_one, differ = one_rank[name]
    assert l_mesh == l_one
    assert differ == []


def _torchrun(*args: str, arch: str = "llama3.2-1b") -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "4", "-m", "repro_torch.launch.train", "--arch", arch, "--reduced",
         "--device", "cpu", "--seq", "32", "--batch", "8", *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


def test_torchrun_launcher_trains_a_searched_plan_on_four_ranks():
    _check_trains(_torchrun("--steps", "2", "--log-every", "1"))


def test_torchrun_launcher_trains_moonshot_on_four_ranks():
    """The moe family on the launcher's mesh: its layers route the global
    microbatch."""
    _check_trains(_torchrun("--steps", "2", "--log-every", "1",
                            arch="moonshot-v1-16b-a3b"))


def test_torchrun_launcher_trains_zamba2_on_four_ranks():
    """The hybrid family on the launcher's mesh: the searched plan trains
    whatever tp it picks for the Mamba2 layers and the shared block."""
    _check_trains(_torchrun("--steps", "2", "--log-every", "1", arch="zamba2-7b"))


def _check_trains(run):
    assert run.returncode == 0, run.stdout + run.stderr
    plan_lines = [ln for ln in run.stdout.splitlines() if ln.startswith("plan[search]:")]
    assert len(plan_lines) == 1 and "mesh=(2, 2)" in plan_lines[0], run.stdout
    steps = [ln for ln in run.stdout.splitlines() if ln.startswith("step ")]
    assert len(steps) == 2 and "done" in run.stdout, run.stdout


def test_torchrun_launcher_validate_only_exits_by_check_plan():
    run = _torchrun("--validate-only")
    assert run.stdout.count("plan[search]:") == 1, run.stdout + run.stderr
    verdict = [ln for ln in run.stdout.splitlines() if ln.startswith("plan verification:")]
    assert len(verdict) == 1, run.stdout
    assert run.returncode == (0 if "OK" in verdict[0] else 1), run.stdout + run.stderr
    assert not any(ln.startswith("step ") for ln in run.stdout.splitlines())
