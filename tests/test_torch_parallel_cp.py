"""Context parallelism in the port's runtime over gloo on the CPU: spawned
ranks train the reduced llama3.2-1b (seq 64, a global batch of 4 whose row
1 has its first 3 labels masked) in fp32 on meshes with a ``cp`` axis,
each case held to the references of ``test_torch_parallel_mp.py`` (the
port's single-device step at grad_accum 1 and JAX's ``value_and_grad``):

* (cp 2, data 1, model 1);
* (cp 4, 1, 1) under ``full`` remat (the ring recomputed in the backward);
* (cp 2, data 2, 1) with ZeRO-2 (states over dp·cp = 4 ranks);
* (cp 2, 1, model 2) with tp 2 + sp, ZeRO-1, ``selective`` (SP's
  sequence shards nested inside each cp shard).

Three hazard guards, each the (cp 2, 1, 1) case run with one fault brought
in (``_torch_dist.inject_fault``), must fail both checks: the valid-token
count over the batch axes alone (cp dropped; the masked labels make the
ranks' counts differ), RoPE at the shard's local ``arange`` in place of its
global zig-zag positions, and a contiguous split of the sequence (each
rank a contiguous S/cp block at its own positions) into the zig-zag ring,
whose half-block steps then skip keys the block's queries see.

On 2 and 4 ranks the ring alone: ``ring_attention_local`` (the half-block
ring and its hand-written backward) and ``positional_ring_local`` (JAX's
positional form, differentiated through ``collectives.ring_shift``), rank
by rank against the serial ring, and the hop's bytes a call.  Then the
launcher: ``--cp 2`` under ``torchrun`` on two CPU ranks searches and
trains a cp plan; on one device it warns and ignores ``--cp``; an odd
``--seq`` and a non-dense arch are refused; ``--pp 2 --cp 2`` on four
ranks searches and trains a pp x cp plan.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.strategy import LayerStrategy
from tests._torch_dist import references, run_ranks
from tests.test_torch_parallel_mp import check_jax, check_single_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
AXES = ("cp", "data", "model")

CASES = {
    "llama_cp2": ((2, 1, 1), LayerStrategy(cp=2)),
    "llama_cp4_full": ((4, 1, 1), LayerStrategy(cp=4, remat="full")),
    "llama_cp2_dp2_zero2": ((2, 2, 1), LayerStrategy(cp=2, zero=2)),
    "llama_cp2_tp2_sp_zero1_selective": (
        (2, 1, 2), LayerStrategy(cp=2, tp=2, sp=True, zero=1, remat="selective")),
}
FAULTS = ("count", "rope", "contiguous")


def _case(name, mesh, strategy):
    case, refs = references(name, "llama3.2-1b", [strategy], 1, batch=4, seq=64)
    case.update(mesh=mesh, axes=AXES)
    return case, refs


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    built = {name: _case(name, *spec) for name, spec in CASES.items()}
    base, refs = built["llama_cp2"]
    faulty = [dict(base, name=f"fault_{f}", fault=f) for f in FAULTS]
    opt = refs["opt"]
    two = [c for c, _ in built.values() if np.prod(c["mesh"]) == 2] + faulty
    four = [c for c, _ in built.values() if np.prod(c["mesh"]) == 4]
    got = run_ranks(2, "train_cases", {"cases": two, "opt": opt},
                    tmp_path_factory.mktemp("two"))[0]
    got.update(run_ranks(4, "train_cases", {"cases": four, "opt": opt},
                         tmp_path_factory.mktemp("four"))[0])
    return got, built


@pytest.mark.parametrize("name", list(CASES))
def test_cp_step_matches_the_ports_single_device_step(results, name):
    got, built = results
    case, refs = built[name]
    check_single_device(got[name], refs, case)


@pytest.mark.parametrize("name", list(CASES))
def test_cp_grads_match_jax_value_and_grad(results, name):
    got, built = results
    check_jax(got[name], built[name][1])


@pytest.mark.parametrize("fault", FAULTS)
def test_each_hazard_guard_fails_under_its_fault(results, fault):
    got, built = results
    case, refs = built["llama_cp2"]
    with pytest.raises(AssertionError):
        check_single_device(got[f"fault_{fault}"], refs, case)
    with pytest.raises(AssertionError):
        check_jax(got[f"fault_{fault}"], refs)


def test_states_shard_over_dp_times_cp(results):
    """ZeRO-2 at (cp 2, data 2): the optimizer layout cuts the embed dim
    over the four ranks of data and cp; params stay whole (stage 2)."""
    got, _ = results
    shapes = got["llama_cp2_dp2_zero2"]["local_shapes"]
    assert shapes["blocks.attn.wq"] == (2, 128, 4, 32)
    tp = got["llama_cp2_tp2_sp_zero1_selective"]["local_shapes"]
    assert tp["blocks.attn.wq"] == (2, 128, 2, 32)


def _serial(payload):
    """The serial ring on the payload's tensors, cut into each rank's
    zig-zag shards: (outputs, grads) per rank."""
    from repro_torch.parallel import context

    B, S, H, hd = payload["shape"]
    gen = torch.Generator().manual_seed(payload.get("seed", 0))
    q = torch.randn(B, S, H, hd, generator=gen).requires_grad_()
    k, v = (torch.randn(B, S, payload["kv"], hd, generator=gen).requires_grad_()
            for _ in range(2))
    g = torch.randn(B, S, H, hd, generator=gen)
    out = context.ring_attention(q, k, v, causal=payload["causal"], cp=payload["cp"],
                                 use_flash=False)
    grads = torch.autograd.grad((out * g).sum(), (q, k, v))
    cut = lambda a, r: context.zigzag_shard(a.detach(), 1, r, payload["cp"])
    return [(cut(out, r), [cut(x, r) for x in grads]) for r in range(payload["cp"])]


@pytest.mark.parametrize("cp,causal", [(2, True), (4, True), (4, False)])
def test_ring_ranks_match_the_serial_ring(tmp_path, cp, causal):
    payload = {"shape": (2, 64, 4, 16), "kv": 2, "causal": causal, "cp": cp}
    got = run_ranks(cp, "ring_ops", payload, tmp_path)
    want = _serial(payload)
    B, S, _, hd = payload["shape"]
    block = B * (S // cp) * payload["kv"] * hd * 4          # one fp32 K or V shard
    for rank, (out, grads) in zip(got, want):
        for form in ("half", "positional"):
            torch.testing.assert_close(rank[form]["out"], out, atol=3e-5, rtol=3e-5)
            for a, b in zip(rank[form]["grads"], grads):
                torch.testing.assert_close(a, b, atol=3e-4, rtol=3e-4)
        # the half ring: k, v (cp - 1) times forward; k, v, dk, dv (cp - 1)
        # times and dk, dv home once backward
        sent = rank["half"]["bytes"]["sent"]
        assert sent == block * (2 * (cp - 1) + 4 * (cp - 1) + 2), sent
        assert rank["half"]["bytes"]["host_copies"] == 0


def _launch(*args, ranks=0):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    head = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(ranks)] if ranks else [sys.executable])
    return subprocess.run(head + ["-m", "repro_torch.launch.train", "--reduced",
                                  "--device", "cpu", *args],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


def test_launcher_trains_a_cp_plan_on_two_ranks():
    run = _launch("--steps", "2", "--log-every", "1", "--seq", "32", "--batch", "4",
                  "--cp", "2", ranks=2)
    assert run.returncode == 0, run.stdout + run.stderr
    plan = [ln for ln in run.stdout.splitlines() if ln.startswith("plan[search]:")]
    assert len(plan) == 1 and "-cp2-" in plan[0] and "mesh=(2, 1, 1)" in plan[0], run.stdout
    steps = [ln for ln in run.stdout.splitlines() if ln.startswith("step ")]
    assert len(steps) == 2 and "done" in run.stdout, run.stdout


@pytest.mark.parametrize("args,words", [
    (("--steps", "1", "--seq", "32", "--batch", "2", "--cp", "2"),
     "warning: --cp 2 ignored on a single device"),
    (("--seq", "30", "--cp", "2"), "--cp 2 needs --seq % (2*cp) == 0"),
    (("--arch", "mamba2-2.7b", "--seq", "32", "--cp", "2"),
     "--cp supports dense-family archs; mamba2-2.7b is ssm"),
])
def test_launcher_cp_on_one_device(args, words):
    run = _launch(*args)
    warned = words.startswith("warning")
    assert run.returncode == (0 if warned else 1), run.stdout + run.stderr
    assert words in (run.stdout if warned else run.stderr), run.stdout + run.stderr


def test_launcher_trains_a_pp_cp_plan_on_four_ranks():
    """``--pp 2 --cp 2`` under ``torchrun``: the search pins both, and
    ``PipelineTrainer`` trains the plan with the ring in every stage."""
    run = _launch("--steps", "2", "--log-every", "1", "--seq", "32", "--batch", "8",
                  "--pp", "2", "--cp", "2", ranks=4)
    assert run.returncode == 0, run.stdout + run.stderr
    plan = [ln for ln in run.stdout.splitlines() if ln.startswith("plan[search]:")]
    assert len(plan) == 1 and "pp=2" in plan[0] and "-cp2-" in plan[0], run.stdout
    assert "mesh=(2, 2, 1, 1)" in plan[0], run.stdout
    steps = [ln for ln in run.stdout.splitlines() if ln.startswith("step ")]
    assert len(steps) == 2 and "done" in run.stdout, run.stdout
