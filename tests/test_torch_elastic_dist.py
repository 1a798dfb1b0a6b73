"""The port's elastic resize across gloo ranks (``launch/mesh.py``'s prefix
meshes, ``runtime/resize.py``, ``launch/train.py``'s resize flags) on the
CPU:

* a (data 1, model 2) mesh over the first 2 ranks of a 4-rank world: its
  members hold the groups a 2-rank world gives them and reduce over them,
  the other ranks hold a mesh that says so and own no group;
* one spawn of 4 ranks through a shrink (tp 2 + sp ZeRO-2 on (2, 2) -> ZeRO-3
  ``selective`` on the first 2 ranks), a grow back to 4 (ZeRO-1 on (4, 1):
  two ranks join with no state), a restage onto pp 2 / 1f1b and JAX's
  pp 2 -> pp 1 restage onto 2 ranks: at each, ``migrate`` and
  ``migrate_via_checkpoint`` bitwise on every rank, the canonical state
  after equal to the one before, and the next step (donated on the
  in-memory state, bitwise the checkpoint state's) held to one rank's
  (``mesh=None``) on the same canonical state: fp32 loss within 1e-5
  relative, grads and the update within 2e-3 of their scale, AdamW eps
  1e-4 as ``tests/test_torch_parallel_mp.py``; then a replanned plan the
  runtime refuses (cp 1 and cp 2 mixed) raises on every rank;
* the launcher under ``torchrun --nproc-per-node 4``: 4 -> 2 -> 4 under
  ``--elastic-mode live`` and ``checkpoint`` print the same digest, and the
  run log holds JAX's ``plan`` (reason ``resize``) and ``resize`` events,
  which ``scripts/render_run.py`` renders;
* ``_parse_events``' refusals word for word JAX's.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import types

import pytest
import torch

from repro.launch import train as jlauncher
from repro_torch.configs.registry import get_config
from repro_torch.core.strategy import ExecutionPlan, LayerStrategy, uniform_plan
from repro_torch.launch import train as launcher
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.runtime.data import SyntheticDataset
from repro_torch.runtime.optimizer import AdamWConfig
from repro_torch.runtime.train import construct_hybrid_parallel_model
from tests._torch_dist import run_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "llama3.2-1b"
DM, PDM = ("data", "model"), ("pod", "data", "model")
#: (name, (mesh shape, axes, strategy, pp, schedule, grad_accum)); the first
#: is the plan trained before the first migration
PLANS = [
    ("start", ((2, 2), DM, LayerStrategy(tp=2, sp=True, zero=2), 1, "gpipe", 2)),
    ("shrink", ((1, 2), DM, LayerStrategy(zero=3, remat="selective"), 1, "gpipe", 1)),
    ("grow", ((4, 1), DM, LayerStrategy(zero=1), 1, "gpipe", 2)),
    ("stage", ((2, 1, 2), PDM, LayerStrategy(tp=2), 2, "1f1b", 2)),
    ("restage", ((1, 2), DM, LayerStrategy(), 1, "gpipe", 2)),
]
LOSS_RTOL, SCALE_TOL = 1e-5, 2e-3


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    """(the payload, every rank's ``elastic_cases`` result)."""
    tmp = tmp_path_factory.mktemp("elastic")
    cfg = get_config(ARCH).reduced()
    opt = AdamWConfig(eps=1e-4)
    hp = construct_hybrid_parallel_model(build_model(cfg, device="cpu"), uniform_plan(
        ARCH, "t", (1,), ("data",), cfg.num_layers, LayerStrategy()), None, opt)
    params = hp.init_params(torch.Generator().manual_seed(0))
    ds = SyntheticDataset(cfg, seq_len=32, global_batch=8)
    batches = [{k: torch.from_numpy(v) for k, v in ds.batch(i).items()} for i in range(len(PLANS))]
    mixed = [LayerStrategy(cp=2)] + [LayerStrategy()] * (cfg.num_layers - 1)
    payload = {"cfg": cfg, "opt": opt, "params": params, "batches": batches, "plans": PLANS,
               "mixed": ExecutionPlan(arch=ARCH, shape="train", mesh_axes=("cp",) + DM,
                                      mesh_shape=(2, 1, 2), layer_strategies=mixed,
                                      default_strategy=mixed[0])}
    return payload, run_ranks(4, "elastic_cases", payload, tmp / "ranks")


def test_prefix_mesh_holds_a_two_rank_worlds_groups(elastic):
    _, ranks = elastic
    for rank, res in enumerate(ranks):
        got = res["mesh"]
        assert got["member"] == (rank < 2)
        assert len(got["refused"]) == 2 and "asked for the first 3 of 4" in got["refused"][0]
        if rank < 2:
            # a (1, 2) mesh in a 2-rank world: data of 1, model and both of 2
            assert got["groups"] == {(): (1, 0), ("data",): (1, 0), ("model",): (2, rank),
                                     ("data", "model"): (2, rank)}
            assert got["coords"] == {"data": 0, "model": rank}
            assert got["model_sum"] == 3.0
        else:
            assert got["coords"] is None and "outside the mesh" in got["repr"]
            assert got["group_error"] == (f"rank {rank} is not in mesh {{'data': 1, 'model': 2}}"
                                          " (ranks 0 .. 1): it owns no group")


@pytest.mark.parametrize("name", [name for name, _ in PLANS[1:]])
def test_migrations_agree_bitwise_and_keep_the_canonical_state(elastic, name):
    i = [n for n, _ in PLANS].index(name)
    old_n, new_n = (torch.Size(PLANS[i - 1][1][0]).numel(), torch.Size(PLANS[i][1][0]).numel())
    recs = [res["events"][name] for res in elastic[1]]
    want = recs[0]["before"]
    assert recs[0]["paths"] == ("in-memory", "checkpoint")
    for rank, rec in enumerate(recs):
        assert rec["old_member"] == (rank < old_n) and rec["new_member"] == (rank < new_n)
        assert rec["carried"] == (i, 8 * i, True)
        if rank < old_n:
            assert rec["before"] == want
        if rank < new_n:
            assert rec["bitwise"] and rec["step_bitwise"], rank
            assert rec["after"] == want, rank             # joiners' included
            nbytes = rec["moved"][0]
            assert nbytes == rec["moved"][1] > 0
        else:
            assert "bitwise" not in rec and rec["moved"] == (0, 0)
    assert recs[0]["restage"] == (name in ("stage", "restage"))
    assert f"{old_n}->{new_n} devices" in recs[0]["spec"]


@pytest.mark.parametrize("name", [name for name, _ in PLANS[1:]])
def test_step_after_a_migration_holds_to_one_rank(elastic, name):
    payload, ranks = elastic
    i = [n for n, _ in PLANS].index(name)
    rec = ranks[0]["events"][name]
    cfg = payload["cfg"]
    params, opt = rec["state"]
    plan = uniform_plan(ARCH, "t", (1,), ("data",), cfg.num_layers, LayerStrategy(),
                        grad_accum=max(PLANS[i][1][5], PLANS[i][1][3]))
    hp = construct_hybrid_parallel_model(build_model(cfg, device="cpu"), plan, None,
                                         payload["opt"])
    batch = payload["batches"][i]
    loss, _, grads = hp.value_and_grad(params, batch, torch.float32)
    new, _, metrics = hp.train_step(params, opt, batch, torch.float32)
    assert abs(rec["vg_loss"] - float(loss)) <= LOSS_RTOL * abs(float(loss))
    assert abs(rec["step_loss"] - float(metrics["loss"])) <= LOSS_RTOL * abs(float(metrics["loss"]))
    for got, g in zip(tree_leaves(rec["grads"]), tree_leaves(grads)):
        assert float((got - g).abs().max()) <= SCALE_TOL * float(g.abs().max())
    for got, x, before in zip(tree_leaves(rec["new"]), tree_leaves(new), tree_leaves(params)):
        step = float((x - before).abs().max())
        assert float((got - x).abs().max()) <= SCALE_TOL * step


def test_a_refused_replan_raises_on_every_rank(elastic):
    for res in elastic[1]:
        kind, msg = res["mixed"]
        assert kind == "NotImplementedError" and "mixing cp = 1 and cp > 1" in msg
        assert res["mixed_kept"]


# ------------------------------------------------------------ launcher

def _torchrun(*args) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "4", "-m", "repro_torch.launch.train", "--arch", ARCH, "--reduced", "--device", "cpu",
         "--steps", "6", "--seq", "32", "--batch", "8", "--log-every", "1",
         "--simulate-failure-at-step", "2,4", "--resize-to", "2,4", "--digest", *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


def test_launcher_live_and_checkpoint_resizes_print_one_digest(tmp_path):
    runs = {mode: _torchrun("--elastic-mode", mode, "--run-dir", str(tmp_path / mode))
            for mode in ("live", "checkpoint")}
    digests = {}
    for mode, run in runs.items():
        assert run.returncode == 0, run.stdout + run.stderr
        out = run.stdout
        assert out.count(f"devices ({mode})") == 2, out
        assert out.count("plan[resize]:") == 2 and out.count("   migration spec: ") == 2, out
        assert [ln.split()[1] for ln in out.splitlines() if ln.startswith("step ")] == [
            "0", "1", "2", "3", "4", "5"], out
        digests[mode] = [ln for ln in out.splitlines() if ln.startswith("digest ")]
        assert len(digests[mode]) == 1, out
    assert digests["live"] == digests["checkpoint"]

    events = [json.loads(ln) for ln in (tmp_path / "live" / "run.jsonl").read_text().splitlines()]
    plans = [e for e in events if e["event"] == "plan" and e["reason"] == "resize"]
    resizes = [e for e in events if e["event"] == "resize"]
    assert [p["mesh_shape"] for p in plans] == [[1, 2], [1, 4]]
    assert [p["migration"] for p in plans] == [r["migration"] for r in resizes]
    assert [(r["step"], r["old_devices"], r["new_devices"], r["path"]) for r in resizes] == [
        (2, 4, 2, "in-memory"), (4, 2, 4, "in-memory")]
    assert {k for r in resizes for k in r} == {
        "event", "ts", "step", "old_devices", "new_devices", "reason", "path", "seconds",
        "bytes_moved", "migration"}
    report = subprocess.run([sys.executable, str(ROOT / "scripts" / "render_run.py"),
                             str(tmp_path / "live")], capture_output=True, text=True,
                            cwd=ROOT, timeout=60)
    assert report.returncode == 0, report.stderr
    assert "resize @ step 2: 4 -> 2 devices (in-memory" in report.stdout
    assert "resize @ step 4: 2 -> 4 devices (in-memory" in report.stdout


@pytest.mark.parametrize("steps,sizes,n_dev", [
    ("", "2", 4), ("1,2", "2", 4), ("2,2", "2,4", 4), ("1", "0", 4), ("1", "8", 4),
    ("1,3", "", 4), ("3,1", "", 4)])
def test_parse_events_refusals_are_jaxs(steps, sizes, n_dev):
    args = types.SimpleNamespace(simulate_failure_at_step=steps, resize_to=sizes)
    outcome = []
    for parse in (jlauncher._parse_events, launcher._parse_events):
        try:
            outcome.append(("ok", parse(args, n_dev)))
        except SystemExit as e:
            outcome.append(("exit", str(e)))
    assert outcome[0] == outcome[1]


def test_one_device_refuses_resize_and_keeps_the_advisory(capsys):
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--seq", "32", "--batch", "4",
            "--steps", "2", "--log-every", "1"]
    with pytest.raises(SystemExit, match="--resize-to needs a multi-device pool"):
        launcher.main(argv + ["--simulate-failure-at-step", "1", "--resize-to", "1"])
    assert launcher.main(argv + ["--simulate-failure-at-step", "1", "--digest"]) == 0
    out = capsys.readouterr().out
    assert "!! simulated node failure: re-searching plan for 75% capacity" in out
    assert "plan[replan-advisory]: " in out and "(elastic replan: 256->192 (node-failure))" in out
    assert len([ln for ln in out.splitlines() if ln.startswith("digest params=")]) == 1
