"""The step audit on real ranks: one spawn of 4 gloo ranks, and the
launcher's ``--audit`` on one device and under ``torchrun``.

* On (data 2, model 2), tp 2 + sp ZeRO-1 and dp ZeRO-3 (a tp 1 plan, whose
  batch axes take the model axis too): every rank's census of its real
  ``train_step`` equals the census its fake-world twin traces on fake
  tensors — labels, kinds, counts and bytes; the trainers' abstract trees
  (``HybridParallelModel`` and, on (pod 2, data 1, model 2),
  ``PipelineTrainer``) have ``init_params`` / ``init_opt_state``'s local
  shapes and dtypes on every rank.
* ``launch.train --audit`` emits JAX's ``audit`` event (its keys, ``ok``
  true) on one device (``main`` in this process) and under ``torchrun`` on
  2 ranks with a tp 2 plan (``--batch 3`` leaves tp 2 the only split), and
  again after a live resize to one rank; it refuses a planted defect
  (JAX's forced-f32: the forward run in fp32 under a bf16 plan, GALV091)
  with JAX's text before any real step, on both.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import pytest

from tests._torch_dist import run_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
AUDIT_KEYS = {"event", "ts", "ok", "codes", "error_codes", "predicted_bytes", "measured_bytes",
              "unresolved_loops", "axes"}
CASES = [
    ("tp2-sp-z1", (2, 2), ("data", "model"),
     {"strategy": {"tp": 2, "sp": True, "zero": 1, "remat": "selective"}}),
    ("dp-z3", (2, 2), ("data", "model"), {"strategy": {"zero": 3, "remat": "full"},
                                          "grad_accum": 2}),
    ("pp2-tp2", (2, 1, 2), ("pod", "data", "model"),
     {"strategy": {"tp": 2, "zero": 1}, "pp": 2, "pp_schedule": "gpipe", "grad_accum": 2}),
]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(4, "audit_cases", {"cases": CASES, "census": [c[0] for c in CASES[:2]],
                                        "seq": 32, "batch": 8},
                     tmp_path_factory.mktemp("audit"))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_abstract_trees_are_the_placed_trees(ranks, name):
    assert all(r["abstract"][name] == (True, True) for r in ranks)


@pytest.mark.parametrize("name", [c[0] for c in CASES[:2]])
def test_fake_census_equals_the_real_steps(ranks, name):
    for r in ranks:
        assert r["real"][name], "a step with no collective proves nothing"
        assert r["fake"][name] == r["real"][name]
    labels = {row[0] for r in ranks for row in r["real"][name]}
    assert labels == ({"data", "model"} if name.startswith("tp") else {"data+model"})


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return env


LAUNCH = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--steps", "2",
          "--seq", "32", "--audit"]
#: a launcher whose model runs its forward in fp32 (JAX's forced-f32 defect)
FORCED_F32 = ("import sys, torch\nfrom repro_torch.models.transformer import "
              "DenseTransformerLM as M\nfwd = M.forward_train\n"
              "M.forward_train = lambda self, *a, **k: fwd(self, *a, **{**k, "
              "'dtype': torch.float32})\n"
              "from repro_torch.launch.train import main\n"
              "raise SystemExit(main(sys.argv[1:]))\n")


def _run(cmd, tmp_path, timeout=240):
    return subprocess.run(cmd, cwd=tmp_path, env=_env(), capture_output=True, text=True,
                          timeout=timeout)


def _audit_events(run_dir: pathlib.Path) -> list:
    events = [json.loads(line) for line in (run_dir / "run.jsonl").read_text().splitlines()]
    return [e for e in events if e["event"] == "audit"]


def _defect(monkeypatch):
    """JAX's forced-f32 defect: the dense model's forward in fp32."""
    import torch

    from repro_torch.models.transformer import DenseTransformerLM

    fwd = DenseTransformerLM.forward_train
    monkeypatch.setattr(DenseTransformerLM, "forward_train", lambda self, *a, **k: fwd(
        self, *a, **{**k, "dtype": torch.float32}))


def _in_process(argv, capsys):
    from repro_torch.launch.train import main

    try:
        rc, why = main(argv), ""
    except SystemExit as e:      # JAX's text is the exit's code, as python prints it
        rc, why = (1, e.code) if isinstance(e.code, str) else (e.code, "")
    out = capsys.readouterr()
    return rc, out.out + out.err + why


def _torchrun(argv, tmp_path, script=None):
    head = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
            "2"] + ([str(script)] if script else ["-m", "repro_torch.launch.train"])
    r = _run(head + argv, tmp_path)
    return r.returncode, r.stdout + r.stderr


@pytest.mark.parametrize("ranks_", [1, 2])
def test_launcher_audit_event(tmp_path, ranks_, capsys):
    """One device in this process; two gloo ranks under ``torchrun``, whose
    live resize to one rank before step 2 audits the rebuilt step again."""
    argv = LAUNCH + ["--batch", "3" if ranks_ == 2 else "4", "--remat", "selective",
                     "--run-dir", str(tmp_path / "run")]
    if ranks_ == 2:
        argv = argv + ["--steps", "3", "--simulate-failure-at-step", "2", "--resize-to", "1"]
    rc, text = _in_process(argv, capsys) if ranks_ == 1 else _torchrun(argv, tmp_path)
    assert rc == 0, text
    events = _audit_events(tmp_path / "run")
    assert len(events) == ranks_
    for ev in events:
        assert set(ev) == AUDIT_KEYS and ev["ok"] is True and ev["unresolved_loops"] == 0
    if ranks_ == 2:
        assert "plan[search]: tp2" in text and "plan[resize]: tp1" in text
        assert [a["axis"] for a in events[0]["axes"]] == ["model"]
        assert events[1]["axes"] == []                   # one rank: no collective
    assert text.count("step audit: OK") == ranks_ and "step 0 loss" in text


@pytest.mark.parametrize("ranks_", [1, 2])
def test_launcher_refuses_a_planted_defect_before_any_step(tmp_path, ranks_, capsys,
                                                           monkeypatch):
    argv = LAUNCH + ["--batch", "3" if ranks_ == 2 else "4", "--remat", "selective",
                     "--run-dir", str(tmp_path / "run")]
    if ranks_ == 1:
        _defect(monkeypatch)
        rc, text = _in_process(argv, capsys)
    else:
        script = tmp_path / "forced_f32.py"
        script.write_text(FORCED_F32)
        rc, text = _torchrun(argv, tmp_path, script)
    assert rc != 0
    assert "step audit failed: GALV091 — the traced step does not match the plan" in text
    assert "step 0 loss" not in text
    assert [e["error_codes"] for e in _audit_events(tmp_path / "run")] == [["GALV091"]]
