"""The port's launchers with ``--run-dir`` on the CPU against JAX's: the
train launcher's run log (event order, key sets, the plan's reason, the
logged steps, the async checkpoint writer's ``ckpt`` events), rendered by
``scripts/render_run.py`` unchanged; exactly one log under ``torchrun`` on
two gloo ranks; the serving launcher's log renders a serving section."""
import os
import pathlib
import subprocess
import sys

import pytest

from repro import obs as jobs
from repro.launch import train as jax_train
from repro_torch import obs as tobs
from repro_torch.configs.registry import get_config
from repro_torch.core.profiler_model import profile_model
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as launcher

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--arch", "llama3.2-1b", "--reduced", "--steps", "4", "--seq", "32", "--batch", "4",
        "--log-every", "2"]
#: JAX's one event the port does not write on the CPU: JAX reads ``memory``
#: from its compiled step's memory analysis before the first step; the port
#: logs ``torch.cuda.max_memory_allocated`` after it, on CUDA only
JAX_ONLY = {"memory"}


def _by_event(events):
    by = {}
    for e in events:
        by.setdefault(e["event"], []).append(e)
    return by


@pytest.fixture(scope="module")
def run_logs(tmp_path_factory):
    """Both launchers on the same arguments with ``--run-dir`` and async
    checkpoints every 2 steps; {package: (run dir, events)}."""
    root = tmp_path_factory.mktemp("obs-launch")
    logs = {}
    for name, main, extra in (("jax", jax_train.main, []),
                              ("torch", launcher.main, ["--device", "cpu"])):
        run_dir = root / name / "run0"
        rc = main(ARGS + extra + ["--run-dir", str(run_dir), "--ckpt-dir",
                                  str(root / name / "ck"), "--ckpt-every", "2"])
        assert rc in (None, 0)
        logs[name] = (run_dir, (jobs if name == "jax" else tobs).read_run(run_dir / "run.jsonl"))
    return logs


def test_train_log_is_jaxs_sequence_and_keys(run_logs):
    """The event types come in JAX's order (the writer thread's ``ckpt``
    events apart: they land when the write does) and each shared type has
    JAX's key set; the plan's reason is ``search``; steps 0, 2 (every 2)
    and 3 (the last) are logged."""
    jev, tev = run_logs["jax"][1], run_logs["torch"][1]
    order = lambda evs, skip: [e["event"] for e in evs if e["event"] not in skip]
    assert order(tev, {"ckpt"}) == order(jev, {"ckpt"} | JAX_ONLY)
    assert order(tev, {"ckpt"}) == ["run_start", "plan", "step", "step", "step", "run_end"]
    jby, tby = _by_event(jev), _by_event(tev)
    assert set(tby) == set(jby) - JAX_ONLY
    for kind, events in tby.items():
        if kind == "ckpt":
            continue
        assert [set(e) for e in events] == [set(e) for e in jby[kind]], kind
    assert tby["plan"][0]["reason"] == jby["plan"][0]["reason"] == "search"
    assert [e["step"] for e in tby["step"]] == [0, 2, 3]
    start, end = tby["run_start"][0], tby["run_end"][0]
    assert start["schema"] == 1 and start["devices"] == 1 and start["arch"] == "llama3.2-1b"
    assert end["steps"] == 4 and end["tokens"] == 4 * 4 * 32
    assert end["metrics"]["step_time_s"]["count"] == 4 and end["drift_sustained"] is False
    assert set(end["metrics"]) == set(jby["run_end"][0]["metrics"]) - {"peak_hbm_bytes"}
    # MFU: the 6N FLOPs of a step against one H100's 989 TFLOP/s
    flops = profile_model(get_config("llama3.2-1b").reduced(), 32).model_flops_per_token() * 128
    for e in tby["step"]:
        assert e["step_time_s"] > 0
        assert e["tokens_per_sec"] == pytest.approx(128 / e["step_time_s"], rel=1e-12)
        assert e["mfu"] == pytest.approx(flops / e["step_time_s"] / 989e12, rel=1e-12)


def test_async_checkpoint_events_are_jaxs(run_logs):
    """``CheckpointWriter(sink=...)``: one ``queued`` and one ``written``
    event a save (steps 2 and 4), each phase with JAX's keys; the run_end
    counts the writer's stall and the timeline holds the writer's spans."""
    per = {}
    for name, (_, events) in run_logs.items():
        ck = [e for e in events if e["event"] == "ckpt"]
        per[name] = ({(e["phase"], e["step"]) for e in ck},
                     {e["phase"]: set(e) for e in ck}, len(ck))
        end = events[-1]
        assert end["event"] == "run_end" and end["ckpt_stall_seconds"] > 0
        spans = {s["name"] for s in end["spans"]}
        assert {"ckpt_host_copy", "ckpt_enqueue"} <= spans
    assert per["torch"] == per["jax"]
    assert per["torch"][0] == {("queued", 2), ("written", 2), ("queued", 4), ("written", 4)}
    assert per["torch"][2] == 4


def test_render_run_renders_the_ports_log(run_logs):
    """``scripts/render_run.py`` (stdlib and ``repro.obs.sink`` only,
    unchanged) on the port's log prints the sections it prints for JAX's."""
    outs = {}
    for name, (run_dir, _) in run_logs.items():
        proc = subprocess.run([sys.executable, str(ROOT / "scripts" / "render_run.py"),
                               str(run_dir)], capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        outs[name] = proc.stdout
    for text in ("run report: run0", "p50", "p99", "MFU", "drift verdict:", "predicted split",
                 "checkpoints: 2 queued, 2 written", "plan[search]: tp1-z1 mesh=(1,) ga=1",
                 "arch=llama3.2-1b  seq=32  batch=4  steps=4  devices=1"):
        assert text in outs["torch"] and text in outs["jax"], text
    assert "GALV070" not in outs["torch"] and "peak HBM" not in outs["torch"]


def test_torchrun_writes_one_log_from_rank_zero(tmp_path):
    """Two gloo ranks under ``torchrun``: one ``run.jsonl`` (rank 0's), one
    ``run_start`` with ``devices == 2``, each logged step once, the plan
    with the search's rejections."""
    run_dir = tmp_path / "run"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "repro_torch.launch.train", *ARGS, "--device", "cpu", "--steps", "3",
         "--run-dir", str(run_dir)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert sorted(p.name for p in tmp_path.rglob("*")) == ["run", "run.jsonl"]
    events = tobs.read_run(run_dir / "run.jsonl")
    by = _by_event(events)
    assert len(by["run_start"]) == 1 and by["run_start"][0]["devices"] == 2
    assert [e["step"] for e in by["step"]] == [0, 2]
    assert by["plan"][0]["mesh_shape"] == [1, 2] and len(by["run_end"]) == 1
    assert [e["event"] for e in events][:3] == ["run_start", "plan", "search_rejections"]
    assert by["run_end"][0]["steps"] == 3


def test_serve_launcher_log_renders_a_serving_section(tmp_path, capsys):
    run_dir = tmp_path / "serve0"
    assert serve_launcher.main(["--arch", "llama3.2-1b", "--device", "cpu", "--batch", "3",
                                "--num-slots", "2", "--prompt-len", "12", "--max-new", "4",
                                "--prefill-chunk", "8", "--page-size", "4",
                                "--run-dir", str(run_dir)]) == 0
    assert "ttft: p50" in capsys.readouterr().out
    events = tobs.read_run(run_dir / "run.jsonl")
    assert events[0]["mode"] == "serve" and events[0]["batch"] == 3
    kinds = [e["event"] for e in events]
    assert kinds.count("request_start") == kinds.count("request_end") == 3
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" / "render_run.py"),
                           str(run_dir)], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "serving: 3 request(s) submitted, 3 completed, 0 evicted" in proc.stdout
    assert "ttft        p50" in proc.stdout and "queue depth" in proc.stdout
