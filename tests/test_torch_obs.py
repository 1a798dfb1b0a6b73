"""The port's telemetry (``repro_torch.obs``, the drift advisor of
``runtime/elastic.py``, ``core/visualize.py``) on the CPU against JAX's
``repro.obs``: the same calls give the same snapshots, records, timelines,
bytes and errors; each package reads the other's run log; the port's obs
imports with torch and numpy blocked; the fence waits for nothing on CPU
tensors; the scheduler's per-request events and metrics equal JAX's
scheduler's on the same requests (teacher-forced, bf16, eviction
included); the step engine's latency histograms and spans; the plan
renderer's text."""
import dataclasses
import json
import pathlib
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs.registry import get_config as jax_get_config
from repro.core import cluster as jcluster
from repro.core import strategy as jstrategy
from repro.core.visualize import render_plan as jax_render_plan
from repro.models import build_model as jax_build_model
from repro.models.common import cast_tree as jax_cast_tree
from repro.runtime.elastic import DriftReplanAdvisor as JaxAdvisor
from repro.runtime.kv_cache import PagedCacheConfig as JaxPagedCacheConfig
from repro.runtime.scheduler import ContinuousBatchingScheduler as JaxScheduler
from repro.runtime.scheduler import Request as JaxRequest
from repro import serving as jserving
from repro_torch import obs as tobs
from repro_torch import serving
from repro_torch.configs.registry import get_config
from repro_torch.core import cluster as tcluster
from repro_torch.core import strategy as tstrategy
from repro_torch.core.visualize import render_plan
from repro_torch.models import build_model
from repro_torch.models.common import params_from_jax
from repro_torch.runtime.elastic import DriftReplanAdvisor
from repro_torch.runtime.kv_cache import PagedCacheConfig
from repro_torch.runtime.optimizer import AdamWState
from repro_torch.runtime.scheduler import ContinuousBatchingScheduler, Request

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKGS = {"jax": jobs, "torch": tobs}


class FakeClock:
    """Deterministic clock: each call returns the time, then ticks."""

    def __init__(self, start=0.0, tick=1.0):
        self.now = start
        self.tick = tick

    def __call__(self):
        t = self.now
        self.now += self.tick
        return t

    def advance(self, dt):
        self.now += dt


def _both(fn):
    """fn(package) for JAX's obs and the port's; asserts the results equal
    and returns the port's."""
    got = {name: fn(pkg) for name, pkg in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


# ---------------------------------------------------------------- metrics

def _drive_registry(pkg):
    reg = pkg.MetricsRegistry()
    reg.counter("requests").inc()
    reg.counter("requests").inc(4)
    reg.gauge("queue_depth").set(3)
    reg.gauge("queue_depth").set(np.float32(1.5))
    reg.gauge("unset")
    h = reg.histogram("ttft_s")
    for v in [0.3, 0.1, 0.7, 0.2, 0.9, 0.4]:
        h.observe(v)
    reg.histogram("empty")
    small = pkg.Histogram("reservoir", max_samples=64)
    for i in range(1000):                        # past max_samples: decimated twice+
        small.observe(float(i) * 0.5)
    return (reg.snapshot(), small.snapshot(), small._values, small._stride,
            small.percentile(37.5), small.mean)


def test_metrics_snapshots_equal_jaxs():
    snap, res, values, stride, p, mean = _both(_drive_registry)
    assert snap["requests"] == 5 and snap["empty"] == {"count": 0}
    assert res["count"] == 1000 and len(values) < 64 and stride > 1


@pytest.mark.parametrize("first,second", [("counter", "gauge"), ("gauge", "histogram"),
                                          ("histogram", "counter")])
def test_kind_mismatch_raises_jaxs_error(first, second):
    def err(pkg):
        reg = pkg.MetricsRegistry()
        getattr(reg, first)("x")
        with pytest.raises(ValueError) as e:
            getattr(reg, second)("x")
        return str(e.value)

    assert "already registered" in _both(err)


def _drive_timer(pkg):
    clock = FakeClock(start=10.0, tick=0.25)
    reg = pkg.MetricsRegistry()
    timer = pkg.StepTimer(reg, tokens_per_step=128, flops_per_step=6e9, peak_flops=989e12,
                          clock=clock, fence_fn=lambda outputs: None)
    recs = []
    for step in range(3):
        timer.start()
        clock.advance(0.5 * step)
        recs.append(timer.stop(step).as_dict())
    bare = pkg.StepTimer(pkg.MetricsRegistry(), clock=FakeClock())
    bare.start()
    recs.append(bare.stop(7, None).as_dict())      # fence(None): a no-op
    with pytest.raises(RuntimeError, match="without start"):
        bare.stop(8)
    return recs, reg.snapshot()


def test_step_timer_records_equal_jaxs():
    recs, snap = _both(_drive_timer)
    assert [r["step"] for r in recs] == [0, 1, 2, 7]
    assert snap["steps"] == 3 and snap["step_time_s"]["count"] == 3
    assert recs[1]["tokens_per_sec"] == pytest.approx(128 / 0.75)


def _drive_tracer(pkg):
    tracer = pkg.Tracer(clock=FakeClock())
    with tracer.span("step"):
        with tracer.span("fwd"):
            pass
        with tracer.span("bwd"):
            with tracer.span("allreduce"):
                pass
    ctx = tracer.span("open")                    # a span left open, as after a crash
    ctx.__enter__()
    lock = threading.Lock()

    def worker():
        with lock, tracer.span("writer"):        # its own stack: depth 0, no parent
            pass

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    out = tracer.timeline(), tracer.total("fwd"), tracer.total("open")
    ctx.__exit__(None, None, None)
    with pytest.raises(ValueError, match="still open"):
        pkg.SpanRecord("x", 0.0).duration_s
    return out


def test_tracer_timelines_equal_jaxs():
    timeline, fwd, opened = _both(_drive_tracer)
    assert [(r["name"], r["depth"], r["parent"]) for r in timeline] == [
        ("step", 0, None), ("fwd", 1, "step"), ("bwd", 1, "step"), ("allreduce", 2, "bwd"),
        ("open", 0, None), ("writer", 0, None)]
    assert timeline[4]["t1"] is None and opened == 0.0 and fwd == 1.0


def test_default_span_lands_in_the_timeline_and_a_profile():
    before = len(tobs.default_tracer().timeline())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tobs.span("obs_probe"):
            torch.ones(4).sum()
    names = [r["name"] for r in tobs.default_tracer().timeline()[before:]]
    assert names == ["obs_probe"]
    assert "obs_probe" in {e.key for e in prof.key_averages()}


# ------------------------------------------------------------------- sink

def _write_log(pkg, run_dir):
    with pkg.RunSink.create(run_dir, clock=FakeClock(start=1.7e9, tick=0.125),
                            meta={"arch": "llama3.2-1b", "seq": 32}) as sink:
        sink.emit("plan", reason="search", mesh_shape=[1], notes="é ünïcode",
                  predicted_breakdown={"compute_s": 1e-7, "comm_s": 0.0})
        sink.emit("step", step=0, loss=np.float32(6.25), mfu=np.float64(1e-6),
                  grad_norm=torch.tensor(2.5), tokens=np.int64(128), nan=float("nan"))
        sink.emit("ckpt", phase="queued", step=2, stall_seconds=0.01, queue_depth=0)
    with pkg.RunSink.create(run_dir, clock=FakeClock(start=1.8e9)) as sink:  # reopened
        sink.emit("run_end", steps=1, metrics={"steps": 1}, spans=[])
    assert pkg.NullSink().emit("step", step=1) == {"event": "step", "step": 1}
    return (pathlib.Path(run_dir) / "run.jsonl").read_bytes()


def test_run_sinks_write_identical_bytes_and_read_each_other(tmp_path):
    logs = {name: _write_log(pkg, tmp_path / name / "run0") for name, pkg in PKGS.items()}
    assert logs["torch"] == logs["jax"]
    assert logs["torch"].count(b'"event": "run_start"') == 1      # no second on reopen
    for reader in PKGS.values():
        for writer in PKGS:
            events = reader.read_run(tmp_path / writer / "run0" / "run.jsonl")
            assert [e["event"] for e in events] == ["run_start", "plan", "step", "ckpt",
                                                    "run_end"]
            assert events[2]["grad_norm"] == 2.5 and events[2]["tokens"] == 128


def test_run_sink_keeps_lines_whole_under_threads(tmp_path):
    """More emitting threads than cores, with a short switch interval (the
    checkpoint writer's thread emits while the step loop does): every line
    of the log parses, every event is there once, and the clock's readings
    (taken under the sink's lock) run in file order without a gap."""
    import os

    threads, per = 2 * (os.cpu_count() or 2) + 2, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tobs.RunSink.create(tmp_path / "run0", clock=FakeClock()) as sink:
            def emit(i):
                for j in range(per):
                    sink.emit("step", step=j, thread=i, pad="x" * (j % 97))

            workers = [threading.Thread(target=emit, args=(i,)) for i in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
            assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    events = tobs.read_run(tmp_path / "run0" / "run.jsonl")[1:]
    assert sorted((e["thread"], e["step"]) for e in events) == [
        (i, j) for i in range(threads) for j in range(per)]
    assert [e["ts"] for e in events] == [float(k) for k in range(1, threads * per + 1)]


def test_live_line_is_jaxs():
    rec = {"step": 12, "loss": 2.3456, "grad_norm": 1.5, "tokens_per_sec": 12345.6,
           "mfu": 0.417, "step_time_s": 0.0213}
    assert _both(lambda pkg: pkg.format_live_line(rec)).startswith("step    12  loss 2.3456")
    assert _both(lambda pkg: (pkg.SCHEMA_VERSION, str(pkg.sink.RUNS_DIR))) == (1, "results/runs")


BAD_LOGS = {
    "truncated tail": ('{"event": "run_start", "schema": 1}\n{"event": "step", "st',
                       None),
    "garbage mid-file": ('{"event": "run_start", "schema": 1}\nnot json\n'
                         '{"event": "step"}\n', "CorruptRunLogError"),
    "not an event": ('{"event": "run_start", "schema": 1}\n[1, 2]\n', "CorruptRunLogError"),
    "stale schema": ('{"event": "run_start", "schema": 0}\n{"event": "step"}\n',
                     "StaleRunLogError"),
    "no run_start": ('{"event": "step", "step": 0}\n', "CorruptRunLogError"),
}


@pytest.mark.parametrize("case", sorted(BAD_LOGS))
def test_read_run_refuses_what_jax_refuses(tmp_path, case):
    text, error = BAD_LOGS[case]
    path = tmp_path / "run.jsonl"
    path.write_text(text)

    def read(pkg):
        if error is None:
            with pytest.warns(UserWarning, match="truncated final line"):
                return [e["event"] for e in pkg.read_run(path)]
        with pytest.raises(getattr(pkg, error)) as e:
            pkg.read_run(path)
        return str(e.value)

    _both(read)


# ------------------------------------------------------------------ fence

def test_fence_waits_for_nothing_on_the_cpu(monkeypatch):
    def no_sync(*a, **k):
        raise AssertionError("fence synchronized a CPU tree")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    opt = AdamWState(torch.zeros(()), {"w": torch.ones(3)}, {"w": torch.ones(3)})
    for tree in (None, torch.ones(2), ({"a": [torch.ones(1), (torch.zeros(2), 3)]}, opt),
                 "text", 4.0):
        tobs.fence(tree)
    assert not torch.cuda.is_initialized()


def test_obs_imports_without_torch_and_numpy(tmp_path):
    """The mirror of JAX's ``test_obs_importable_without_jax``: the sink,
    metrics, spans and drift work where only the stdlib exists."""
    code = (
        "import sys; sys.modules['torch'] = None; sys.modules['numpy'] = None\n"
        "sys.path.insert(0, 'src')\n"
        "from repro_torch import obs\n"
        f"s = obs.RunSink.create(r'{tmp_path}')\n"
        "s.emit('step', step=0); s.close()\n"
        "obs.fence(None); obs.fence({'x': [1.0]})\n"
        "with obs.span('host'): pass\n"
        "t = obs.StepTimer(obs.MetricsRegistry()); t.start(); t.stop(0, [1])\n"
        f"print(len(obs.read_run(r'{tmp_path}' + '/run.jsonl')))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "2"


# ------------------------------------------------------------ drift advisor

class _ListSink:
    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        self.events.append({"event": event, **fields})
        return self.events[-1]


def _drive_advisor(pkg, advisor_cls):
    """JAX's ``test_drift_replan_advisor_cooldown_and_rearm`` sequence."""
    def verdict(step, *, drifting, sustained):
        return pkg.DriftVerdict(step=step, measured_ema=0.5, predicted=0.1, ratio=5.0,
                                drifting=drifting, sustained=sustained)

    clock = FakeClock(tick=0.0)
    sink = _ListSink()
    adv = advisor_cls(sink, cooldown_s=100.0, clock=clock)
    seen = [adv.observe(None), adv.observe(verdict(1, drifting=True, sustained=False)),
            adv.observe(verdict(2, drifting=True, sustained=True))]
    clock.advance(50.0)
    seen.append(adv.observe(verdict(3, drifting=True, sustained=True)))
    clock.advance(60.0)
    seen.append(adv.observe(verdict(4, drifting=True, sustained=True)))
    seen.append(adv.observe(verdict(5, drifting=False, sustained=False)))
    seen.append(adv.observe(verdict(6, drifting=True, sustained=True)))
    return seen, sink.events, adv.signals_emitted


def test_drift_replan_advisor_emits_jaxs_events():
    got = _drive_advisor(tobs, DriftReplanAdvisor)
    assert got == _drive_advisor(jobs, JaxAdvisor)
    seen, events, n = got
    assert seen == [False, False, True, False, True, False, True] and n == 3
    assert [e["step"] for e in events] == [2, 4, 6]
    assert events[0]["code"] == "GALV070" and "no auto-replan" in events[0]["action"]


# ---------------------------------------------------------------- visualize

def _plans(jmod, tmod, num_layers: int):
    """(jax, torch) ExecutionPlans with the same fields: one strategy for
    every layer, and three groups (selective, tp 2 + sp full, cp 2)."""
    def make(mod, kind):
        if kind == "uniform":
            strats = [mod.LayerStrategy(remat="selective", zero=2)] * num_layers
        else:
            a = num_layers // 3
            strats = ([mod.LayerStrategy(remat="selective")] * a
                      + [mod.LayerStrategy(tp=2, sp=True, remat="full", zero=3)] * a
                      + [mod.LayerStrategy(cp=2)] * (num_layers - 2 * a))
        return mod.ExecutionPlan(arch="llama3.2-1b", shape="train_4k", mesh_axes=("data", "model"),
                                 mesh_shape=(4, 2), grad_accum=2, layer_strategies=strats,
                                 default_strategy=strats[0], predicted_step_time=0.4321,
                                 predicted_memory=12.3e9)

    return {kind: (make(jmod, kind), make(tmod, kind)) for kind in ("uniform", "mixed")}


@pytest.mark.parametrize("kind", ["uniform", "mixed"])
def test_render_plan_is_jaxs(kind):
    jcfg, tcfg = jax_get_config("llama3.2-1b"), get_config("llama3.2-1b")
    jplan, tplan = _plans(jstrategy, tstrategy, tcfg.num_layers)[kind]
    fields = dataclasses.asdict(jcluster.TPU_V5E_POD)
    want = jax_render_plan(jcfg, jplan, 4096, 64, cluster=jcluster.ClusterSpec(**fields))
    got = render_plan(tcfg, tplan, 4096, 64, cluster=tcluster.ClusterSpec(**fields))
    assert got == want
    if kind == "mixed":
        assert "R" in got and "S" in got and got.count("..") == 3
    assert render_plan(tcfg, tplan, 4096, 64).startswith("plan: llama3.2-1b")   # H100_1


# ---------------------------------------------------------------- scheduler

SCHED_ARCH = "llama3.2-1b"
S_PAGE, S_CTX, S_SLOTS, S_CHUNK, S_PROMPT = 4, 32, 3, 4, 10
MAX_NEW = [8, 7, 6, 5]


@pytest.fixture(scope="module")
def sched_weights():
    jm = jax_build_model(jax_get_config(SCHED_ARCH).reduced())
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(5)))


def _sched_events(events):
    return [(e["event"], e["rid"], e["queue_depth"], e.get("prompt_tokens"),
             e.get("generated_tokens"), e.get("max_new"), e.get("ttft_s"), e.get("tpot_s"))
            for e in events]


@pytest.mark.parametrize("num_pages", [None, 8], ids=["roomy", "oversubscribed"])
def test_scheduler_events_and_metrics_equal_jaxs(sched_weights, num_pages):
    """Both schedulers on the same bf16 weights follow one forced token
    stream (keyed by (rid, step)) on the same fake clock: the same
    (event, rid, queue_depth, prompt/generated tokens, TTFT, TPOT) list, the
    same metrics snapshot; the oversubscribed pool evicts."""
    jm, np_params = sched_weights
    vocab = get_config(SCHED_ARCH).reduced().vocab_size
    rng = np.random.default_rng(12)
    forced = {(rid, s): int(rng.integers(0, vocab))
              for rid in range(len(MAX_NEW)) for s in range(max(MAX_NEW))}
    prompts = rng.integers(0, vocab, (len(MAX_NEW), S_PROMPT), dtype=np.int32)

    def sample(logits, request, rng):
        return forced[(request.rid, len(request.tokens))]

    def run(sched, request_cls):
        reqs = [sched.submit(request_cls(prompt=p, max_new=n)).request
                for p, n in zip(prompts, MAX_NEW)]
        sched.run_until_drained()
        return [r.tokens for r in reqs], sched.stats()["evicted"]

    cfg = get_config(SCHED_ARCH).reduced()
    got = {}
    for name, pkg in PKGS.items():
        sink, reg = _ListSink(), pkg.MetricsRegistry()
        kw = dict(prefill_chunk=S_CHUNK, sample_fn=sample, metrics=reg, sink=sink,
                  clock=FakeClock(tick=0.5))
        geometry = dict(num_slots=S_SLOTS, page_size=S_PAGE, max_context=S_CTX,
                        num_pages=num_pages)
        if name == "jax":
            sched = JaxScheduler(jm, jax_cast_tree(jax.tree.map(jnp.asarray, np_params),
                                                   jnp.bfloat16),
                                 JaxPagedCacheConfig.for_model(cfg, **geometry), **kw)
            tokens, evicted = run(sched, JaxRequest)
        else:
            sched = ContinuousBatchingScheduler(
                build_model(cfg, device="cpu"), params_from_jax(np_params, "cpu", torch.bfloat16),
                PagedCacheConfig.for_model(cfg, **geometry), **kw)
            tokens, evicted = run(sched, Request)
        got[name] = (tokens, evicted, _sched_events(sink.events), reg.snapshot())
    assert got["torch"] == got["jax"]
    tokens, evicted, events, snap = got["torch"]
    assert (evicted > 0) == (num_pages is not None)
    kinds = [e[0] for e in events]
    assert kinds.count("request_evicted") == evicted
    assert kinds.count("request_end") == len(MAX_NEW) == snap["requests"]
    # a request evicted after its first token sees its prefill, and TTFT, again
    assert snap["tpot_s"]["count"] == len(MAX_NEW) <= snap["ttft_s"]["count"]
    assert snap["generated_tokens"] == sum(MAX_NEW)


def test_serving_build_passes_metrics_and_sink(sched_weights):
    _, np_params = sched_weights
    sink, reg = _ListSink(), tobs.MetricsRegistry()
    config = serving.ServeConfig(
        arch=SCHED_ARCH, reduced=True, device="cpu",
        cache=serving.CacheConfig(max_context=S_CTX, page_size=S_PAGE),
        scheduler=serving.SchedulerConfig(num_slots=2, prefill_chunk=S_CHUNK))
    session = serving.build(config, params=params_from_jax(np_params, "cpu"), metrics=reg,
                            sink=sink)
    prompt = np.arange(1, 7, dtype=np.int32)
    assert len(list(session.submit(serving.Request(prompt=prompt, max_new=3)))) == 3
    assert [e["event"] for e in sink.events] == ["request_start", "first_token", "request_end"]
    assert reg.snapshot()["generated_tokens"] == 3
    assert session.scheduler.sink is sink and session.scheduler.metrics is reg


# -------------------------------------------------------------- step engine

@pytest.mark.parametrize("pkg_name", ["jax", "torch"])
def test_step_engine_records_latencies_and_spans(sched_weights, pkg_name):
    """``greedy_generate_reference`` with ``metrics``: one prefill latency,
    max_new - 1 decode latencies, one ``prefill`` and max_new - 1
    ``decode`` spans, the request and token counters; the port's counts are
    JAX's."""
    jm, np_params = sched_weights
    B, S, new = 2, 6, 4
    prompts = np.random.default_rng(3).integers(1, 100, (B, S), dtype=np.int32)
    pkg = PKGS[pkg_name]
    reg = pkg.MetricsRegistry()
    before = len(pkg.default_tracer().timeline())
    if pkg_name == "jax":
        plan = jserving.single_device_plan(jm.cfg)
        engine = jserving.step_engine(jm, plan, metrics=reg)
        out = engine.greedy_generate_reference(jax.tree.map(jnp.asarray, np_params),
                                               jnp.asarray(prompts), new, S + new)
    else:
        model = build_model(get_config(SCHED_ARCH).reduced(), device="cpu")
        engine = serving.step_engine(model, serving.single_device_plan(model.cfg),
                                     dtype=torch.float32, device="cpu", metrics=reg)
        out = engine.greedy_generate_reference(params_from_jax(np_params, "cpu"),
                                               torch.from_numpy(prompts), new, S + new)
        assert len(engine.latencies["decode_s"]) == new - 1
    assert tuple(out.shape) == (B, new)
    snap = reg.snapshot()
    assert snap["prefill_latency_s"]["count"] == 1
    assert snap["decode_latency_s"]["count"] == new - 1
    assert snap["requests"] == 1 and snap["generated_tokens"] == B * new
    names = [r["name"] for r in pkg.default_tracer().timeline()[before:]]
    assert names == ["prefill"] + ["decode"] * (new - 1)


def test_engine_greedy_generate_hands_metrics_to_its_scheduler(sched_weights):
    _, np_params = sched_weights
    model = build_model(get_config(SCHED_ARCH).reduced(), device="cpu")
    reg = tobs.MetricsRegistry()
    engine = serving.step_engine(model, serving.single_device_plan(model.cfg),
                                 dtype=torch.float32, device="cpu", metrics=reg)
    out = engine.greedy_generate(params_from_jax(np_params, "cpu"),
                                 torch.ones(2, 5, dtype=torch.long), 3, 8)
    assert tuple(out.shape) == (2, 3)
    snap = reg.snapshot()
    assert snap["requests"] == 2 and snap["ttft_s"]["count"] == 2
    assert json.loads(json.dumps(snap)) == snap
