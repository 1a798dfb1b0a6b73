"""The port's checkpointing (``runtime/compression.py``, ``runtime/checkpoint.py``,
the trainers' ``checkpoint_state`` / ``place_opt_state`` and the launcher's
``--ckpt-dir`` / ``--resume``) on the CPU:

* byte for byte with JAX, both ways: a JAX trainer's canonical state after
  one step (reduced llama3.2-1b) saved by JAX restores in the port bitwise
  equal to ``params_from_jax`` of it, optimizer state included, and the
  port's save of that state restores in JAX's ``restore`` bitwise, for
  codec zstd / zlib / raw x format v1 / v2 and for bf16 m and v; the two
  packages' directories of the same state are byte-identical;
* JAX's own ``tests/test_checkpoint.py`` cases held on the port's module;
* the trainers: a one-device fp32 resume bitwise the uninterrupted run; a
  checkpoint saved by two gloo ranks under tp 2 + sp, ZeRO-1 restored
  under ZeRO-3 on (data 2, model 1), on one rank, and on a pp 2 / 1f1b
  ``PipelineTrainer``, the next step within the distributed tolerances
  (loss and grad norm 1e-5 relative, each update within 2e-3 of its
  scale at AdamW eps 1e-4, as ``tests/test_torch_parallel_mp.py``);
* the launcher: ``--steps 4 --ckpt-every 2`` against ``--steps 2`` then
  ``--resume --steps 4`` bitwise, GALV050 on a resume as another model,
  and a two-rank ``torchrun`` resume.
"""
import hashlib
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core.strategy import ExecutionPlan as JaxPlan
from repro.core.strategy import LayerStrategy as JaxStrategy
from repro.models import build_model as jax_build_model
from repro.runtime import checkpoint as jckpt
from repro.runtime import optimizer as jopt
from repro.runtime import train as jtrain
from repro.runtime.data import SyntheticDataset as JaxDataset
from repro_torch.configs.registry import get_config
from repro_torch.core.strategy import ExecutionPlan, LayerStrategy, uniform_plan
from repro_torch.launch import train as launcher
from repro_torch.models import build_model
from repro_torch.models.common import params_from_jax, tree_leaves, tree_map
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime import compression as comp
from repro_torch.runtime.data import SyntheticDataset
from repro_torch.runtime.optimizer import AdamWConfig, AdamWState
from repro_torch.runtime.train import construct_hybrid_parallel_model
from tests._torch_dist import run_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "llama3.2-1b"


# ------------------------------------------------------------ JAX's state

_JAX_STATES: dict = {}


def jax_state(bf16: bool):
    """(JAX canonical params, JAX canonical opt, JAX plan) of a reduced
    llama after one JAX train step (m and v non-zero), m and v in bf16 when
    asked; cached per dtype."""
    if bf16 not in _JAX_STATES:
        cfg = jax_get_config(ARCH).reduced()
        strat = JaxStrategy()
        plan = JaxPlan(arch=ARCH, shape="t", mesh_axes=("data",), mesh_shape=(1,),
                       layer_strategies=[strat] * cfg.num_layers, default_strategy=strat)
        dt = jnp.bfloat16 if bf16 else jnp.float32
        hp = jtrain.construct_hybrid_parallel_model(
            jax_build_model(cfg), plan, opt_cfg=jopt.AdamWConfig(m_dtype=dt, v_dtype=dt))
        params = hp.init_params(jax.random.PRNGKey(0))
        batch = {k: jnp.asarray(v) for k, v in JaxDataset(cfg, seq_len=16,
                                                          global_batch=2).batch(0).items()}
        params, opt, _ = hp.jit_train_step(donate=False)(params, hp.init_opt_state(params),
                                                         batch)
        canon_p, canon_o = hp.checkpoint_state(params, opt)
        _JAX_STATES[bf16] = (jax.tree.map(np.asarray, canon_p),
                             jax.tree.map(np.asarray, canon_o), plan)
    return _JAX_STATES[bf16]


def port_state(jp, jo):
    """The port's trees of a JAX state: ``params_from_jax`` of the params,
    m and v in their JAX dtype, the step an int32 scalar."""
    to = lambda tree, dt: params_from_jax(tree, "cpu", dt)
    mdt = torch.bfloat16 if jax.tree.leaves(jo.m)[0].dtype.name == "bfloat16" else torch.float32
    return to(jp, torch.float32), AdamWState(
        step=torch.tensor(int(jo.step), dtype=torch.int32), m=to(jo.m, mdt), v=to(jo.v, mdt))


def raw(x) -> tuple[str, bytes]:
    """(numpy dtype name, bytes) of a JAX or port leaf."""
    if isinstance(x, torch.Tensor):
        name = ckpt._NUMPY_NAME[x.dtype]
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return name, x.contiguous().numpy().tobytes()
    x = np.asarray(x)
    return str(x.dtype), x.tobytes()


def assert_same_leaves(got, want):
    g, w = ckpt._flatten(got), ckpt._flatten(want)
    assert list(g) == list(w)
    for key in g:
        assert raw(g[key]) == raw(w[key]), key


def tree_digest(root: pathlib.Path) -> dict:
    return {str(f.relative_to(root)): hashlib.sha256(f.read_bytes()).hexdigest()
            for f in sorted(root.rglob("*")) if f.is_file()}


FORMATS = [(codec, version) for codec in ("zstd", "zlib", "raw") for version in (1, 2)]


@pytest.mark.parametrize("codec,version,bf16", [(c, v, False) for c, v in FORMATS]
                         + [("zlib", 2, True)])
def test_checkpoints_cross_packages_byte_for_byte(tmp_path, codec, version, bf16):
    jp, jo, jplan = jax_state(bf16)
    tp, to = port_state(jp, jo)
    plan = ExecutionPlan.from_json(jplan.to_json())
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jckpt.save(jax_dir, 3, jp, jo, jplan, codec=codec, version=version)
    ckpt.save(port_dir, 3, tp, to, plan, codec=codec, version=version)
    # the same state, the same codec: the same files, byte for byte
    assert tree_digest(jax_dir) == tree_digest(port_dir)
    # JAX's checkpoint in the port: params_from_jax of JAX's state, bitwise
    out = ckpt.restore(jax_dir, params_like=tp, opt_like=to)
    assert out["step"] == 3 and out["plan"] == plan
    assert isinstance(out["opt"], AdamWState)
    assert_same_leaves(out["params"], tp)
    assert_same_leaves(out["opt"], to)
    assert {x.dtype for x in tree_leaves(out["opt"].m)} == {torch.bfloat16 if bf16
                                                           else torch.float32}
    # the port's checkpoint in JAX, bitwise
    back = jckpt.restore(port_dir, params_like=jp, opt_like=jo)
    assert_same_leaves(back["params"], jp)
    assert_same_leaves(back["opt"], jo)


def test_keys_and_dtypes_are_jaxs(tmp_path):
    """The index's keys are JAX's flattening of a canonical state
    (``opt/.step``, ``opt/.m/...``), and a bf16 leaf is named
    ``bfloat16``."""
    jp, jo, jplan = jax_state(True)
    tp, to = port_state(jp, jo)
    ckpt.save(tmp_path, 1, tp, to)
    shards = json.loads((tmp_path / "step000000001.json").read_text())["shards"]
    want = sorted([f"params/{k}" for k in jckpt._flatten(jp)]
                  + [f"opt/{k}" for k in jckpt._flatten(jo)])
    assert sorted(shards) == want
    assert "opt/.step" in shards and shards["opt/.step"]["dtype"] == "int32"
    assert {r["dtype"] for k, r in shards.items() if k.startswith("opt/.m/")} == {"bfloat16"}
    assert {r["dtype"] for k, r in shards.items() if k.startswith("params/")} == {"float32"}


def test_msgpack_v1_written_by_jax_restores():
    jp, jo, _ = jax_state(False)
    tp, to = port_state(jp, jo)
    payload = {f"params/{k}": {"dtype": str(v.dtype), "shape": list(v.shape),
                               "data": v.tobytes()} for k, v in jckpt._flatten(jp).items()}
    got = ckpt.decode_blob(jckpt.encode_blob(payload, codec="zlib", use_msgpack=True))
    assert got.keys() == payload.keys()
    for key, rec in got.items():
        assert bytes(rec["data"]) == payload[key]["data"]


# ------------------------------------------------------------ JAX's cases

def _setup():
    cfg = get_config(ARCH).reduced()
    plan = uniform_plan(ARCH, "t", (1,), ("data",), cfg.num_layers, LayerStrategy())
    hp = construct_hybrid_parallel_model(build_model(cfg, device="cpu"), plan)
    params = hp.init_params(torch.Generator().manual_seed(0))
    return cfg, plan, hp, params


def assert_trees_equal(a, b):
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    assert fa.keys() == fb.keys()
    for key in fa:
        assert fa[key].dtype == fb[key].dtype and torch.equal(fa[key], fb[key]), key


def test_roundtrip(tmp_path):
    cfg, plan, hp, params = _setup()
    opt = hp.init_opt_state(params)
    ckpt.save(tmp_path, 7, params, opt, plan)
    assert ckpt.latest_step(tmp_path) == 7
    out = ckpt.restore(tmp_path, params_like=params, opt_like=opt)
    assert out["step"] == 7
    assert_trees_equal(out["params"], params)
    assert_trees_equal(out["opt"], opt)
    assert out["plan"].layer_strategies == plan.layer_strategies
    assert ckpt.restore(tmp_path).keys() == {"step", "plan"}


@pytest.mark.parametrize("version,pattern", [(1, "step*.ckpt"), (2, "step*.json")])
def test_gc_keeps_latest(tmp_path, version, pattern):
    cfg, plan, hp, params = _setup()
    for step in (1, 2, 3, 4, 5):
        ckpt.save(tmp_path, step, params, None, plan, keep=2, version=version)
    assert sorted(int(p.stem[4:]) for p in tmp_path.glob(pattern)) == [4, 5]
    assert ckpt.latest_step(tmp_path) == 5


def test_codec_registry():
    assert comp.best_codec().name == ("zstd" if comp._zstd_available() else "zlib")
    assert [(c.name, c.fmt_byte) for c in comp.CHECKPOINT_CODECS] == [
        ("zstd", 2), ("zlib", 1), ("raw", 0)]
    with pytest.raises(KeyError):
        comp.get_codec("lz4")
    with pytest.raises(ValueError):
        comp.codec_for_byte(250)


def test_missing_codec_raises_and_auto_degrades(monkeypatch):
    """A codec that is not installed is refused by name and by header byte
    with JAX's messages, and the writer's auto choice degrades to zlib."""
    blob = ckpt.encode_blob({"params/w": {"dtype": "float32", "shape": [2],
                                          "data": np.ones(2, np.float32).tobytes()}},
                            codec="zstd")
    gone = comp.CheckpointCodec("zstd", 2, lambda: False, comp._zstd_compress,
                                comp._zstd_decompress)
    monkeypatch.setitem(comp._BY_NAME, "zstd", gone)
    monkeypatch.setitem(comp._BY_BYTE, 2, gone)
    monkeypatch.setattr(comp, "CHECKPOINT_CODECS", (gone,) + comp.CHECKPOINT_CODECS[1:])
    assert comp.best_codec().name == "zlib"
    with pytest.raises(RuntimeError, match="registered but unavailable"):
        comp.get_codec("zstd")
    with pytest.raises(RuntimeError, match="which is not available here"):
        ckpt.decode_blob(blob)


def _blob_names(directory):
    return {p.name for p in (directory / "blobs").glob("*.gvck")}


def test_v2_dedup_repeated_saves_share_blobs(tmp_path):
    cfg, plan, hp, params = _setup()
    ckpt.save(tmp_path, 1, params, None, plan, keep=10)
    blobs_1 = _blob_names(tmp_path)
    ckpt.save(tmp_path, 2, params, None, plan, keep=10)
    assert _blob_names(tmp_path) == blobs_1
    mutated = dict(params)
    mutated["final_norm"] = tree_map(lambda x: x + 1.0, params["final_norm"])
    ckpt.save(tmp_path, 3, mutated, None, plan, keep=10)
    added = _blob_names(tmp_path) - blobs_1
    assert 0 < len(added) <= len(tree_leaves(params["final_norm"]))
    assert_trees_equal(ckpt.restore(tmp_path, 3, params_like=mutated)["params"], mutated)


def test_v2_refcount_gc_shared_blob_survives(tmp_path):
    cfg, plan, hp, params = _setup()
    for step in (1, 2, 3):
        ckpt.save(tmp_path, step, params, None, plan, keep=2)
    shared = _blob_names(tmp_path)
    other = tree_map(lambda x: x * 2.0 + 1.0, params)
    ckpt.save(tmp_path, 4, other, None, plan, keep=2)     # drops step 2
    assert _blob_names(tmp_path) >= shared                # step 3 still refs them
    ckpt.save(tmp_path, 5, other, None, plan, keep=2)     # drops step 3
    assert not (_blob_names(tmp_path) & shared)
    assert_trees_equal(ckpt.restore(tmp_path, 5, params_like=other)["params"], other)


def test_legacy_pre_header_file_restores(tmp_path):
    import msgpack
    import zstandard

    cfg, plan, hp, params = _setup()
    payload = {f"params/{k}": {"dtype": "float32", "shape": list(v.shape),
                               "data": v.numpy().tobytes()}
               for k, v in ckpt._flatten(params).items()}
    (tmp_path / "step000000001.ckpt").write_bytes(
        zstandard.ZstdCompressor().compress(msgpack.packb(payload, use_bin_type=True)))
    (tmp_path / "step000000001.json").write_text('{"step": 1, "plan": null}')
    (tmp_path / "MANIFEST").write_text('{"latest_step": 1}')
    assert_trees_equal(ckpt.restore(tmp_path, params_like=params)["params"], params)


def test_decode_blob_refuses_garbage_and_routes_legacy_by_magic():
    for junk in (b"", b"G", b"GVC", b"JUNKJUNKJUNK", b"\x00" * 64):
        with pytest.raises(ckpt.CorruptCheckpointError, match="corrupt or truncated") as e:
            ckpt.decode_blob(junk)
        assert "msgpack" not in str(e.value) and "zstandard" not in str(e.value)
    with pytest.raises(Exception) as e:          # a real zstd frame header, then junk
        ckpt.decode_blob(comp.LEGACY_ZSTD_MAGIC + b"\x00" * 16)
    assert not isinstance(e.value, ckpt.CorruptCheckpointError)


def test_header_fuzz_truncated_at_every_boundary():
    payload = {"params/w": {"dtype": "float32", "shape": [2, 2],
                            "data": np.arange(4, dtype=np.float32).tobytes()}}
    for codec in ("raw", "zlib"):
        blob = ckpt.encode_blob(payload, codec=codec)
        assert ckpt.decode_blob(blob)["params/w"]["shape"] == [2, 2]
        for i in range(len(blob)):
            with pytest.raises((ckpt.CorruptCheckpointError, ValueError)) as e:
                ckpt.decode_blob(blob[:i])
            assert "legacy checkpoint" not in str(e.value)


@pytest.mark.parametrize("codec", ["zlib", "raw"])
def test_v2_corrupt_shard_detected(tmp_path, codec):
    """A truncated shard (zlib: its stream breaks; raw: its length and
    hash) and, raw, a flipped byte (its content hash) are refused."""
    cfg, plan, hp, params = _setup()
    ckpt.save(tmp_path, 1, params, None, plan, codec=codec)
    victim = max((tmp_path / "blobs").glob("*.gvck"), key=lambda p: p.stat().st_size)
    data = victim.read_bytes()
    victim.write_bytes(data[: len(data) // 2])
    with pytest.raises((ckpt.CorruptCheckpointError, ValueError)):
        ckpt.restore(tmp_path, params_like=params)
    if codec == "raw":
        flipped = bytearray(data)
        flipped[-1] ^= 0xFF
        victim.write_bytes(bytes(flipped))
        with pytest.raises(ckpt.CorruptCheckpointError, match="content\\s?hash"):
            ckpt.restore(tmp_path, params_like=params)


def test_flatten_escapes_separator_no_collision(tmp_path):
    tree = {"a/b": np.float32(1.0), "a": {"b": np.float32(2.0)},
            "back\\slash": np.float32(3.0)}
    flat = ckpt._flatten(tree)
    assert list(flat) == list(jckpt._flatten(tree))
    assert "a\\/b" in flat and "a/b" in flat and "back\\\\slash" in flat
    ckpt.save(tmp_path, 1, tree)
    out = ckpt.restore(tmp_path, params_like=tree)["params"]
    assert float(out["a/b"]) == 1.0 and float(out["a"]["b"]) == 2.0
    assert float(out["back\\slash"]) == 3.0


def _params_tree(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(64, 64, generator=g), "b": torch.randn(64, generator=g),
            "emb": torch.randn(128, 32, generator=g).to(torch.bfloat16)}


def test_async_save_bitwise_identical_to_sync(tmp_path):
    tree = _params_tree()
    for step in (1, 2):
        ckpt.save(tmp_path / "sync", step, tree, keep=10)
    with ckpt.CheckpointWriter() as w:
        for step in (1, 2):
            w.save_async(tmp_path / "async", step, tree, keep=10)
    assert tree_digest(tmp_path / "sync") == tree_digest(tmp_path / "async")


def test_async_writer_drains_on_close_and_bounds_its_queue(tmp_path):
    """With max_pending 1, seven saves in a row each wait for the one
    before; wait() drains and names the newest step; close() too, and the
    writer starts again after it."""
    tree = _params_tree()
    w = ckpt.CheckpointWriter(max_pending=1)
    for step in range(1, 8):
        w.save_async(tmp_path, step, tree, keep=10)
    path = w.wait()
    assert path == tmp_path / "step000000007.json"
    assert w.saves_started == w.saves_completed == 7 and w.queue_depth == 0
    assert ckpt.latest_step(tmp_path) == 7 and w.blocked_seconds > 0
    assert w.close() == path
    w.save_async(tmp_path, 8, tree, keep=10)
    assert w.close() == tmp_path / "step000000008.json"


def test_async_snapshot_survives_a_donated_step(tmp_path):
    """The state saved by ``save_async`` is the state at the call: a
    ``train_step(..., donate=True)`` right after it updates the same
    tensors in place while the save may be in flight."""
    cfg, plan, hp, params = _setup()
    opt = hp.init_opt_state(params)
    batch = SyntheticDataset(cfg, seq_len=16, global_batch=2).batch(0)
    want = tree_map(lambda x: x.clone(), params)
    leaves = [x for x in tree_leaves(params)]
    with ckpt.CheckpointWriter() as w:
        w.save_async(tmp_path, 1, *hp.checkpoint_state(params, opt))
        new, opt, _ = hp.train_step(params, opt, batch, torch.float32, donate=True)
        assert all(a is b for a, b in zip(tree_leaves(new), leaves))   # in place
    out = ckpt.restore(tmp_path, params_like=want, opt_like=hp.init_opt_state(want))
    assert_trees_equal(out["params"], want)
    assert int(out["opt"].step) == 0
    assert not torch.equal(tree_leaves(new)[0], tree_leaves(want)[0])


def test_async_writer_error_surfaces_and_recovers(tmp_path):
    tree = _params_tree()
    w = ckpt.CheckpointWriter()
    blocked = tmp_path / "not-a-dir"
    blocked.write_text("a file where a directory must go")
    w.save_async(blocked, 1, tree)
    with pytest.raises(RuntimeError, match="async checkpoint writer failed"):
        w.wait()
    w.save_async(tmp_path, 2, tree)
    assert w.wait() == tmp_path / "step000000002.json"
    w.close()
    w.save_async(blocked, 3, tree)
    with pytest.raises(RuntimeError, match="async checkpoint writer failed"):
        w.close()


# ------------------------------------------------------------ trainers

def test_one_device_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    cfg, plan, hp, params = _setup()
    ds = SyntheticDataset(cfg, seq_len=16, global_batch=2)
    step = lambda p, o, i: hp.train_step(p, o, ds.batch(i), torch.float32)
    p, o = params, hp.init_opt_state(params)
    for i in range(2):
        p, o, _ = step(p, o, i)
    ckpt.save(tmp_path, 2, *hp.checkpoint_state(p, o), plan, codec="zlib")
    want_p, want_o, want_m = step(p, o, 2)

    cfg2, _, hp2, fresh = _setup()
    out = ckpt.restore(tmp_path, params_like=fresh, opt_like=hp2.init_opt_state(fresh))
    got_p, got_o, got_m = hp2.train_step(hp2.place_params(out["params"]),
                                         hp2.place_opt_state(out["opt"]), ds.batch(2),
                                         torch.float32)
    assert torch.equal(got_m["loss"], want_m["loss"])
    assert_trees_equal(got_p, want_p)
    assert_trees_equal(got_o, want_o)


def test_gloo_checkpoint_restores_under_other_plans(tmp_path):
    cfg = get_config(ARCH).reduced()
    opt_cfg = AdamWConfig(eps=1e-4)
    hp1 = construct_hybrid_parallel_model(build_model(cfg, device="cpu"), uniform_plan(
        ARCH, "t", (1,), ("data",), cfg.num_layers, LayerStrategy()), None, opt_cfg)
    params = hp1.init_params(torch.Generator().manual_seed(0))
    ds = SyntheticDataset(cfg, seq_len=32, global_batch=4)
    batches = [{k: torch.from_numpy(v) for k, v in ds.batch(i).items()} for i in range(2)]
    got = run_ranks(2, "checkpoint_cases", {"cfg": cfg, "opt": opt_cfg, "params": params,
                                            "batches": batches,
                                            "dir": str(tmp_path / "ck")}, tmp_path / "ranks")[0]
    assert got["zero3_back"] and got["pp_back"]
    # on one rank: the checkpoint is the gathered state, bitwise
    out = ckpt.restore(tmp_path / "ck", params_like=params,
                       opt_like=hp1.init_opt_state(params))
    flat = ckpt._flatten((out["params"], out["opt"]))
    assert flat.keys() == got["saved"].keys()
    assert all(torch.equal(flat[k], got["saved"][k]) for k in flat)
    assert out["plan"].mesh_shape == (1, 2) and int(out["opt"].step) == 1
    p0 = hp1.place_params(out["params"])
    new, new_opt, metrics = hp1.train_step(p0, hp1.place_opt_state(out["opt"]), batches[1],
                                           torch.float32)
    np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], float(metrics["grad_norm"]), rtol=1e-5)
    before = ckpt._flatten(p0)
    for key, x in ckpt._flatten(new).items():
        want = x - before[key]
        err = float((got["after"][f"0/{key}"] - x).abs().max())
        assert err <= 2e-3 * float(want.abs().max()), (key, err)
    assert int(got["after"]["1/.step"]) == 2


# ------------------------------------------------------------ launcher

def _launch(capsys, *args) -> tuple[int, str]:
    try:
        rc = launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--seq", "32",
                            "--batch", "4", "--log-every", "1", *args])
    except SystemExit as e:
        rc = e.code
    return rc, capsys.readouterr().out


def test_launcher_resume_is_bitwise_the_uninterrupted_run(tmp_path, capsys):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    rc, out = _launch(capsys, "--steps", "4", "--ckpt-every", "2", "--ckpt-dir", a)
    assert rc == 0 and "checkpoint queued (async) step 2" in out, out
    assert "checkpoint queued (async) step 4" in out and out.count("queued") == 2
    rc, out = _launch(capsys, "--steps", "2", "--ckpt-every", "2", "--ckpt-dir", b,
                      "--ckpt-async", "off")
    assert rc == 0 and out.count("checkpoint -> ") == 1, out    # the final save repeats it
    rc, out = _launch(capsys, "--steps", "4", "--ckpt-every", "2", "--ckpt-dir", b,
                      "--resume")
    assert rc == 0 and "resumed from step 2" in out, out
    assert [ln.split()[1] for ln in out.splitlines() if ln.startswith("step ")] == ["2", "3"]
    idx = lambda d: json.loads((pathlib.Path(d) / "step000000004.json").read_text())["shards"]
    assert idx(a) == idx(b)                       # every leaf's content hash
    fresh = _setup()[3]
    like = dict(params_like=fresh, opt_like=AdamWState(torch.zeros(()), fresh, fresh))
    assert_trees_equal(ckpt.restore(a, **like)["params"], ckpt.restore(b, **like)["params"])

    # GALV050: another model (12 layers of llama-100m) is refused before any param
    rc, out = _launch(capsys, "--preset", "100m", "--steps", "6", "--ckpt-dir", b,
                      "--resume")
    assert rc == 1, out
    galv = [ln for ln in out.splitlines() if ln.startswith("GALV050")]
    assert any("2 layers; new plan has 12" in ln for ln in galv), out
    assert "model:" not in out


def test_torchrun_launcher_resumes_on_two_ranks(tmp_path, capsys):
    d = str(tmp_path / "ck")
    rc, single = _launch(capsys, "--steps", "2", "--ckpt-dir", d, "--ckpt-async", "off")
    assert rc == 0, single
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "repro_torch.launch.train", "--arch", ARCH, "--reduced", "--device",
         "cpu", "--seq", "32", "--batch", "4", "--log-every", "1", "--steps", "3",
         "--ckpt-dir", d, "--resume"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert run.stdout.count("resumed from step 2") == 1, run.stdout
    steps = [ln.split()[1] for ln in run.stdout.splitlines() if ln.startswith("step ")]
    assert steps == ["2"], run.stdout
    assert "checkpoint queued (async) step 3" in run.stdout
    assert ckpt.latest_step(d) == 3
    out = ckpt.restore(d, params_like=_setup()[3])
    assert out["plan"].num_devices == 2 and out["step"] == 3
