"""Fault-tolerant checkpointing: async, sharded, content-addressed (the port
of ``repro.runtime.checkpoint``).

Checkpoints store the *canonical* (ungrouped, unstaged) parameter tree, so
a restore may lay the state out for a different ExecutionPlan: the
trainers' ``place_params`` / ``place_opt_state`` take the canonical trees
and cut this rank's shards of them.

The bytes on disk are JAX's, so either package restores what the other
wrote, and the same state written by both with the same codec gives
byte-identical directories.  Format v2 (sharded, content-addressed, the
default writer)::

    dir/
      blobs/<sha256-prefix>.gvck    one GVCK blob per unique leaf content
      stepNNNNNNNNN.json            index: leaf key -> {blob, dtype, shape, nbytes}
      MANIFEST                      {"latest_step": N}

Every shard blob is named by the SHA-256 of its *uncompressed* bytes, so a
leaf whose content did not change between steps is written once and shared
across step indexes; ``_gc`` is index-aware refcounting GC: a blob survives
until the last step index referencing it is dropped.

Shard blobs and v1 single-file checkpoints share the 7-byte header::

    b"GVCK" | version u8 | codec u8 | serializer u8

The codec byte names the compression codec (``runtime.compression``); the
serializer byte the payload encoding: 0 = the native framing (JSON index +
concatenated raw buffers), 1 = msgpack (read only, imported lazily; JAX
writes it when asked to), 2 = one raw leaf (v2 shard blobs; dtype and
shape live in the step index).  v1 single-file checkpoints (``stepNNNNNNNNN.ckpt``) and
legacy pre-header files (bare zstd-compressed msgpack) stay readable;
anything whose first bytes are neither a GVCK header nor a zstd frame is
refused as corrupt (:class:`CorruptCheckpointError`).

Leaf keys are JAX's: the path of a leaf joined by ``/`` with each part
escaped (``_escape_part``), dict keys in sorted order, a NamedTuple field
as ``.name`` (so an ``AdamWState`` gives ``opt/.step``, ``opt/.m/...`` and
``opt/.v/...``).  dtype strings are numpy's names; a bf16 leaf is written
as its raw bytes under ``"bfloat16"`` (through a 16-bit integer view, since
numpy has no bf16 of its own) and read back the same way.  ``restore``
returns torch tensors on the CPU.

The blobs of a v2 step are hashed, compressed and written, and read back,
by ``_IO_THREADS`` threads; the bytes are those of JAX's serial loop.

Async writes: :class:`CheckpointWriter` takes a value snapshot of every
leaf (``begin_host_snapshot``: on the card, non-blocking copies into pinned
host buffers on the current stream, ahead of the next step's kernels, and
an event the writer thread waits on before it hashes; on the CPU, clones),
so a donated step that updates the state in place right after
``save_async`` cannot reach the written bytes.  The thread hashes,
compresses and writes behind a bounded queue (double buffering: the step
loop only ever blocks on the *previous* save); ``wait()`` / ``close()``
drain and raise the writer's error.  The synchronous :func:`save` shares
the write path byte for byte and stays the oracle.

Writes go to a temp name + atomic rename; a MANIFEST names the latest
complete step, so a crash mid-write never corrupts a restore.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import queue
import struct
import threading
import time
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.strategy import ExecutionPlan
from repro_torch.runtime import compression

MAGIC = b"GVCK"
FORMAT_V1 = 1                  # single-file payload (read + opt-in write)
FORMAT_V2 = 2                  # sharded content-addressed layout (default)

SERIALIZER_NATIVE = 0
SERIALIZER_MSGPACK = 1
SERIALIZER_RAW_LEAF = 2        # v2 shard blobs: payload is one leaf's bytes

#: hex characters of the SHA-256 digest used for blob names (128 bits)
_HASH_CHARS = 32
#: threads that hash, compress, write and read shard blobs (hashlib, zlib
#: and file I/O release the GIL on large buffers)
_IO_THREADS = min(8, os.cpu_count() or 1)

#: torch dtype -> numpy's name, as JAX writes it; bf16 goes through a
#: 16-bit integer view of the same bytes
_NUMPY_NAME = {torch.float64: "float64", torch.float32: "float32", torch.float16: "float16",
               torch.bfloat16: "bfloat16", torch.int64: "int64", torch.int32: "int32",
               torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8",
               torch.bool: "bool"}


class CorruptCheckpointError(ValueError):
    """A checkpoint blob that is demonstrably truncated or corrupt, as
    opposed to one that merely needs an optional dependency to decode."""


# --------------------------------------------------------------------------
# payload serializers
# --------------------------------------------------------------------------

def _have_msgpack() -> bool:
    try:
        import msgpack  # noqa: F401
        return True
    except ImportError:
        return False


def _pack_native(payload: dict) -> bytes:
    """JSON index + concatenated raw buffers."""
    index: dict = {}
    blobs: list[bytes] = []
    off = 0
    for key, rec in payload.items():
        data = rec["data"]
        index[key] = {"dtype": rec["dtype"], "shape": rec["shape"],
                      "offset": off, "length": len(data)}
        blobs.append(data)
        off += len(data)
    head = json.dumps(index).encode("utf-8")
    return struct.pack("<Q", len(head)) + head + b"".join(blobs)


def _unpack_native(buf: bytes) -> dict:
    if len(buf) < 8:
        raise CorruptCheckpointError(
            f"corrupt or truncated checkpoint payload: {len(buf)} bytes is "
            "too short for the native index header")
    (head_len,) = struct.unpack_from("<Q", buf, 0)
    if 8 + head_len > len(buf):
        raise CorruptCheckpointError(
            "corrupt or truncated checkpoint payload: index head of "
            f"{head_len} bytes exceeds the {len(buf)}-byte payload")
    index = json.loads(bytes(buf[8:8 + head_len]).decode("utf-8"))
    base = 8 + head_len
    out = {}
    for key, rec in index.items():
        stop = base + rec["offset"] + rec["length"]
        if stop > len(buf):
            raise CorruptCheckpointError(
                f"corrupt or truncated checkpoint payload: leaf {key!r} "
                f"extends to byte {stop} of a {len(buf)}-byte payload")
        out[key] = {"dtype": rec["dtype"], "shape": rec["shape"],
                    "data": buf[base + rec["offset"]: stop]}
    return out


def _deserialize(buf: bytes, serializer: int) -> dict:
    if serializer == SERIALIZER_MSGPACK:
        if not _have_msgpack():
            raise RuntimeError("checkpoint was serialized with msgpack, which "
                               "is not installed here")
        import msgpack

        return msgpack.unpackb(buf, raw=False)
    if serializer != SERIALIZER_NATIVE:
        raise ValueError(f"unknown checkpoint serializer byte {serializer}")
    return _unpack_native(buf)


# --------------------------------------------------------------------------
# blob encode/decode (header + codec + serializer)
# --------------------------------------------------------------------------

def encode_blob(payload: dict, *, codec: Optional[str] = None) -> bytes:
    """v1 whole-payload blob: header + compressed native payload (the port
    reads msgpack payloads and writes none)."""
    c = compression.best_codec(codec)
    body = c.compress(_pack_native(payload))
    return MAGIC + bytes([FORMAT_V1, c.fmt_byte, SERIALIZER_NATIVE]) + body


def _split_header(blob: bytes, what: str) -> tuple[int, int, int, memoryview]:
    """(version, codec_byte, serializer, body) of a GVCK blob, or a clear
    corruption error; the body is a view of the blob, not a copy.  Callers
    guarantee ``blob[:4] == MAGIC``."""
    if len(blob) < 7:
        raise CorruptCheckpointError(
            f"corrupt or truncated {what}: GVCK header cut short at "
            f"{len(blob)} bytes (a complete header is 7)")
    return blob[4], blob[5], blob[6], memoryview(blob)[7:]


def decode_blob(blob: bytes) -> dict:
    """Decode a v1 whole-payload blob (or a legacy pre-header file)."""
    if blob[:4] == MAGIC:
        version, codec_byte, serializer, body = _split_header(blob, "checkpoint file")
        if version == FORMAT_V2:
            raise ValueError(
                "this is a v2 shard blob (one leaf of a sharded checkpoint); "
                "restore it through its step index (stepNNNNNNNNN.json), not "
                "as a whole-checkpoint file")
        if version != FORMAT_V1:
            raise ValueError(f"unsupported checkpoint format version {version}")
        if serializer not in (SERIALIZER_NATIVE, SERIALIZER_MSGPACK):
            raise ValueError(f"unknown checkpoint serializer byte {serializer}")
        c = compression.codec_for_byte(codec_byte)
        if serializer == SERIALIZER_MSGPACK and not _have_msgpack():
            raise RuntimeError("checkpoint was serialized with msgpack, which "
                               "is not installed here")
        try:
            return _deserialize(c.decompress(body), serializer)
        except CorruptCheckpointError:
            raise
        except Exception as e:
            raise CorruptCheckpointError(
                f"corrupt or truncated checkpoint file: body failed to "
                f"decode ({type(e).__name__}: {e})") from e
    if blob[:4] == compression.LEGACY_ZSTD_MAGIC:
        return _decode_legacy(blob)
    raise CorruptCheckpointError(
        f"corrupt or truncated checkpoint file: first bytes {blob[:8]!r} "
        "are neither a GVCK header nor a legacy zstd frame")


def _decode_legacy(blob: bytes) -> dict:
    """Pre-header files: bare zstd-compressed msgpack."""
    try:
        import msgpack
        import zstandard
    except ImportError as e:
        raise RuntimeError(
            "legacy checkpoint (no GVCK header) needs the optional "
            "'zstandard' and 'msgpack' packages to restore; re-save it from "
            "an environment that has them") from e
    return msgpack.unpackb(zstandard.ZstdDecompressor().decompress(blob), raw=False)


def _shard_parts(raw, codec: Optional[str]) -> tuple:
    """(header, compressed body) of a v2 shard blob of the buffer ``raw``."""
    c = compression.best_codec(codec)
    return MAGIC + bytes([FORMAT_V2, c.fmt_byte, SERIALIZER_RAW_LEAF]), c.compress(raw)


def encode_shard(raw: bytes, *, codec: Optional[str] = None) -> bytes:
    """v2 shard blob: header + compressed raw leaf bytes (metadata lives in
    the step index, keyed by the blob's content hash)."""
    return b"".join(_shard_parts(raw, codec))


def decode_shard(blob: bytes):
    """The raw leaf bytes of a v2 shard blob (a view of ``blob`` under the
    raw codec)."""
    if blob[:4] != MAGIC:
        raise CorruptCheckpointError(
            f"corrupt or truncated shard blob: first bytes {blob[:8]!r} are "
            "not a GVCK header")
    version, codec_byte, serializer, body = _split_header(blob, "shard blob")
    if version != FORMAT_V2 or serializer != SERIALIZER_RAW_LEAF:
        raise ValueError(
            f"not a v2 shard blob (version {version}, serializer "
            f"{serializer}); whole-checkpoint files decode via decode_blob")
    c = compression.codec_for_byte(codec_byte)
    try:
        return c.decompress(body)
    except Exception as e:
        raise CorruptCheckpointError(
            f"corrupt or truncated shard blob: decompress failed "
            f"({type(e).__name__}: {e})") from e


def content_hash(raw) -> str:
    """Content address of a shard: SHA-256 prefix of the raw leaf bytes
    (any buffer: bytes, memoryview, or a contiguous ndarray)."""
    return hashlib.sha256(raw).hexdigest()[:_HASH_CHARS]


# --------------------------------------------------------------------------
# tree <-> payload
# --------------------------------------------------------------------------

def _escape_part(part: str) -> str:
    """Make the '/' join unambiguous: a literal separator inside a leaf key
    would otherwise collide with a nested path."""
    return part.replace("\\", "\\\\").replace("/", "\\/")


def _children(node):
    """(key part, child) pairs of an inner node in JAX's flattening order,
    or None for a leaf: a dict's keys sorted, a NamedTuple's fields as
    ``.name``, a list's or tuple's indices."""
    if isinstance(node, Mapping):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(node)]
    return None


def _flatten(tree, prefix: tuple = ()) -> dict:
    """{path key: leaf} in JAX's order (None is an empty subtree)."""
    flat: dict = {}
    if tree is None:
        return flat
    kids = _children(tree)
    if kids is None:
        flat["/".join(_escape_part(p) for p in prefix)] = tree
        return flat
    for part, child in kids:
        flat.update(_flatten(child, prefix + (part,)))
    return flat


def _rebuild(like, leaf_of, prefix: tuple = ()):
    """``like``'s structure with each leaf replaced by ``leaf_of(path key)``."""
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        return leaf_of("/".join(_escape_part(p) for p in prefix))
    if isinstance(like, Mapping):
        return {k: _rebuild(like[k], leaf_of, prefix + (str(k),)) for k in like}
    values = [_rebuild(child, leaf_of, prefix + (part,)) for part, child in kids]
    if hasattr(like, "_fields"):
        return type(like)(*values)
    return type(like)(values)


def _map_leaves(fn, tree):
    flat = _flatten(tree)
    return _rebuild(tree, lambda key: fn(flat[key]))


class HostSnapshot:
    """Host copies of some trees' leaves, taken by ``begin_host_snapshot``.
    ``wait()`` returns the trees once every copy has landed."""

    def __init__(self, trees: tuple, events: list):
        self._trees = trees
        self._events = events

    def wait(self) -> tuple:
        for event in self._events:
            event.synchronize()
        self._events = []
        return self._trees


def begin_host_snapshot(*trees) -> HostSnapshot:
    """A value snapshot of every leaf, safe against a later in-place update.
    A CUDA tensor is copied with ``non_blocking=True`` into a pinned host
    buffer on its device's current stream, so the copy runs ahead of any
    kernel queued after this call (a donated step's update); an event
    recorded behind the copies is what ``HostSnapshot.wait`` waits on.  A
    CPU tensor or numpy array is cloned now; other leaves (Python and numpy
    scalars) are immutable and pass through."""
    devices: dict = {}

    def copy(leaf):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            if leaf.device.type == "cuda":
                host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
                host.copy_(leaf, non_blocking=True)
                devices[leaf.device] = True
                return host
            return leaf.clone()
        if isinstance(leaf, np.ndarray):
            return leaf.copy()
        return leaf

    snap = tuple(_map_leaves(copy, tree) for tree in trees)
    events = []
    for device in devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        events.append(event)
    return HostSnapshot(snap, events)


def canonical_checkpoint_state(trainer, params, opt_state=None):
    """The trainer's state in the canonical (ungrouped, unstaged) trees
    checkpoints store: ``trainer.gather_params`` of the params (under its
    ``param_specs``) and of m and v (under its ``opt_specs``), every leaf
    whole, and the step scalar as it is.  On one device these are the live
    tensors themselves, and on a mesh a leaf no rank shards is too; the
    writers take their own snapshot (``save`` copies to the host,
    ``CheckpointWriter.save_async`` through ``begin_host_snapshot``)."""
    canon_p = trainer.gather_params(params)
    canon_o = None
    if opt_state is not None:
        canon_o = type(opt_state)(
            step=opt_state.step, m=trainer.gather_params(opt_state.m, trainer.opt_specs),
            v=trainer.gather_params(opt_state.v, trainer.opt_specs))
    return canon_p, canon_o


def _host_array(leaf) -> tuple[str, np.ndarray]:
    """(numpy dtype name as JAX writes it, a contiguous host array of the
    leaf's bytes)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype not in _NUMPY_NAME:
            raise TypeError(f"checkpoint leaf of dtype {t.dtype}: not one of "
                            f"{sorted(_NUMPY_NAME.values())}")
        name = _NUMPY_NAME[t.dtype]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, t.numpy()
    arr = np.ascontiguousarray(np.asarray(leaf))
    return str(arr.dtype), arr


def _host_arrays(params, opt_state) -> dict:
    """{payload key: (dtype name, host array)}: what both writers write."""
    out: dict = {}
    for name, tree in (("params", params), ("opt", opt_state)):
        for key, leaf in _flatten(tree).items():
            out[f"{name}/{key}"] = _host_array(leaf)
    return out


def _leaf_from(rec: dict, like) -> torch.Tensor:
    """A CPU tensor of a payload record (its own memory), 0-d where the
    template leaf ``like`` is (format v2 records a scalar's shape as [1],
    as JAX's writer does)."""
    name, shape, data = rec["dtype"], rec["shape"], rec["data"]
    if getattr(like, "shape", None) == () and list(shape) == [1]:
        shape = []
    if name == "bfloat16":
        arr = np.frombuffer(data, dtype=np.int16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(data, dtype=name).reshape(shape).copy())


# --------------------------------------------------------------------------
# write path (shared by sync save and the async writer thread)
# --------------------------------------------------------------------------

def _atomic_write(path: pathlib.Path, *parts) -> None:
    """``parts`` (buffers) one after another into ``path``, through a temp
    name and a rename (atomic on POSIX)."""
    tmp = path.parent / f".tmp-{path.name}"
    with open(tmp, "wb") as f:
        for part in parts:
            f.write(part)
    tmp.rename(path)


def _index_path(directory: pathlib.Path, step: int) -> pathlib.Path:
    return directory / f"step{step:09d}.json"


def _write_step(directory: pathlib.Path, step: int, arrays: dict,
                plan: Optional[ExecutionPlan], keep: int,
                extra_meta: Optional[dict], codec: Optional[str],
                version: int) -> pathlib.Path:
    directory.mkdir(parents=True, exist_ok=True)
    meta = {"step": step,
            "plan": json.loads(plan.to_json()) if plan else None,
            **(extra_meta or {})}

    if version == FORMAT_V1:
        payload = {key: {"dtype": name, "shape": list(arr.shape), "data": arr.tobytes()}
                   for key, (name, arr) in arrays.items()}
        final = directory / f"step{step:09d}.ckpt"
        _atomic_write(final, encode_blob(payload, codec=codec))
    elif version == FORMAT_V2:
        blob_dir = directory / "blobs"
        blob_dir.mkdir(exist_ok=True)
        # as JAX's: a scalar is recorded as [1]
        leaves = {key: np.ascontiguousarray(arr) for key, (_, arr) in arrays.items()}
        keys = sorted(leaves)
        with ThreadPoolExecutor(_IO_THREADS) as pool:
            hashes = dict(zip(keys, pool.map(lambda k: content_hash(leaves[k]), keys)))
            # content-addressed dedup: an unchanged leaf is hashed, not copied
            fresh = {hashes[k]: leaves[k] for k in keys
                     if not (blob_dir / f"{hashes[k]}.gvck").exists()}
            list(pool.map(lambda h: _atomic_write(
                blob_dir / f"{h}.gvck",
                *_shard_parts(memoryview(fresh[h].reshape(-1).view(np.uint8)), codec)), fresh))
        shards = {k: {"blob": hashes[k], "dtype": arrays[k][0],
                      "shape": list(leaves[k].shape), "nbytes": int(leaves[k].nbytes)}
                  for k in keys}
        meta = {"format": FORMAT_V2, "shards": shards, **meta}
        final = _index_path(directory, step)
    else:
        raise ValueError(f"unknown checkpoint write version {version}")

    _atomic_write(_index_path(directory, step),
                  json.dumps(meta, indent=2, sort_keys=True).encode("utf-8"))
    _atomic_write(directory / "MANIFEST",
                  json.dumps({"latest_step": step}).encode("utf-8"))
    _gc(directory, keep)
    return final


def save(
    directory: str | pathlib.Path,
    step: int,
    params: Any,
    opt_state: Any = None,
    plan: Optional[ExecutionPlan] = None,
    *,
    keep: int = 3,
    extra_meta: Optional[dict] = None,
    codec: Optional[str] = None,           # None = auto (zstd -> zlib -> raw)
    version: int = FORMAT_V2,              # v1 = single-file (compat writer)
) -> pathlib.Path:
    """Synchronous save: blocks for the device-to-host copies, hashing,
    compression and writes.  :class:`CheckpointWriter` writes the same
    bytes; this stays the oracle."""
    return _write_step(pathlib.Path(directory), step, _host_arrays(params, opt_state),
                       plan, keep, extra_meta, codec, version)


# --------------------------------------------------------------------------
# GC: step retention + index-aware blob refcounting
# --------------------------------------------------------------------------

def _step_ids(directory: pathlib.Path) -> list[int]:
    steps = {int(p.stem[4:]) for p in directory.glob("step*.ckpt")}
    steps |= {int(p.stem[4:]) for p in directory.glob("step*.json")}
    return sorted(steps)


def _gc(directory: pathlib.Path, keep: int):
    """Drop all but the newest ``keep`` steps, then remove every shard blob
    no surviving step index references (a blob shared by several steps
    lives until the last one goes)."""
    for old in _step_ids(directory)[:-keep] if keep > 0 else []:
        (directory / f"step{old:09d}.ckpt").unlink(missing_ok=True)
        _index_path(directory, old).unlink(missing_ok=True)
    blob_dir = directory / "blobs"
    if not blob_dir.is_dir():
        return
    live: set[str] = set()
    for step in _step_ids(directory):
        try:
            meta = json.loads(_index_path(directory, step).read_text())
        except (OSError, ValueError):
            continue                      # v1 step without/with bad sidecar
        if meta.get("format") == FORMAT_V2:
            live |= {rec["blob"] for rec in meta["shards"].values()}
    for blob in blob_dir.glob("*.gvck"):
        if blob.stem not in live:
            blob.unlink(missing_ok=True)


def latest_step(directory: str | pathlib.Path) -> Optional[int]:
    manifest = pathlib.Path(directory) / "MANIFEST"
    if not manifest.exists():
        return None
    return int(json.loads(manifest.read_text())["latest_step"])


# --------------------------------------------------------------------------
# async writer
# --------------------------------------------------------------------------

class CheckpointWriter:
    """Double-buffered background checkpoint writer.

    ``save_async`` takes a value snapshot of the state
    (``begin_host_snapshot``: on the card its copies are queued on the
    current stream, so a donated step queued after this call cannot change
    what is written) and enqueues the hash / compress / write work onto a
    single writer thread, which waits for the snapshot's copies first.  The
    queue is bounded at ``max_pending`` (default 1), so the step loop only
    ever blocks when the *previous* save is still in flight.  ``wait()``
    drains the queue and re-raises any writer-thread error; ``close()``
    also stops the thread.  Usable as a context manager.
    ``blocked_seconds`` sums the time ``save_async`` held its caller.

    ``sink`` is accepted and unused: the run sink is Queue 1 item 7.
    """

    def __init__(self, max_pending: int = 1, *, sink=None):
        self._queue: queue.Queue = queue.Queue(maxsize=max(max_pending, 1))
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._last_path: Optional[pathlib.Path] = None
        self._stop = object()              # sentinel
        self._sink = sink
        self.blocked_seconds = 0.0         # cumulative step-loop stall time
        self.saves_started = 0
        self.saves_completed = 0

    # ------------------------------------------------------------ internals
    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._worker, name="ckpt-writer",
                                            daemon=True)
            self._thread.start()

    def _worker(self):
        while True:
            job = self._queue.get()
            try:
                if job is self._stop:
                    return
                directory, step, snapshot, kw = job
                path = _write_step(directory, step, _host_arrays(*snapshot.wait()), **kw)
                with self._lock:
                    self._last_path = path
                    self.saves_completed += 1
            except BaseException as e:  # noqa: BLE001 — surfaced on wait()
                with self._lock:
                    if self._error is None:
                        self._error = e
            finally:
                self._queue.task_done()

    def _raise_pending(self):
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("async checkpoint writer failed; state may be "
                               "missing its latest checkpoint") from err

    # ------------------------------------------------------------ public api
    def save_async(
        self,
        directory: str | pathlib.Path,
        step: int,
        params: Any,
        opt_state: Any = None,
        plan: Optional[ExecutionPlan] = None,
        *,
        keep: int = 3,
        extra_meta: Optional[dict] = None,
        codec: Optional[str] = None,
        version: int = FORMAT_V2,
    ) -> None:
        """Queue a save.  Returns as soon as the snapshot's copies are queued
        and a writer slot is free, i.e. blocks only on the previous save."""
        self._raise_pending()
        t0 = time.perf_counter()
        with record_function("ckpt_host_copy"):
            job = (pathlib.Path(directory), step, begin_host_snapshot(params, opt_state),
                   dict(plan=plan, keep=keep, extra_meta=extra_meta, codec=codec,
                        version=version))
        self._ensure_thread()
        with record_function("ckpt_enqueue"):
            self._queue.put(job)           # blocks iff previous still pending
        self.saves_started += 1
        self.blocked_seconds += time.perf_counter() - t0

    @property
    def queue_depth(self) -> int:
        """Saves currently queued behind the writer thread."""
        return self._queue.qsize()

    def wait(self) -> Optional[pathlib.Path]:
        """Drain every queued save; raise the first writer error if any.
        Returns the path of the newest completed step artifact."""
        self._queue.join()
        self._raise_pending()
        with self._lock:
            return self._last_path

    def close(self) -> Optional[pathlib.Path]:
        """Drain, stop the writer thread, and return the last written path.
        The writer is reusable after close (a new thread starts lazily)."""
        try:
            path = self.wait()
        finally:
            if self._thread is not None and self._thread.is_alive():
                self._queue.put(self._stop)
                self._thread.join()
            self._thread = None
        return path

    def __enter__(self) -> "CheckpointWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:                              # don't mask the caller's exception
            try:
                self.close()
            except Exception:
                pass


# --------------------------------------------------------------------------
# restore
# --------------------------------------------------------------------------

class _ShardReader:
    """payload[key] accessor over a v2 step index: decompresses each unique
    blob once even when many leaves share it."""

    def __init__(self, directory: pathlib.Path, meta: dict):
        self._blob_dir = directory / "blobs"
        self._shards = meta["shards"]
        self._cache: dict[str, bytes] = {}

    def __getitem__(self, key: str) -> dict:
        rec = self._shards[key]
        h = rec["blob"]
        if h not in self._cache:
            path = self._blob_dir / f"{h}.gvck"
            if not path.exists():
                raise FileNotFoundError(
                    f"checkpoint shard {h} (leaf {key!r}) is missing from "
                    f"{self._blob_dir} — blob store GC'd or partially copied?")
            raw = decode_shard(path.read_bytes())
            if len(raw) != rec["nbytes"] or content_hash(raw) != h:
                raise CorruptCheckpointError(
                    f"checkpoint shard {h} (leaf {key!r}) fails its content "
                    "hash — corrupt or truncated blob store")
            self._cache[h] = raw
        return {"dtype": rec["dtype"], "shape": rec["shape"], "data": self._cache[h]}


def restore(
    directory: str | pathlib.Path,
    step: Optional[int] = None,
    *,
    params_like: Any = None,           # tree template (its structure only)
    opt_like: Any = None,
) -> dict:
    """Returns {"step", "plan"} and, for each template given, "params" /
    "opt": ``params_like``'s / ``opt_like``'s structure with every leaf a
    CPU tensor of the saved bytes, in the saved shape (0-d where the
    template's leaf is 0-d); the trainers' ``place_params`` and
    ``place_opt_state`` lay them out.  Reads every on-disk format: v2
    sharded, v1 single-file, and legacy pre-header.  A key the checkpoint
    lacks raises ``KeyError``."""
    directory = pathlib.Path(directory)
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    meta = json.loads(_index_path(directory, step).read_text())
    result: dict = {"step": step, "plan": None}
    if meta.get("plan"):
        result["plan"] = ExecutionPlan.from_json(json.dumps(meta["plan"]))
    if params_like is None and opt_like is None:
        return result
    if meta.get("format") == FORMAT_V2:
        payload: Any = _ShardReader(directory, meta)
    else:
        payload = decode_blob((directory / f"step{step:09d}.ckpt").read_bytes())
    for name, like in (("params", params_like), ("opt", opt_like)):
        if like is not None:
            flat = _flatten(like)
            with ThreadPoolExecutor(_IO_THREADS) as pool:
                leaves = dict(zip(flat, pool.map(
                    lambda key, name=name: _leaf_from(payload[f"{name}/{key}"], flat[key]),
                    flat)))
            result[name] = _rebuild(like, leaves.__getitem__)
    return result
