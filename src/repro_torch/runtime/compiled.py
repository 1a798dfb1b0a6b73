"""Step functions of static shape as captured CUDA graphs: the port's
counterpart of ``compat.jit`` on a serving step.

``compile_step(fn, device, ...)`` returns a :class:`CompiledStep`.  Each call
keys a graph on the shapes and dtypes of its tensor arguments (and on the
addresses of the arguments it holds); a new key warms ``fn`` up and captures
it, a known key replays.  The arguments fall in three kinds:

- **held** (``held``: argument positions; the weights): read where they lie.
  The graph reads their addresses, so their data pointers are part of the key;
- **donated** (``donated``; a KV pool, a decode cache): written in place by
  ``fn``.  A key adopts the tensors of its first call as its buffers; a later
  call that passes those same tensors (the step's own output, as JAX hands
  back a donated buffer) copies nothing, another one is copied in.  The
  warm-up runs on clones of them, so it changes no state; the capture runs
  nothing, so the first real step is the one replay after it;
- **fed** (every other argument): each tensor is copied into a static buffer
  of the key before each replay, a host tensor through a pinned staging
  buffer with ``non_blocking=True``.  A Python scalar is refused (a capture
  would bake it in); callers turn one into a 0-d tensor first.

The outputs are the graph's static tensors, valid until the next replay of
the same key (``clone_outputs=True`` returns clones: JAX's fresh arrays).
Before its capture a key runs ``fn`` ``WARMUP`` times on the capture stream, so
the kernel library is built and loaded and cuBLAS is initialised outside the
capture.  The graphs of one scheduler or engine share one memory pool
(``pool``, from ``torch.cuda.graph_pool_handle()``).  A capture that fails
raises; nothing falls back to the eager call.

The kernels' launch counters (each ops module's ``COUNTERS``) count host
calls, which a graph makes only while it is captured.  So a capture's
counts are taken back and recorded, and each replay adds them: the
counters keep counting device launches, the warm-up's included.

On a CPU device the same plumbing runs, static buffers and all, with a
direct call of ``fn`` on them in place of the replay (no warm-up, no
capture): the CPU tests cover everything but the capture itself.

Python's cyclic collector stays off during a capture: a graph of an
earlier step left in a reference cycle, freed there, would destroy its
executable inside the capture, which CUDA refuses and which invalidates
the capture (a later cuBLAS call then fails).
"""
from __future__ import annotations

import gc
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd import ops as ssd_ops

#: every kernel launch counter: (the object holding it, its attribute)
COUNTERS = (*flash_ops.COUNTERS, *rms_ops.COUNTERS, *ssd_ops.COUNTERS,
            *rms_ops.SPLIT_COUNTERS)
WARMUP = 2                 # eager calls of a new key before its capture


def _read_counts() -> list[int]:
    return [getattr(obj, attr) for obj, attr in COUNTERS]


def _set_counts(counts: list[int]) -> None:
    for (obj, attr), n in zip(COUNTERS, counts):
        setattr(obj, attr, n)


def _flatten(tree, leaves: list):
    """Append ``tree``'s tensor leaves to ``leaves``; returns its structure
    (dicts, lists, tuples and None; a leaf is ``...``)."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ...
    if tree is None:
        return None
    if isinstance(tree, dict):
        return ("dict", tuple((k, _flatten(v, leaves)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_flatten(v, leaves) for v in tree))
    raise TypeError(f"compiled step: a {type(tree).__name__} argument would be baked into "
                    "the graph; pass tensors (a Python scalar as a 0-d tensor)")


def _unflatten(spec, leaves):
    """Rebuild a structure of ``_flatten`` from an iterator of leaves."""
    if spec is ...:
        return next(leaves)
    if spec is None:
        return None
    kind, items = spec
    if kind == "dict":
        return {k: _unflatten(v, leaves) for k, v in items}
    seq = [_unflatten(v, leaves) for v in items]
    return seq if kind == "list" else tuple(seq)


def _clone_tree(tree):
    leaves: list = []
    spec = _flatten(tree, leaves)
    return _unflatten(spec, iter([t.clone() for t in leaves]))


class _Entry:
    """One key: its static buffers, graph, outputs and recorded launches."""

    def __init__(self):
        self.args: list = []             # fn's arguments, fed ones as static buffers
        self.fed: list = []              # (static buffer, pinned staging or None)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Any = None
        self.launches: list[int] = []
        self.copied: Optional[torch.cuda.Event] = None
        self.capture_s = 0.0
        self.pool_bytes = 0


class CompiledStep:
    """``fn`` as CUDA graphs keyed on its arguments' shapes; see the module
    note.  ``entries`` maps each key to its graph; ``capture_s`` and
    ``pool_bytes`` sum the warm-ups and captures and the memory each capture
    added to the pool (``torch.cuda.memory_reserved``)."""

    def __init__(self, fn: Callable, device, *, held=(), donated=(), pool=None,
                 clone_outputs: bool = False, name: str = ""):
        self.fn = fn
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None and torch.cuda.is_available():
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.held = frozenset(held)
        self.donated = frozenset(donated)
        self.pool = pool
        self.clone_outputs = clone_outputs
        self.name = name or getattr(fn, "__name__", "step")
        self.entries: dict = {}

    @property
    def capture_s(self) -> float:
        return sum(e.capture_s for e in self.entries.values())

    @property
    def pool_bytes(self) -> int:
        return sum(e.pool_bytes for e in self.entries.values())

    # ------------------------------------------------------------ keys
    def _key(self, args) -> tuple[tuple, list]:
        """The call's key (per argument its structure and, per tensor, shape
        and dtype, and a held one's address and strides) and its leaves."""
        key, flat = [], []
        for i, arg in enumerate(args):
            leaves: list = []
            spec = _flatten(arg, leaves)
            held = i in self.held
            for t in leaves:
                if (held or i in self.donated) and t.device != self.device:
                    raise ValueError(f"{self.name}: argument {i} is read in place and must "
                                     f"lie on {self.device}, not {t.device}")
            key.append((spec, tuple(
                (tuple(t.shape), t.dtype) + ((t.data_ptr(), t.stride()) if held else ())
                for t in leaves)))
            flat.append(leaves)
        return tuple(key), flat

    # ------------------------------------------------------------ calls
    def __call__(self, *args):
        key, flat = self._key(args)
        entry = self.entries.get(key)
        if entry is None:
            entry = self._new_entry(args, flat)
            if self.device.type == "cuda":
                self._feed(entry, flat)         # the warm-up's inputs
                self._capture(entry)
            self.entries[key] = entry
        self._feed(entry, flat)
        if entry.graph is None:
            out = self.fn(*entry.args)
        else:
            entry.graph.replay()
            _set_counts([n + d for n, d in zip(_read_counts(), entry.launches)])
            out = entry.outputs
        return _clone_tree(out) if self.clone_outputs else out

    def _new_entry(self, args, flat) -> _Entry:
        """A key's static buffers: a fed tensor's new (with a pinned staging
        buffer where a host tensor feeds a CUDA key), a donated one's the
        tensor itself."""
        entry = _Entry()
        cuda = self.device.type == "cuda"
        for i, (arg, leaves) in enumerate(zip(args, flat)):
            if i in self.held:
                entry.args.append(arg)
                continue
            statics = []
            for t in leaves:
                if i in self.donated:
                    static, pinned = t, None
                else:
                    static = torch.empty(t.shape, dtype=t.dtype, device=self.device)
                    pinned = (torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                              if cuda and t.device.type == "cpu" else None)
                entry.fed.append((static, pinned))
                statics.append(static)
            entry.args.append(_unflatten(_flatten(arg, []), iter(statics)))
        return entry

    def _feed(self, entry: _Entry, flat) -> None:
        """Copy this call's fed and donated tensors into the key's buffers
        (nothing for a tensor that is its buffer)."""
        srcs = [t for i, leaves in enumerate(flat) if i not in self.held for t in leaves]
        if entry.copied is not None:
            entry.copied.synchronize()          # the last copies out of the staging buffers
        for (static, pinned), src in zip(entry.fed, srcs):
            if src.data_ptr() == static.data_ptr() and src.stride() == static.stride():
                continue
            if pinned is not None and src.device.type == "cpu":
                pinned.copy_(src)
                static.copy_(pinned, non_blocking=True)
            else:
                static.copy_(src)
        if any(p is not None for _, p in entry.fed):
            entry.copied = torch.cuda.Event()
            entry.copied.record(torch.cuda.current_stream(self.device))

    def _capture(self, entry: _Entry) -> None:
        """Warm up on the capture stream (donated arguments cloned), then
        capture one call into a graph of the shared pool; the capture's
        kernel launches are taken off the counters and kept for the replays.
        Unlike ``torch.cuda.graph`` this empties no allocator cache: the
        eager work around the graphs keeps its cached blocks (a capture
        allocates only in the graph pool, whose new segments the reserved
        bytes' growth counts)."""
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        stream = _capture_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            warm = [_clone_tree(a) if i in self.donated else a
                    for i, a in enumerate(entry.args)]
            for _ in range(WARMUP):
                self.fn(*warm)
            del warm
        torch.cuda.synchronize(self.device)
        reserved = torch.cuda.memory_reserved(self.device)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        before = _read_counts()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()                        # see the module note
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=self.pool)
                try:
                    entry.outputs = self.fn(*entry.args)
                finally:
                    graph.capture_end()
        except Exception as exc:
            raise RuntimeError(f"CUDA graph capture of {self.name} failed: {exc}") from exc
        finally:
            if collecting:
                gc.enable()
            after = _read_counts()
            _set_counts(before)
        current.wait_stream(stream)
        torch.cuda.synchronize(self.device)
        entry.graph = graph
        entry.launches = [a - b for a, b in zip(after, before)]
        entry.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        entry.capture_s = time.perf_counter() - t0


_CAPTURE_STREAMS: dict = {}


def _capture_stream(device: torch.device):
    """One side stream per device for every warm-up and capture, so the
    captures that share a pool share a stream too."""
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


def compile_step(fn: Callable, device, *, held=(), donated=(), pool=None,
                 clone_outputs: bool = False, name: str = "") -> CompiledStep:
    """``fn`` as a :class:`CompiledStep` on ``device``: ``held`` and
    ``donated`` are argument positions read in place (``donated`` ones are
    written too), every other argument is fed through a static buffer;
    ``pool`` a graph pool handle shared with other steps (a new one if
    None)."""
    return CompiledStep(fn, device, held=held, donated=donated, pool=pool,
                        clone_outputs=clone_outputs, name=name)
