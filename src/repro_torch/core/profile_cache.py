"""Versioned on-disk profile cache — measured per-block timings + comm fits.

The paper's profiler measures per-layer fwd/bwd latency and peak memory on
the target hardware and caches the results on disk keyed by the measurement
cell (the Oobleck / ReaLHF pattern): re-profiling is expensive, so a second
run over the same cells must do **zero** re-measurement.  This module is the
storage layer only — measurement lives in
:func:`repro_torch.core.profiler_model.measure_block` and the fitting in
:mod:`repro_torch.core.calibrate`.

Layout: one JSON file (default ``results/profiles/<backend>.json``) holding

* ``schema`` — :data:`SCHEMA_VERSION`.  A cache written under a different
  schema loads as *stale*: its entries are dropped (the field layout may have
  changed), ``stale`` is True, and the profile subcommand re-measures from
  scratch.  A calibration fitted from a stale cache carries the old schema in
  its provenance, which the plan verifier flags (GALV060).
* ``entries`` — measured block cells keyed by
  (backend, model, dtype, tp, cp, seq, microbatch).
* ``comm`` — fitted (alpha, beta) collective models from
  :func:`repro_torch.core.profiler_hw.measure_allreduce`, keyed by
  (backend, dtype, n_devices).

Corrupt files (truncated JSON, wrong top-level type, malformed entries) raise
:class:`CorruptProfileCacheError` with the path and reason — the same
fail-loudly discipline as checkpoint loading (``CorruptCheckpointError``).
Writes are atomic (tmp file + ``os.replace``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from typing import Optional

#: bump when ProfileEntry/CommEntry fields change meaning or layout —
#: caches written under any other value load as stale (entries dropped)
SCHEMA_VERSION = 1


class CorruptProfileCacheError(RuntimeError):
    """The profile cache file exists but cannot be parsed — re-run the
    ``profile`` subcommand (or delete the file) rather than trusting it."""

    def __init__(self, path, reason: str):
        super().__init__(f"corrupt profile cache {path}: {reason} — delete it "
                         "or re-run the `profile` subcommand")
        self.path = str(path)
        self.reason = reason


class StaleProfileCacheError(RuntimeError):
    """The cache parses but was written under an older schema — its entries
    cannot be trusted to mean the same thing."""

    def __init__(self, path, found: int):
        super().__init__(
            f"profile cache {path} has schema {found}; current schema is "
            f"{SCHEMA_VERSION} — re-run the `profile` subcommand to re-measure")
        self.path = str(path)
        self.found = found


@dataclasses.dataclass(frozen=True)
class ProfileKey:
    """One measurement cell.  ``model`` comes from :func:`model_key` so a
    ``cfg.reduced()`` config (same ``name``, smaller dims) never aliases the
    full-size model's measurements."""
    backend: str                 # torch device type: cuda | cpu (the JAX package
                                 # writes jax.default_backend(): cpu | tpu | gpu)
    model: str                   # model_key(cfg)
    dtype: str                   # fp32 | bf16
    tp: int
    cp: int
    seq: int
    microbatch: int

    def id(self) -> str:
        return (f"{self.backend}/{self.model}/{self.dtype}"
                f"/tp{self.tp}/cp{self.cp}/s{self.seq}/mb{self.microbatch}")


@dataclasses.dataclass(frozen=True)
class ProfileEntry:
    """Measured quantities for one cell (zero = not measured/unavailable),
    plus the analytic bases the calibration fits against."""
    key: ProfileKey
    fwd_time_s: float            # median block forward wall time
    bwd_time_s: float            # grad total minus forward
    remat_extra_s: float         # full-remat grad minus plain grad
    peak_bytes: float            # forward working set + arguments
    flops_fwd: float             # analytic fwd FLOPs for this cell
    act_bytes_pred: float        # analytic activation bytes for this cell
    iters: int = 0


@dataclasses.dataclass(frozen=True)
class CommEntry:
    """One fitted alpha-beta collective model (measure_allreduce)."""
    backend: str
    dtype: str
    n_devices: int
    alpha: float                 # latency per collective (s)
    beta: float                  # seconds per byte
    r2: float

    def id(self) -> str:
        return f"{self.backend}/{self.dtype}/n{self.n_devices}"


def model_key(cfg) -> str:
    """Cache key for a model config.  ``cfg.reduced()`` keeps ``cfg.name``
    but shrinks the dims, so the structural dims are part of the key."""
    return (f"{cfg.name}:L{cfg.num_layers}"
            f"d{cfg.d_model}h{cfg.num_heads}f{cfg.d_ff}")


def default_path(backend: str,
                 root: Optional[pathlib.Path] = None) -> pathlib.Path:
    root = root or pathlib.Path(__file__).resolve().parents[3]
    return root / "results" / "profiles" / f"{backend}.json"


def _entry_from_json(d: dict) -> ProfileEntry:
    key = ProfileKey(**d["key"])
    return ProfileEntry(key=key, **{f.name: d[f.name]
                                    for f in dataclasses.fields(ProfileEntry)
                                    if f.name != "key"})


@dataclasses.dataclass
class ProfileCache:
    path: pathlib.Path
    loaded_schema: int = SCHEMA_VERSION
    entries: dict = dataclasses.field(default_factory=dict)   # key.id -> entry
    comm: dict = dataclasses.field(default_factory=dict)      # comm.id -> entry

    # ------------------------------------------------------------- loading
    @classmethod
    def load(cls, path) -> "ProfileCache":
        """Parse an existing cache file.  Raises FileNotFoundError if absent,
        :class:`CorruptProfileCacheError` if unparseable.  A schema mismatch
        is NOT an error: the cache loads empty with ``stale`` set (the
        measurement path resets it, the calibration path records it)."""
        path = pathlib.Path(path)
        text = path.read_text(encoding="utf-8")
        try:
            raw = json.loads(text)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise CorruptProfileCacheError(path, f"invalid JSON ({e})") from e
        if not isinstance(raw, dict):
            raise CorruptProfileCacheError(
                path, f"top-level value is {type(raw).__name__}, expected object")
        schema = raw.get("schema")
        if not isinstance(schema, int):
            raise CorruptProfileCacheError(
                path, f"missing/invalid 'schema' field: {schema!r}")
        cache = cls(path=path, loaded_schema=schema)
        if schema != SCHEMA_VERSION:
            return cache                 # stale: drop entries, keep the mark
        try:
            for d in raw.get("entries", []):
                e = _entry_from_json(d)
                cache.entries[e.key.id()] = e
            for d in raw.get("comm", []):
                c = CommEntry(**d)
                cache.comm[c.id()] = c
        except (KeyError, TypeError, AttributeError) as e:
            raise CorruptProfileCacheError(
                path, f"malformed entry ({type(e).__name__}: {e})") from e
        return cache

    @classmethod
    def load_or_create(cls, path) -> "ProfileCache":
        path = pathlib.Path(path)
        if path.exists():
            return cls.load(path)
        return cls(path=path)

    # ------------------------------------------------------------- queries
    @property
    def stale(self) -> bool:
        return self.loaded_schema != SCHEMA_VERSION

    def get(self, key: ProfileKey) -> Optional[ProfileEntry]:
        return self.entries.get(key.id())

    def put(self, entry: ProfileEntry) -> None:
        self.entries[entry.key.id()] = entry

    def get_comm(self, backend: str, dtype: str,
                 n_devices: int) -> Optional[CommEntry]:
        return self.comm.get(f"{backend}/{dtype}/n{n_devices}")

    def put_comm(self, entry: CommEntry) -> None:
        self.comm[entry.id()] = entry

    def reset(self) -> None:
        """Drop everything and adopt the current schema (the measurement
        path's response to a stale load)."""
        self.entries.clear()
        self.comm.clear()
        self.loaded_schema = SCHEMA_VERSION

    # ------------------------------------------------------------- saving
    def save(self) -> pathlib.Path:
        """Atomic write (tmp + rename) under the CURRENT schema."""
        self.loaded_schema = SCHEMA_VERSION
        doc = {
            "schema": SCHEMA_VERSION,
            "entries": [dataclasses.asdict(e) for e in self.entries.values()],
            "comm": [dataclasses.asdict(c) for c in self.comm.values()],
        }
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(self.path.suffix + ".tmp")
        tmp.write_text(json.dumps(doc, indent=1, sort_keys=True),
                       encoding="utf-8")
        os.replace(tmp, self.path)
        return self.path
