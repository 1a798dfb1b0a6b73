"""Cost-model calibration — least-squares fits from the measured profile cache.

The analytic cost stack (:mod:`repro_torch.core.cost_model`,
:mod:`repro_torch.core.memory_model`) is parameterized by hand-set coefficients:
attainable compute throughput, the backward/forward FLOP ratio, the remat
recompute overhead, the link alpha-beta constants, the activation-memory
overhead.  This module fits those coefficients from measured
:class:`~repro_torch.core.profile_cache.ProfileEntry` cells and emits a frozen
:class:`Calibration` carrying per-coefficient R² and a provenance record.

The **analytic defaults live here** (``ANALYTIC_*``) and remain the
zero-measurement fallback and the obviously-correct twin:
``DEFAULT_CALIBRATION`` reproduces the historical analytic numbers exactly
(identity effective cluster, ``peak_flops × flops_efficiency`` throughput),
so every consumer reads through :class:`Calibration` without behavior drift
until a measured fit is supplied.

Fit forms (all least squares through the origin — each coefficient is a
ratio of measured time to an analytic basis):

* ``throughput[dtype]``:  fwd_time ≈ flops_fwd / thr      (per-dtype slope)
* ``throughput[model|dtype]``: the same slope fitted per profiled model —
  the paper's own discipline (profile *the* model you are about to train);
  :func:`predict_entry_time` prefers the model-scoped fit, the search's
  dtype-level ``CostEnv`` path uses the per-dtype aggregate
* ``bwd_flops_factor``:   bwd_time ≈ k · fwd_time   (also fitted per model
  into ``bwd_by_model`` — scan-based ssm blocks have a very different
  bwd/fwd ratio than dense attention)
* ``remat_overhead``:     remat_extra ≈ r · fwd_time
* ``mem_scale``:          peak_bytes ≈ m · act_bytes_pred  (median ratio)
* ``link_bw / link_latency``: wire-normalized from the measured all-reduce
  alpha-beta fit — a ring all-reduce of B bytes over n devices costs
  ``2(n-1)/n · B/bw + 2(n-1)·lat``, so ``bw = 2(n-1)/n / beta`` and
  ``lat = alpha / (2(n-1))``.  The calibrated collectives then reuse the
  *analytic ring formulas* against a link-substituted cluster
  (:meth:`Calibration.effective_cluster`) — the analytic path stays the
  structural twin; only the constants change.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np

from repro_torch.core import profile_cache as pcache
from repro_torch.core.cluster import ClusterSpec

# Analytic defaults — the zero-measurement twin.  cost_model re-exports
# BWD_FLOPS_FACTOR/DP_OVERLAP as aliases of these for back-compat.
ANALYTIC_BWD_FLOPS_FACTOR = 2.0    # backward ≈ 2× forward
ANALYTIC_DP_OVERLAP = 0.7          # fraction of DP grad comm hidden under bwd
ANALYTIC_REMAT_OVERHEAD = 1.0      # full recompute ≈ 1× forward
ANALYTIC_MEM_SCALE = 1.0

#: clamp ranges keeping a noisy fit from emitting a nonsensical model
_BWD_RANGE = (0.2, 8.0)
_REMAT_RANGE = (0.05, 4.0)
_MEM_RANGE = (0.25, 8.0)


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Fitted (or analytic-default) cost-model coefficients.

    ``source`` is ``"analytic"`` for the defaults and ``"measured"`` when at
    least one coefficient was fitted; ``r2`` maps coefficient name to fit R²;
    ``provenance`` records where the fit came from (cache path, cache schema,
    entry counts) — the plan verifier flags a provenance whose
    ``cache_schema`` is not current (GALV060).
    """
    source: str = "analytic"
    throughput: Mapping[str, float] = dataclasses.field(default_factory=dict)
    bwd_flops_factor: float = ANALYTIC_BWD_FLOPS_FACTOR
    bwd_by_model: Mapping[str, float] = dataclasses.field(default_factory=dict)
    dp_overlap: float = ANALYTIC_DP_OVERLAP          # not fitted (needs multi-device traces)
    remat_overhead: float = ANALYTIC_REMAT_OVERHEAD
    mem_scale: float = ANALYTIC_MEM_SCALE
    link_bw: Optional[float] = None                  # bytes/s; None = analytic
    link_latency: Optional[float] = None             # s; None = analytic
    r2: Mapping[str, float] = dataclasses.field(default_factory=dict)
    provenance: Mapping[str, object] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------ accessors
    def eff_flops(self, cluster: ClusterSpec, dtype: str,
                  model: Optional[str] = None) -> float:
        """Attainable FLOP/s: the model-scoped fitted throughput when
        ``model`` (a :func:`~repro_torch.core.profile_cache.model_key`) was
        profiled, else the per-dtype aggregate, else the analytic
        ``peak × efficiency``."""
        thr = 0.0
        if model is not None:
            thr = self.throughput.get(f"{model}|{dtype}", 0.0)
        if thr <= 0.0:
            thr = self.throughput.get(dtype, 0.0)
        if thr > 0.0:
            return thr
        return cluster.peak_flops * cluster.flops_efficiency

    def bwd_factor(self, model: Optional[str] = None) -> float:
        """bwd/fwd time ratio — the model-scoped fit when available."""
        if model is not None and model in self.bwd_by_model:
            return self.bwd_by_model[model]
        return self.bwd_flops_factor

    def effective_cluster(self, cluster: ClusterSpec) -> ClusterSpec:
        """Cluster with measured link constants substituted for the analytic
        intra-domain ones.  Identity (same object) when nothing was fitted —
        the analytic twin costs nothing."""
        if self.link_bw is None and self.link_latency is None:
            return cluster
        kw: dict = {}
        if self.link_bw is not None:
            kw["intra_bw"] = self.link_bw
        if self.link_latency is not None:
            kw["intra_latency"] = self.link_latency
        return dataclasses.replace(cluster, **kw)

    # ------------------------------------------------------------ reporting
    def format_table(self) -> str:
        """Human-readable fit table for the ``profile`` subcommand."""
        rows = [("COEFFICIENT", "VALUE", "ANALYTIC", "R2")]

        def fmt(v):
            return f"{v:.4g}" if isinstance(v, float) else str(v)

        for dt in sorted(self.throughput):
            rows.append((f"throughput[{dt}] (FLOP/s)",
                         fmt(self.throughput[dt]), "peak*eff",
                         fmt(self.r2.get(f"throughput[{dt}]", float("nan")))))
        rows.append(("bwd_flops_factor", fmt(self.bwd_flops_factor),
                     fmt(ANALYTIC_BWD_FLOPS_FACTOR),
                     fmt(self.r2.get("bwd_flops_factor", float("nan")))))
        rows.append(("remat_overhead", fmt(self.remat_overhead),
                     fmt(ANALYTIC_REMAT_OVERHEAD),
                     fmt(self.r2.get("remat_overhead", float("nan")))))
        rows.append(("mem_scale", fmt(self.mem_scale),
                     fmt(ANALYTIC_MEM_SCALE),
                     fmt(self.r2.get("mem_scale", float("nan")))))
        if self.link_bw is not None:
            rows.append(("link_bw (B/s)", fmt(self.link_bw), "cluster",
                         fmt(self.r2.get("link", float("nan")))))
        if self.link_latency is not None:
            rows.append(("link_latency (s)", fmt(self.link_latency), "cluster",
                         fmt(self.r2.get("link", float("nan")))))
        widths = [max(len(r[i]) for r in rows) for i in range(4)]
        lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
                 for r in rows]
        prov = ", ".join(f"{k}={v}" for k, v in sorted(
            self.provenance.items(), key=lambda kv: kv[0]))
        lines.append(f"calibration: source={self.source}"
                     + (f" ({prov})" if prov else ""))
        return "\n".join(lines)


DEFAULT_CALIBRATION = Calibration()


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------

def _origin_fit(x, y) -> tuple[float, float]:
    """(slope, r2) of y ≈ slope·x through the origin."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    denom = float(np.sum(x * x))
    if denom <= 0.0:
        return 0.0, 0.0
    slope = float(np.sum(x * y)) / denom
    ss_res = float(np.sum((y - slope * x) ** 2))
    ss_tot = float(np.sum((y - np.mean(y)) ** 2))
    if ss_tot <= 0.0:                       # single point / constant y
        return slope, 1.0 if ss_res <= 1e-18 else 0.0
    return slope, 1.0 - ss_res / ss_tot


def _clip(v: float, lo_hi: tuple[float, float]) -> float:
    return min(max(v, lo_hi[0]), lo_hi[1])


def calibrate(cache: pcache.ProfileCache) -> Calibration:
    """Fit a :class:`Calibration` from every entry in ``cache``.  With no
    usable entries the analytic defaults come back unchanged (``source``
    stays ``"analytic"``); the provenance always records the cache's path and
    loaded schema, so a stale-schema cache yields a calibration the plan
    verifier rejects (GALV060)."""
    entries = [e for e in cache.entries.values()
               if e.fwd_time_s > 0.0 and e.flops_fwd > 0.0]
    throughput: dict = {}
    r2: dict = {}

    for dtype in sorted({e.key.dtype for e in entries}):
        grp = [e for e in entries if e.key.dtype == dtype]
        slope, fit_r2 = _origin_fit([e.flops_fwd for e in grp],
                                    [e.fwd_time_s for e in grp])
        if slope > 0.0:
            throughput[dtype] = 1.0 / slope
            r2[f"throughput[{dtype}]"] = fit_r2

    # model-scoped throughput — the paper's per-model profiling discipline
    for mk, dtype in sorted({(e.key.model, e.key.dtype) for e in entries}):
        grp = [e for e in entries
               if e.key.model == mk and e.key.dtype == dtype]
        slope, fit_r2 = _origin_fit([e.flops_fwd for e in grp],
                                    [e.fwd_time_s for e in grp])
        if slope > 0.0:
            throughput[f"{mk}|{dtype}"] = 1.0 / slope
            r2[f"throughput[{mk}|{dtype}]"] = fit_r2

    bwd = ANALYTIC_BWD_FLOPS_FACTOR
    bwd_by_model: dict = {}
    pairs = [e for e in entries if e.bwd_time_s > 0.0]
    if pairs:
        k, fit_r2 = _origin_fit([e.fwd_time_s for e in pairs],
                                [e.bwd_time_s for e in pairs])
        if k > 0.0:
            bwd = _clip(k, _BWD_RANGE)
            r2["bwd_flops_factor"] = fit_r2
    for mk in sorted({e.key.model for e in pairs}):
        grp = [e for e in pairs if e.key.model == mk]
        k, fit_r2 = _origin_fit([e.fwd_time_s for e in grp],
                                [e.bwd_time_s for e in grp])
        if k > 0.0:
            bwd_by_model[mk] = _clip(k, _BWD_RANGE)
            r2[f"bwd[{mk}]"] = fit_r2

    remat = ANALYTIC_REMAT_OVERHEAD
    rents = [e for e in entries if e.remat_extra_s > 0.0]
    if rents:
        r, fit_r2 = _origin_fit([e.fwd_time_s for e in rents],
                                [e.remat_extra_s for e in rents])
        if r > 0.0:
            remat = _clip(r, _REMAT_RANGE)
            r2["remat_overhead"] = fit_r2

    mem = ANALYTIC_MEM_SCALE
    ments = [e for e in entries if e.peak_bytes > 0.0 and e.act_bytes_pred > 0.0]
    if ments:
        ratios = np.asarray([e.peak_bytes / e.act_bytes_pred for e in ments])
        mem = _clip(float(np.median(ratios)), _MEM_RANGE)
        spread = float(np.std(np.log(ratios))) if len(ratios) > 1 else 0.0
        r2["mem_scale"] = max(0.0, 1.0 - spread)

    link_bw = link_lat = None
    comms = [c for c in cache.comm.values()
             if c.n_devices > 1 and c.beta > 0.0]
    if comms:
        bws = [2.0 * (c.n_devices - 1) / c.n_devices / c.beta for c in comms]
        lats = [max(c.alpha, 0.0) / (2.0 * (c.n_devices - 1)) for c in comms]
        link_bw = float(np.median(bws))
        link_lat = float(np.median(lats))
        r2["link"] = float(np.median([c.r2 for c in comms]))

    fitted = bool(throughput or comms or rents or pairs or ments)
    return Calibration(
        source="measured" if fitted else "analytic",
        throughput=throughput,
        bwd_flops_factor=bwd,
        bwd_by_model=bwd_by_model,
        remat_overhead=remat,
        mem_scale=mem,
        link_bw=link_bw,
        link_latency=link_lat,
        r2=r2,
        provenance={
            "path": str(cache.path),
            "cache_schema": cache.loaded_schema,
            "n_entries": len(entries),
            "n_comm": len(comms),
            "backends": ",".join(sorted({e.key.backend for e in entries})),
        },
    )


def load_calibration(path, *, allow_stale: bool = False) -> Calibration:
    """Load a profile cache and fit a calibration from it.  Raises
    FileNotFoundError / :class:`~repro_torch.core.profile_cache.CorruptProfileCacheError`
    on unusable files and
    :class:`~repro_torch.core.profile_cache.StaleProfileCacheError` on a schema
    mismatch unless ``allow_stale`` (stale fits are rejected downstream by
    the plan verifier anyway — GALV060)."""
    cache = pcache.ProfileCache.load(path)
    if cache.stale and not allow_stale:
        raise pcache.StaleProfileCacheError(path, cache.loaded_schema)
    return calibrate(cache)


def predict_entry_time(entry: pcache.ProfileEntry, cal: Calibration,
                       cluster: ClusterSpec) -> float:
    """Predicted fwd+bwd wall time for one measured cell under ``cal`` —
    the quantity the calibration gate compares against ``fwd+bwd`` measured."""
    fwd = entry.flops_fwd / cal.eff_flops(cluster, entry.key.dtype,
                                          model=entry.key.model)
    return fwd * (1.0 + cal.bwd_factor(entry.key.model))


# ---------------------------------------------------------------------------
# measurement loop (shared by the launchers' `profile` subcommand and the
# costmodel_accuracy calibration gate)
# ---------------------------------------------------------------------------

def run_profile_cells(cells, cache: pcache.ProfileCache, *, iters: int = 3,
                      with_remat: bool = True, measure_fn=None,
                      verbose: bool = False) -> tuple[int, int]:
    """Measure every ``(cfg, ProfileKey)`` cell not already in ``cache``.

    Returns ``(n_measured, n_cached)``.  A stale cache (older schema) is
    reset first — stale entries are invalidated, never silently reused.
    ``measure_fn(cfg, seq, batch=, iters=, dtype=, with_remat=)`` is
    injectable for tests; the default is the real block measurement
    (:func:`repro_torch.core.profiler_model.measure_block`, on the card).
    """
    if cache.stale:
        if verbose:
            print(f"profile cache schema {cache.loaded_schema} != "
                  f"{pcache.SCHEMA_VERSION}: invalidating stale entries")
        cache.reset()
    if measure_fn is None:
        from repro_torch.core.profiler_model import measure_block
        measure_fn = measure_block
    measured = cached = 0
    for cfg, key in cells:
        if cache.get(key) is not None:
            cached += 1
            continue
        m = measure_fn(cfg, key.seq, batch=key.microbatch, iters=iters,
                       dtype=key.dtype, with_remat=with_remat)
        entry = pcache.ProfileEntry(
            key=key, fwd_time_s=m.fwd_time_s, bwd_time_s=m.bwd_time_s,
            remat_extra_s=m.remat_extra_s, peak_bytes=m.peak_bytes,
            flops_fwd=m.flops_fwd, act_bytes_pred=m.act_bytes_pred,
            iters=m.iters)
        cache.put(entry)
        measured += 1
        if verbose:
            print(f"  measured {key.id()}: fwd {m.fwd_time_s*1e3:.2f} ms, "
                  f"bwd {m.bwd_time_s*1e3:.2f} ms")
    return measured, cached
