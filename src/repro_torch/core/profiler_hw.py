"""Hardware profiler — collective cost models (alpha-beta) + measured fits.

Analytic path: ring-collective formulas parameterized by the
:class:`~repro_torch.core.cluster.ClusterSpec` (the paper's profiled bandwidth
tables, here derived from hardware constants).  Measured path: an
alpha-beta fit of timed all-reduces over the default process group's world;
on one device the exact degenerate fit (no wire).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.cluster import ClusterSpec


# ---- ring-collective time models (bytes = full tensor size) ---------------

def allreduce_time(nbytes: float, n: int, cluster: ClusterSpec) -> float:
    if n <= 1 or nbytes == 0:
        return 0.0
    bw, lat = cluster.link_bw(n), cluster.latency(n)
    return 2.0 * (n - 1) / n * nbytes / bw + 2.0 * (n - 1) * lat


def allgather_time(nbytes: float, n: int, cluster: ClusterSpec) -> float:
    """nbytes = full gathered size."""
    if n <= 1 or nbytes == 0:
        return 0.0
    bw, lat = cluster.link_bw(n), cluster.latency(n)
    return (n - 1) / n * nbytes / bw + (n - 1) * lat


def reducescatter_time(nbytes: float, n: int, cluster: ClusterSpec) -> float:
    return allgather_time(nbytes, n, cluster)


def alltoall_time(nbytes: float, n: int, cluster: ClusterSpec) -> float:
    if n <= 1 or nbytes == 0:
        return 0.0
    bw, lat = cluster.link_bw(n), cluster.latency(n)
    return (n - 1) / n * nbytes / bw + (n - 1) * lat


def p2p_time(nbytes: float, cluster: ClusterSpec, inter: bool = True) -> float:
    bw = cluster.inter_bw if inter else cluster.intra_bw
    lat = cluster.inter_latency if inter else cluster.intra_latency
    return nbytes / bw + lat


def ring_hop_time(nbytes: float, cluster: ClusterSpec, intra: bool = True) -> float:
    """One neighbor hop of a ring rotation (context-parallel k/v blocks).
    cp lives inside the fast domain (like TP), so hops ride intra links by
    default."""
    if nbytes == 0:
        return 0.0
    return p2p_time(nbytes, cluster, inter=not intra)


def exposed_time(comm: float, compute: float, *, floor_frac: float = 0.05) -> float:
    """Communication time left exposed after overlapping with ``compute``
    (per-hop k/v rotation overlaps the previous block's attention math); a
    ``floor_frac`` share is always exposed — launch/sync overhead never fully
    hides."""
    if comm <= 0.0:
        return 0.0
    return max(comm - compute, floor_frac * comm)


# ---- measured path ---------------------------------------------------------

@dataclasses.dataclass
class FittedComm:
    alpha: float                  # latency per collective (s)
    beta: float                   # seconds per byte
    r2: float

    def time(self, nbytes: float) -> float:
        return self.alpha + self.beta * nbytes


def _elems_for(nbytes: int, itemsize: int, n: int) -> int:
    """Element count for an ``nbytes`` collective buffer: at least one element
    per device, rounded down to a multiple of ``n`` so it shards evenly."""
    elems = max(int(nbytes) // itemsize, n)
    return (elems // n) * n


def measure_allreduce(sizes_bytes=None, iters: int = 8, dtype: str = "fp32", *,
                      n_devices=None) -> FittedComm:
    """Fit alpha-beta for an all-reduce over the default process group's
    world (JAX's signature; ``n_devices``, when given, must be that world).

    A world of one (or no process group) has no wire: the exact degenerate
    fit ``FittedComm(0, 0, r2=1.0)``, as the JAX package returns.  Otherwise
    each size is all-reduced ``iters`` times after one warm-up, each timed
    on the host clock around a synchronize when the buffer is on CUDA
    (the current card when there is one, else the CPU), and the median per
    size is fitted by least squares.

    Ranks that share one card over gloo measure the host's copies, not an
    interconnect: do not feed such a fit to a calibration."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices > 1 and n_devices != world:
        raise ValueError(f"measure_allreduce over {n_devices} devices needs a process group "
                         f"of that world; this one has {world}")
    if world <= 1 or (n_devices is not None and n_devices <= 1):
        return FittedComm(alpha=0.0, beta=0.0, r2=1.0)
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    itemsize = torch.empty((), dtype=tdt).element_size()
    device = (torch.device("cuda", torch.cuda.current_device())
              if torch.cuda.is_available() else torch.device("cpu"))
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    sizes_bytes = sizes_bytes or [1 << k for k in range(12, 22, 2)]
    xs, ys = [], []
    for sz in sizes_bytes:
        a = torch.ones((_elems_for(sz, itemsize, world),), dtype=tdt, device=device)
        dist.all_reduce(a)
        ts = []
        for _ in range(iters):
            sync()
            t0 = time.perf_counter()
            dist.all_reduce(a)
            sync()
            ts.append(time.perf_counter() - t0)
        xs.append(float(a.numel() * itemsize))
        ys.append(float(np.median(ts)))
    A = np.stack([np.ones_like(xs), np.asarray(xs)], axis=1)
    coef, *_ = np.linalg.lstsq(A, np.asarray(ys), rcond=None)
    pred = A @ coef
    ss_res = float(np.sum((ys - pred) ** 2))
    ss_tot = float(np.sum((ys - np.mean(ys)) ** 2)) or 1.0
    return FittedComm(alpha=max(float(coef[0]), 0.0),
                      beta=max(float(coef[1]), 1e-15),
                      r2=1.0 - ss_res / ss_tot)
