"""Hardware profiler — collective cost models (alpha-beta) + measured fits.

Analytic path: ring-collective formulas parameterized by the
:class:`~repro_torch.core.cluster.ClusterSpec` (the paper's profiled bandwidth
tables, here derived from hardware constants).  Measured path: on one
device the exact degenerate fit (no wire); the timed all-reduce fit over
several cards waits for the port's ``torch.distributed`` runtime.
"""
from __future__ import annotations

import dataclasses

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


def measure_allreduce(dtype: str = "fp32", n_devices: int = 1) -> FittedComm:
    """Fit alpha-beta for a ``dtype`` all-reduce across ``n_devices`` cards.

    On a single device there is no wire: return the exact degenerate fit
    ``FittedComm(0, 0, r2=1.0)``, as the JAX package does.  More than one
    device needs the ``torch.distributed`` runtime (ROADMAP Queue 1 item 4).
    """
    if n_devices <= 1:
        return FittedComm(alpha=0.0, beta=0.0, r2=1.0)
    raise NotImplementedError(
        f"measure_allreduce over {n_devices} devices needs the torch.distributed "
        "parallel runtime (ROADMAP Queue 1 item 4); the port measures one device")
