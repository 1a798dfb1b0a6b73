"""Cluster hardware description consumed by the profiler/cost model (the
port's copy of ``repro.core.cluster``).

The GPU presets of the Fig.-3 clusters, plus ``H100_1``: one H100 SXM card,
the default cluster of the port's search engine and of a single-card serving
deployment.  The port carries no TPU preset; a test that compares the two
packages on a TPU spec builds a ``ClusterSpec`` from its fields.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    name: str
    chips: int
    peak_flops: float              # per chip, bf16/fp16 FLOP/s
    hbm_bytes: float               # per chip
    hbm_bw: float                  # per chip, bytes/s
    intra_bw: float                # fast-domain link bw per chip (ICI / NVLink)
    inter_bw: float                # slow-domain bw per chip (DCN / IB / eth)
    intra_size: int                # chips per fast domain (pod / node)
    intra_latency: float = 1e-6    # alpha terms (s)
    inter_latency: float = 10e-6
    flops_efficiency: float = 0.6  # attainable fraction of peak on matmuls
    mem_overhead: float = 1.15     # allocator fragmentation / workspace factor

    def link_bw(self, group_size: int) -> float:
        """Effective per-chip collective bandwidth for a group of this size."""
        return self.intra_bw if group_size <= self.intra_size else self.inter_bw

    def latency(self, group_size: int) -> float:
        return self.intra_latency if group_size <= self.intra_size else self.inter_latency


# --- GPU presets for the paper-reproduction benchmark (Fig. 3 clusters) ----
A100_NODE8 = ClusterSpec(
    name="a100-16", chips=16, peak_flops=312e12, hbm_bytes=80e9, hbm_bw=2039e9,
    intra_bw=300e9, inter_bw=25e9, intra_size=8)
H100_NODE8 = ClusterSpec(
    name="h100-16", chips=16, peak_flops=989e12, hbm_bytes=80e9, hbm_bw=3350e9,
    intra_bw=450e9, inter_bw=50e9, intra_size=8)
RTX4090_NODE8 = ClusterSpec(
    name="4090-16", chips=16, peak_flops=165e12, hbm_bytes=24e9, hbm_bw=1008e9,
    intra_bw=32e9, inter_bw=1.25e9, intra_size=8)

# one H100 SXM card: the port's default cluster.  Its fast domain is the card
# itself (intra_size 1): the serve search caps tp by intra_size, not chips.
H100_1 = dataclasses.replace(H100_NODE8, name="h100-1", chips=1, intra_size=1)

CLUSTERS = {c.name: c for c in (A100_NODE8, H100_NODE8, RTX4090_NODE8, H100_1)}
