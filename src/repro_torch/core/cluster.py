"""Cluster hardware description (the port's copy of ``repro.core.cluster``).

Only the pieces the serving slice reads: ``ClusterSpec``, the 16-chip H100
preset the planner uses, and the 1-chip spec that sizes a single-card
serving deployment (GALV081 checks the pool plus weights against its HBM).
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


H100_NODE8 = ClusterSpec(
    name="h100-16", chips=16, peak_flops=989e12, hbm_bytes=80e9, hbm_bw=3350e9,
    intra_bw=450e9, inter_bw=50e9, intra_size=8)

# one H100 SXM card: the default cluster of a serving deployment in the port
H100_1 = dataclasses.replace(H100_NODE8, name="h100-1", chips=1)
