"""Decision-tree candidate generation (paper §Search Engine).

Galvatron models the per-layer strategy space as decision trees rooted at
the device count of one pipeline stage: branch on TP degree (powers of two),
then ZeRO stage, sequence parallelism, expert parallelism and recomputation.
Infeasible combinations are discarded structurally (the paper's take-aways):

  T1. PP is applied first, across the slowest links — handled by the outer
      search loop, not the per-layer tree.
  T2. sp requires tp > 1; zero > 0 requires dp·cp > 1.
  T3. TP degrees capped by the fast-domain size (TP never crosses pods).
  T4. EP only for MoE layers, ep ≤ min(dp, num_experts), ep | num_experts.
  T5. Cost/memory-dominated candidates are pruned *after* costing
      (prune_dominated) — a leaf that is both slower and more memory-hungry
      than another can never be chosen by the DP.
  T6. CP (ring flash-attention) only for dense-family attention blocks, and
      only when the sequence splits into 2·cp zig-zag chunks
      (context.validate_cp) — the same gate the runtime enforces, so a
      searched cp plan can never fail to stage.

``mesh_constrained=True`` restricts TP to {1, model-axis width} — the
degrees realizable on the fixed production mesh (DESIGN.md §4); the free
mode searches all powers of two like the paper.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.analysis import invariants as inv
from repro_torch.configs.registry import ModelConfig
from repro_torch.core.strategy import LayerStrategy, REMAT_POLICIES


def _powers_of_two(limit: int) -> list[int]:
    out, v = [], 1
    while v <= limit:
        out.append(v)
        v *= 2
    return out


def cp_candidates(cfg: ModelConfig, devices: int, *,
                  seq_len: Optional[int] = None,
                  layer_kind: str = "attn_block",
                  mesh_constrained_cp: Optional[int] = None,
                  max_cp: Optional[int] = None) -> list[int]:
    """Context-parallel degrees realizable for one layer kind (T6).

    Ring flash-attention is implemented for dense-family attention blocks;
    cp>1 additionally needs the zig-zag split to divide the sequence
    (seq_len % (2·cp) == 0).  ``mesh_constrained_cp`` restricts to {1, cp
    axis width}; ``max_cp`` caps the free-mode power-of-two enumeration
    (None => cp stays 1, the conservative default)."""
    supported = layer_kind == "attn_block" and cfg.family == "dense"
    if not supported or seq_len is None:
        return [1]
    if mesh_constrained_cp is not None:
        ok = (mesh_constrained_cp > 1 and mesh_constrained_cp <= devices
              and inv.cp_seq_divisible(seq_len, mesh_constrained_cp))
        return [1] + ([mesh_constrained_cp] if ok else [])
    if max_cp is None:
        return [1]
    return [c for c in _powers_of_two(min(devices, max_cp))
            if inv.cp_seq_divisible(seq_len, c)]


def candidate_strategies(
    cfg: ModelConfig,
    devices: int,                       # devices per pipeline stage
    *,
    max_tp: Optional[int] = None,       # fast-domain cap (T3)
    mesh_constrained_tp: Optional[int] = None,   # fixed mesh: tp in {1, this}
    mesh_data_axis: Optional[int] = None,        # fixed mesh: ep in {1, this}
    layer_kind: str = "attn_block",
    remat_options=REMAT_POLICIES,
    seq_len: Optional[int] = None,      # enables cp enumeration (T6)
    mesh_constrained_cp: Optional[int] = None,   # fixed mesh: cp in {1, this}
    max_cp: Optional[int] = None,       # free-mode cp cap (None => cp=1 only)
) -> list[LayerStrategy]:
    if mesh_constrained_tp is not None:
        tp_opts = [1] + ([mesh_constrained_tp] if mesh_constrained_tp <= devices else [])
    else:
        tp_opts = _powers_of_two(min(devices, max_tp or devices))
    cp_opts = cp_candidates(cfg, devices, seq_len=seq_len, layer_kind=layer_kind,
                            mesh_constrained_cp=mesh_constrained_cp,
                            max_cp=max_cp)
    out: list[LayerStrategy] = []
    is_moe = layer_kind == "moe_block" and cfg.num_experts > 0
    for tp in tp_opts:
        for cp in cp_opts:
            dp = devices // (tp * cp)
            if dp * tp * cp != devices:
                continue
            zero_opts = (0, 1, 2, 3) if dp * cp > 1 else (0,)
            sp_opts = (False, True) if tp > 1 else (False,)
            if is_moe:
                if mesh_data_axis is not None:
                    # fixed mesh: the expert dim shards over the full data axis
                    # or not at all (partial-axis sharding is not expressible)
                    ep_opts = [1] + ([mesh_data_axis]
                                     if cfg.num_experts % mesh_data_axis == 0
                                     and mesh_data_axis <= dp else [])
                else:
                    ep_opts = [e for e in _powers_of_two(min(dp, cfg.num_experts))
                               if cfg.num_experts % e == 0]
            else:
                ep_opts = [1]
            for zero in zero_opts:
                for sp in sp_opts:
                    for ep in ep_opts:
                        for remat in remat_options:
                            out.append(LayerStrategy(tp=tp, sp=sp, zero=zero,
                                                     remat=remat, ep=ep, cp=cp))
    return out


def prune_dominated(cands: list[LayerStrategy], times: list[float],
                    mems: list[float]) -> list[int]:
    """Indices of Pareto-optimal (time, memory) candidates (T5)."""
    order = sorted(range(len(cands)), key=lambda i: (times[i], mems[i]))
    kept: list[int] = []
    best_mem = math.inf
    for i in order:
        if mems[i] < best_mem - 1e-9:
            kept.append(i)
            best_mem = mems[i]
    return sorted(kept)
