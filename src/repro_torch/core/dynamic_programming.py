"""Layer-wise dynamic programming under a per-device memory budget
(the paper's core algorithm, vectorized with numpy).

State: (layer, quantized-memory-used, strategy-of-previous-layer); the third
component carries the activation-resharding transition cost between adjacent
layers with different layouts.  Complexity O(L · M · C²) with M memory
buckets and C candidates — sub-second for 80-layer models, matching the
paper's "within minutes" claim with huge margin.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


def schedule_windowable(pp: int, grad_accum: int) -> bool:
    """True when the step's M = max(grad_accum, pp) microbatches window
    evenly into rounds of pp — the precondition for the 1F1B/interleaved
    min(pp, M)-style in-flight bound.  Shared by the search gates
    (SearchEngine._schedules_for), the memory model (CostEnv.pp_inflight)
    and the runtime (PipelineTrainer._num_windows) so the three can never
    drift apart — a search-says-fits / runtime-OOMs split is exactly the
    bug class this subsystem exists to prevent."""
    return pp >= 1 and max(grad_accum, pp) % pp == 0


def interleave_realizable(num_layers: int, pp: int, interleave: int) -> bool:
    """True when every stage can hold `interleave` equal non-contiguous layer
    chunks (stage_stack's (S, v, L/(S·v), ...) layout)."""
    return interleave >= 2 and num_layers % (pp * interleave) == 0


def schedule_space(pp: int, grad_accum: int, num_layers: int,
                   *, max_interleave: int = 4) -> list:
    """Realizable (pp_schedule, pp_interleave) pairs for one (pp, ga) combo.

    The DP runs once per pair — schedules change each layer's in-flight
    activation multiplier (memory_model) and the plan-level bubble/p2p
    (cost_model.pipeline_extras), so enumerating them here lets the layer DP
    trade bubble time against activation memory exactly as it already trades
    remat/ZeRO.  Gates mirror the runtime: 1F1B needs the padded microbatch
    count M = max(ga, pp) to window evenly into rounds of pp; interleaving v
    virtual stages needs num_layers divisible by pp·v.
    """
    if pp <= 1:
        return [("gpipe", 1)]
    out = [("gpipe", 1)]
    if schedule_windowable(pp, grad_accum):
        out.append(("1f1b", 1))
    v = 2
    while v <= max_interleave:
        if interleave_realizable(num_layers, pp, v):
            out.append(("interleaved", v))
        v *= 2
    return out


@dataclasses.dataclass
class DPResult:
    feasible: bool
    total_time: float
    choices: list             # per-layer candidate index
    mem_used: float           # bytes (quantized, upper bound)


def optimize(
    times: np.ndarray,        # (L, C) per-layer per-candidate step time (s)
    mems: np.ndarray,         # (L, C) per-layer per-candidate bytes
    budget: float,            # per-device bytes available for the layers
    trans: np.ndarray,        # (C, C) transition cost between adjacent layers
    n_buckets: int = 1024,
) -> DPResult:
    # ceil-quantization overcounts each layer by <1 bucket; with L≈80 layers
    # 256 buckets forfeited ~30% of the budget (measured: greedy beat the DP
    # by 5% on qwen3) — 1024 buckets caps the loss at ~8%.
    L, C = times.shape
    if L == 0:
        return DPResult(True, 0.0, [], 0.0)
    if budget <= 0:
        return DPResult(False, math.inf, [], 0.0)
    # total capacity must equal the budget exactly: n_buckets × bucket ==
    # budget (flooring bucket at 1 byte let toy budgets overshoot by
    # n_buckets×, admitting infeasible assignments)
    bucket = budget / n_buckets
    mem_b = np.ceil(mems / bucket).astype(np.int64)        # (L, C) buckets, >= 0
    M = n_buckets

    INF = np.float64(np.inf)
    # dp[m, c]: min time over first (l+1) layers using exactly m buckets,
    # layer l assigned candidate c
    dp = np.full((M + 1, C), INF)
    back = np.zeros((L, M + 1, C), np.int16)

    for c in range(C):
        mb = mem_b[0, c]
        if mb <= M:
            dp[mb, c] = times[0, c]

    for l in range(1, L):
        tot = dp[:, :, None] + trans[None, :, :]           # (M+1, P, C)
        prev_idx = np.argmin(tot, axis=1)                   # (M+1, C)
        cand = np.take_along_axis(tot, prev_idx[:, None, :], axis=1)[:, 0, :]
        new_dp = np.full_like(dp, INF)
        for c in range(C):
            mb = int(mem_b[l, c])
            if mb > M:
                continue
            if mb == 0:
                new_dp[:, c] = cand[:, c] + times[l, c]
                back[l, :, c] = prev_idx[:, c].astype(np.int16)
            else:
                new_dp[mb:, c] = cand[:-mb, c] + times[l, c]
                back[l, mb:, c] = prev_idx[:-mb, c].astype(np.int16)
        dp = new_dp

    flat = int(np.argmin(dp))
    m_star, c_star = divmod(flat, C)
    if not np.isfinite(dp[m_star, c_star]):
        return DPResult(False, math.inf, [], 0.0)

    choices = [0] * L
    m, c = m_star, c_star
    choices[L - 1] = c
    for l in range(L - 1, 0, -1):
        p = int(back[l, m, c])
        m -= int(mem_b[l, c])
        c = p
        choices[l - 1] = c
    return DPResult(True, float(dp[m_star, c_star]), choices, float(m_star * bucket))


def brute_force(times: np.ndarray, mems: np.ndarray, budget: float,
                trans: np.ndarray) -> DPResult:
    """Exhaustive reference for tests (use only for tiny L·C)."""
    import itertools

    L, C = times.shape
    best_t, best_assign = math.inf, None
    for assign in itertools.product(range(C), repeat=L):
        mem = sum(mems[l, c] for l, c in enumerate(assign))
        if mem > budget:
            continue
        t = sum(times[l, c] for l, c in enumerate(assign))
        t += sum(trans[assign[l - 1], assign[l]] for l in range(1, L))
        if t < best_t:
            best_t, best_assign = t, list(assign)
    if best_assign is None:
        return DPResult(False, math.inf, [], 0.0)
    return DPResult(True, best_t, best_assign,
                    float(sum(mems[l, c] for l, c in enumerate(best_assign))))
