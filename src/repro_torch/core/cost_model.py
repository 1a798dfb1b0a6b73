"""Time cost model — per-layer, per-strategy execution time.

Follows the paper's decomposition: compute (profiled FLOPs / attainable
throughput, with ceil() padding waste for non-divisible TP shards), TP/SP
collectives (2 activation all-reduces per block per direction, repeated by
recomputation), ZeRO/DP gradient traffic (amortized once per optimizer step,
partially overlapped with backward compute), MoE all-to-all, and pipeline
p2p + bubble.  All formulas route through :mod:`repro_torch.core.profiler_hw` so a
different cluster (the Fig.-3 GPU presets) changes the answers — that is the
mechanism by which Galvatron picks different strategies per cluster.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core import calibrate as cal
from repro_torch.core import profiler_hw as hw
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.dynamic_programming import schedule_windowable
from repro_torch.core.profiler_model import LayerProfile, ModelProfile
from repro_torch.core.strategy import LayerStrategy

# Tunable coefficients live in repro_torch.core.calibrate (fitted from the profile
# cache; these aliases are the analytic defaults and keep old import sites
# working).  Reading them through CostEnv/Calibration is lint-enforced
# (calibration-constant) — only dtype/byte-layout facts may be fresh
# module-level numeric constants here.
BWD_FLOPS_FACTOR = cal.ANALYTIC_BWD_FLOPS_FACTOR
DP_OVERLAP = cal.ANALYTIC_DP_OVERLAP
GRAD_BYTES = 4.0                # fp32 gradient reduction (dtype fact)

#: Bytes per element charged for pipeline stage-boundary p2p.  Must equal the
#: itemsize of parallel/pipeline.py's BOUNDARY_DTYPE (fp32) — the plan
#: verifier asserts the agreement statically (GALV040), so a dtype change in
#: either place without the other is caught before anything compiles.
PIPELINE_BOUNDARY_BYTES_PER_ELEM = 4.0


@dataclasses.dataclass(frozen=True)
class CostEnv:
    cluster: ClusterSpec
    devices: int                  # devices per pipeline stage (dp * tp)
    pp: int
    micro_batch: int              # samples per microbatch (global)
    grad_accum: int               # microbatches per step
    opt_bytes: float = 8.0        # Adam m+v bytes/param (4.0 = bf16 states)
    pp_schedule: str = "gpipe"    # gpipe | 1f1b | interleaved (strategy.PP_SCHEDULES)
    pp_interleave: int = 1        # virtual stages per physical stage
    dtype: str = "bf16"           # compute dtype (selects calibrated throughput)
    calibration: cal.Calibration = cal.DEFAULT_CALIBRATION

    def dp(self, strat: LayerStrategy) -> int:
        """Batch-sharding degree: cp takes devices out of the DP pool (a cp
        rank holds a sequence shard, not a batch shard)."""
        return max(self.devices // max(strat.tp * strat.cp, 1), 1)

    def state_dp(self, strat: LayerStrategy) -> int:
        """ZeRO/grad-reduction group size: params replicate over cp, so
        states shard (and grads reduce) over the dp·cp group."""
        return max(self.dp(strat) * max(strat.cp, 1), 1)

    def local(self, strat: LayerStrategy) -> float:
        """Samples per device per microbatch (dp-sharded batch)."""
        return max(self.micro_batch / self.dp(strat), 1e-9)

    def microbatches(self) -> int:
        """Microbatches per step; the PP runtime pads up to one per stage."""
        return max(self.grad_accum, self.pp)

    def pp_inflight(self) -> float:
        """Peak in-flight microbatch activations per stage for this schedule.

        GPipe runs every forward before any backward, so a stage holds all
        M = max(grad_accum, pp) microbatches at peak (NOT pp — the historical
        under-count this field replaces).  1F1B caps warm-up at one microbatch
        per downstream stage: min(pp, M) — but only when M windows evenly
        into rounds of pp; otherwise the runtime (train_pp._num_windows)
        degrades to a single gpipe window and the honest charge is M.
        Interleaved 1F1B over v virtual stages adds a v-chunk warm-up term:
        pp·(1 + (v-1)/v), still capped at M."""
        if self.pp <= 1:
            return 1.0
        M = self.microbatches()
        windowable = schedule_windowable(self.pp, self.grad_accum)
        if self.pp_schedule == "1f1b" and windowable:
            return float(min(self.pp, M))
        if self.pp_schedule == "interleaved" and windowable:
            v = max(self.pp_interleave, 1)
            return float(min(M, self.pp * (1.0 + (v - 1.0) / v)))
        return float(M)                                  # gpipe / unwindowable

    # ------------------------------------------------- calibrated constants
    def eff_flops(self) -> float:
        """Attainable FLOP/s for this env's dtype (measured fit, else the
        analytic peak × efficiency)."""
        return self.calibration.eff_flops(self.cluster, self.dtype)

    def bwd_factor(self) -> float:
        return self.calibration.bwd_flops_factor

    def comm_cluster(self) -> ClusterSpec:
        """Cluster the collective formulas run against: measured link
        constants substituted when fitted, the analytic cluster otherwise
        (identity — same object)."""
        return self.calibration.effective_cluster(self.cluster)


def _ceil_frac(dim: int, shards: int) -> float:
    """ceil-padding waste factor for sharding `dim` over `shards`."""
    if shards <= 1 or dim <= 0:
        return 1.0
    return math.ceil(dim / shards) * shards / dim


def compute_time(profile: LayerProfile, strat: LayerStrategy, env: CostEnv) -> float:
    eff = env.eff_flops()
    fwd = 0.0
    for part in profile.flop_parts:
        tp = strat.tp
        waste = _ceil_frac(part.shard_dim, tp) if part.shard_dim else 1.0
        fwd += part.flops * waste / tp if part.shard_dim else part.flops
    # every FLOP part scales with the sequence, so cp shards all of them;
    # cp | seq is validated (no ceil waste on the seq dim)
    fwd *= env.local(strat) / eff / max(strat.cp, 1)
    total = fwd * (1.0 + env.bwd_factor())
    if strat.remat == "full":
        total += fwd * env.calibration.remat_overhead
    elif strat.remat == "selective":
        total += (profile.flops_quadratic / (strat.tp * max(strat.cp, 1))
                  ) * env.local(strat) / eff
    return total


def tp_comm_time(profile: LayerProfile, strat: LayerStrategy, env: CostEnv) -> float:
    """Activation all-reduces over the TP group (AG+RS under SP — same volume).
    Under cp the boundary activations are seq-sharded, so the per-device
    collective volume divides by cp."""
    if strat.tp <= 1:
        return 0.0
    nbytes = (profile.seq_len * env.local(strat) * _d_model(profile) * 2.0
              / max(strat.cp, 1))
    n_coll = profile.tp_collectives * 2          # fwd + bwd
    if strat.remat == "full":
        n_coll += profile.tp_collectives         # recompute repeats fwd collectives
    return n_coll * hw.allreduce_time(nbytes, strat.tp, env.comm_cluster())


def cp_comm_time(profile: LayerProfile, strat: LayerStrategy, env: CostEnv) -> float:
    """Ring flash-attention k/v rotation over the cp group, per microbatch.

    One full ring pass is (cp-1) neighbor hops of 2·(seq/cp)·(H/tp)·hd bytes
    — the GQA-expanded, tp-head-sharded k and v blocks the runtime actually
    permutes (profiler_model.cp_ring_bytes carries the expanded-H volume;
    tp divides it here, matching the head sharding).  Three passes per
    microbatch: the forward k/v ring, the backward's recompute k/v ring
    (flash-VJP semantics — the ring is recomputed in the backward), and the
    backward dk/dv-partial rotation (the transpose of every roll/ppermute).
    Each hop overlaps with the previous block's attention compute (a
    (S/cp)² score block) — only the excess is exposed."""
    cp = max(strat.cp, 1)
    if cp <= 1 or profile.cp_ring_bytes == 0:
        return 0.0
    hop_bytes = env.local(strat) * profile.cp_ring_bytes / cp / max(strat.tp, 1)
    eff = env.eff_flops()
    block_compute = (profile.flops_quadratic / (strat.tp * cp * cp)
                     ) * env.local(strat) / eff
    hop = hw.ring_hop_time(hop_bytes, env.comm_cluster(), intra=True)
    exposed_pass = (cp - 1) * hw.exposed_time(hop, block_compute)
    return 3.0 * exposed_pass         # fwd + bwd-recompute + dk/dv rings


def _d_model(profile: LayerProfile) -> float:
    # boundary acts are 4*S*d*2 bytes -> recover d
    return profile.act_boundary / (4.0 * 2.0 * profile.seq_len)


def dp_comm_time(profile: LayerProfile, strat: LayerStrategy, env: CostEnv) -> float:
    """Gradient/param traffic over the state group (dp·cp — cp replicates
    params, so its ranks join every grad reduction), once per optimizer step."""
    dp = env.state_dp(strat)
    if dp <= 1:
        return 0.0
    tp_share = profile.param_count_tp / max(strat.tp, 1) + \
        (profile.param_count - profile.param_count_tp - profile.expert_param_count)
    ep_share = profile.expert_param_count / max(strat.ep * strat.tp, 1)
    p_local = tp_share + ep_share
    grad_bytes = p_local * GRAD_BYTES
    cl = env.comm_cluster()
    t = 0.0
    if strat.zero <= 1:
        # all-reduce grads (zero-1's RS+AG has identical ring volume)
        t += hw.allreduce_time(grad_bytes, dp, cl)
    elif strat.zero == 2:
        t += hw.reducescatter_time(grad_bytes, dp, cl)
        t += hw.allgather_time(p_local * 2.0, dp, cl)   # updated bf16 params
    else:
        # zero-3: params are SHARDED, so every microbatch all-gathers them in
        # fwd and bwd (plus once more under full recompute) — ×grad_accum,
        # unlike the once-per-step gradient reduction.  (Charging this per
        # step instead made the search pick zero3+ga16 for grok and the
        # dry-run HLO showed 220 s of all-gathers vs the predicted 20 s.)
        n_ag = 2.0 + (1.0 if strat.remat == "full" else 0.0)
        t += env.grad_accum * n_ag * hw.allgather_time(p_local * 2.0, dp, cl)
        t += hw.reducescatter_time(grad_bytes, dp, cl)
    return t


def ep_comm_time(profile: LayerProfile, strat: LayerStrategy, env: CostEnv) -> float:
    if strat.ep <= 1 or profile.ep_a2a_bytes == 0:
        return 0.0
    nbytes = profile.ep_a2a_bytes * env.local(strat)
    return 2.0 * hw.alltoall_time(nbytes, strat.ep, env.comm_cluster())  # fwd + bwd


def layer_step_time(profile: LayerProfile, strat: LayerStrategy, env: CostEnv) -> float:
    """Per-optimizer-step time contribution of one layer under one strategy:
    M microbatches of compute+TP+EP, plus DP traffic with overlap credit."""
    per_micro = (compute_time(profile, strat, env)
                 + tp_comm_time(profile, strat, env)
                 + cp_comm_time(profile, strat, env)
                 + ep_comm_time(profile, strat, env))
    compute_total = env.grad_accum * per_micro
    dp = dp_comm_time(profile, strat, env)
    bf = env.bwd_factor()
    bwd_span = compute_total * bf / (1.0 + bf)
    dp_exposed = max(dp - env.calibration.dp_overlap * bwd_span, dp * 0.05)
    return compute_total + dp_exposed


def transition_time(prev: LayerStrategy, nxt: LayerStrategy,
                    profile: LayerProfile, env: CostEnv) -> float:
    """Activation resharding between differently-laid-out adjacent layers.
    Per-device boundary bytes divide by the seq sharding BOTH layouts share
    (min cp) — a cp=4→cp=4 tp-change moves quarter blocks, while a cp→1
    transition must materialize the full sequence somewhere."""
    if (prev.tp, prev.sp, prev.cp) == (nxt.tp, nxt.sp, nxt.cp):
        return 0.0
    nbytes = (profile.seq_len * env.local(nxt) * _d_model(profile) * 2.0
              / max(min(prev.cp, nxt.cp), 1))
    n = max(prev.tp, nxt.tp, prev.cp, nxt.cp, 2)
    return env.grad_accum * 2.0 * hw.allgather_time(nbytes, n, env.comm_cluster())


def pipeline_boundary_bytes(model_profile: ModelProfile, env: CostEnv,
                            strat: Optional[LayerStrategy] = None) -> float:
    """Per-device bytes one microbatch moves across a stage boundary.

    The runtime (parallel/pipeline.py) casts the boundary activation to fp32
    and permutes the whole ``(mb, seq, D)`` block; it is batch-sharded over
    the DP axes and seq-sharded over the cp axis (D is replicated over the
    model axis at block boundaries), so the per-device transfer divides by
    dp·cp — NOT by dp·tp(·pp) as the model once assumed."""
    dp = env.dp(strat) if strat is not None else env.devices
    cp = max(strat.cp, 1) if strat is not None else 1
    return (model_profile.d_model * model_profile.seq_len
            * env.micro_batch / dp / cp * PIPELINE_BOUNDARY_BYTES_PER_ELEM)


def pipeline_extras(model_profile: ModelProfile, env: CostEnv,
                    per_micro_stage_time: float,
                    strat: Optional[LayerStrategy] = None) -> float:
    """Schedule-dependent pipeline overhead per step: bubble + inter-stage p2p.

    GPipe and 1F1B share the (pp-1)·t_micro bubble (1F1B reorders backward
    work but fills no extra slots); interleaving v virtual stages divides the
    bubble by v because each warm-up slot is a 1/v-depth chunk.  p2p charges
    one fp32 boundary block per stage-boundary hop per microbatch, fwd + bwd;
    interleaving multiplies hops by v (each microbatch traverses the physical
    ring v times, including the wrap hop back to stage 0 between passes)."""
    if env.pp <= 1:
        return 0.0
    v = max(env.pp_interleave, 1) if env.pp_schedule == "interleaved" else 1
    bubble = (env.pp - 1) * per_micro_stage_time / v
    act_bytes = pipeline_boundary_bytes(model_profile, env, strat)
    hops = v * (env.pp - 1) + (v - 1)
    p2p = 2.0 * env.microbatches() * hops * hw.p2p_time(act_bytes, env.comm_cluster())
    return bubble + p2p


def head_time(model_profile: ModelProfile, strat: LayerStrategy, env: CostEnv) -> float:
    """Embed + lm-head + loss, per step (seq-sharded over cp at boundaries)."""
    eff = env.eff_flops()
    shards = max(strat.tp, 1) * max(strat.cp, 1)
    per_micro = (model_profile.head_flops * env.local(strat) / shards / eff) * 3.0
    return env.grad_accum * per_micro


# --------------------------------------------------------------------------
# serving decode roofline (continuous batching — tokens, not steps)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecodeCost:
    """One batched decode step: one new token for every in-flight stream.

    Decode at serving batch sizes is **memory-bandwidth-bound**: every step
    must stream the full tp-shard of the weights plus each stream's KV
    history from HBM, while the matching FLOPs are only ~2 per weight
    element.  Compute and memory traffic overlap (the MXU consumes as the
    HBM streams), so the step charges ``max(mem, compute)``; TP collectives
    are exposed latency on top.
    """

    mem_s: float                    # (weights/tp + kv history) / hbm_bw
    compute_s: float                # 2·N·batch / tp / attainable FLOPs
    comm_s: float                   # tp all-reduces, 2 per layer

    @property
    def bound(self) -> str:
        return "memory" if self.mem_s >= self.compute_s else "compute"

    @property
    def step_s(self) -> float:
        return max(self.mem_s, self.compute_s) + self.comm_s


def decode_step_time(profile: ModelProfile, cluster: ClusterSpec, *,
                     kv_len: int, tp: int = 1, batch: int = 1,
                     bytes_per_elem: float = 2.0, dtype: str = "bf16",
                     calibration: cal.Calibration = cal.DEFAULT_CALIBRATION,
                     ) -> DecodeCost:
    """Roofline for one continuous-batching decode tick with ``batch``
    streams each holding ``kv_len`` cached tokens.  Weights and the KV pool
    both shard over ``tp`` (the serving cache shards its sequence dim over
    the model axis), so tp divides the memory traffic but adds two
    activation all-reduces per layer."""
    cfg = profile.cfg
    cl = calibration.effective_cluster(cluster)
    tp = max(tp, 1)
    weight_bytes = bytes_per_elem * profile.total_params() / tp
    kv_bytes_per_tok = (2.0 * bytes_per_elem * cfg.num_layers
                        * cfg.num_kv_heads * cfg.resolved_head_dim)
    mem_s = (weight_bytes + batch * kv_len * kv_bytes_per_tok / tp) / cl.hbm_bw
    compute_s = (2.0 * profile.total_params() * batch / tp
                 / calibration.eff_flops(cluster, dtype))
    comm_s = 0.0
    if tp > 1:
        nbytes = batch * profile.d_model * bytes_per_elem
        comm_s = 2.0 * cfg.num_layers * hw.allreduce_time(nbytes, tp, cl)
    return DecodeCost(mem_s, compute_s, comm_s)


def prefill_time(profile: ModelProfile, cluster: ClusterSpec, *,
                 prompt_len: int, tp: int = 1, bytes_per_elem: float = 2.0,
                 dtype: str = "bf16",
                 calibration: cal.Calibration = cal.DEFAULT_CALIBRATION,
                 ) -> float:
    """Compute-bound prompt pass for one request (the TTFT floor before any
    queueing): 2·N forward FLOPs per prompt token over the tp shard, plus
    the same two all-reduces per layer at prompt width."""
    cfg = profile.cfg
    tp = max(tp, 1)
    t = (2.0 * profile.total_params() * prompt_len / tp
         / calibration.eff_flops(cluster, dtype))
    if tp > 1:
        cl = calibration.effective_cluster(cluster)
        nbytes = prompt_len * profile.d_model * bytes_per_elem
        t += 2.0 * cfg.num_layers * hw.allreduce_time(nbytes, tp, cl)
    return t
