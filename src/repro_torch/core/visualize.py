"""Cost-model visualization plugin (paper §2: "Galvatron includes a
visualization plugin for the cost model, enhancing user accessibility").

The port's copy of ``repro.core.visualize``: renders an ExecutionPlan as a
per-layer strategy map with the cost/memory breakdown each layer's choice
implies — terminal/markdown friendly.  The default cluster is one H100
card (``H100_1``); pass another ``ClusterSpec`` to price the plan there.
"""
from __future__ import annotations

from repro_torch.configs.registry import ModelConfig
from repro_torch.core import cost_model as cm
from repro_torch.core import memory_model as mm
from repro_torch.core.cluster import H100_1, ClusterSpec
from repro_torch.core.profiler_model import profile_model
from repro_torch.core.strategy import ExecutionPlan

_GLYPH = {"none": "█", "selective": "▓", "full": "░"}


def _seq_glyph(s) -> str:
    """Sequence-dimension handling per layer: R = cp ring (through attention),
    possibly stacked with Megatron-SP; S = SP only (block boundaries); · =
    full sequence per device."""
    if s.cp > 1:
        return "R"
    if s.sp:
        return "S"
    return "·"


def render_plan(
    cfg: ModelConfig,
    plan: ExecutionPlan,
    seq_len: int,
    global_batch: int,
    cluster: ClusterSpec = H100_1,
    width: int = 64,
) -> str:
    profile = profile_model(cfg, seq_len, causal_frac=0.5)
    devices = plan.num_devices // plan.pp
    env = cm.CostEnv(cluster=cluster, devices=devices, pp=plan.pp,
                     micro_batch=global_batch // plan.grad_accum,
                     grad_accum=plan.grad_accum,
                     pp_schedule=plan.pp_schedule,
                     pp_interleave=plan.pp_interleave)
    lines = [
        f"plan: {plan.arch} × {plan.shape}   mesh {plan.mesh_shape} "
        f"pp={plan.pp} ga={plan.grad_accum}",
        f"predicted step {plan.predicted_step_time:.3f}s · "
        f"memory {plan.predicted_memory/1e9:.1f} GB/device",
        "",
        "layer map (█ no-remat ▓ selective ░ full):",
    ]
    # strategy band
    strats = plan.layer_strategies
    band = "".join(_GLYPH.get(s.remat, "?") for s in strats)
    lines.append(f"  {band}")
    # sequence band: where does each layer's seq dim live?
    lines.append("seq map (R cp-ring S megatron-sp · replicated):")
    lines.append("  " + "".join(_seq_glyph(s) for s in strats))
    # group legend with per-group costs
    lines.append("")
    lines.append(f"  {'layers':>10s}  {'strategy':22s} {'t/layer':>9s} {'mem/layer':>10s}")
    for g in plan.groups():
        s = g.strategy
        lp = profile.layers[min(g.start, len(profile.layers) - 1)]
        t = cm.layer_step_time(lp, s, env)
        m = mm.layer_memory(lp, s, env)
        lines.append(f"  {f'{g.start}..{g.stop-1}':>10s}  {s.short():22s} "
                     f"{t*1e3:8.2f}ms {m/1e6:9.1f}MB")
    # cost decomposition for the dominant strategy
    s0 = plan.default_strategy
    lp0 = profile.layers[0]
    comp = cm.compute_time(lp0, s0, env)
    tpc = cm.tp_comm_time(lp0, s0, env)
    dpc = cm.dp_comm_time(lp0, s0, env)
    epc = cm.ep_comm_time(lp0, s0, env)
    cpc = cm.cp_comm_time(lp0, s0, env)
    lines += [
        "",
        f"per-layer cost split (default {s0.short()}):",
        f"  compute {comp*1e3:8.2f} ms/micro · tp-comm {tpc*1e3:.2f} · "
        f"cp-ring {cpc*1e3:.2f} · dp-comm {dpc*1e3:.2f}/step · "
        f"ep-comm {epc*1e3:.2f}",
    ]
    return "\n".join(lines)
