"""Memory cost model — per-device bytes for model states and activations.

Model states (per parameter): fp32 master (4B) + fp32 grads (4B) + Adam
m/v (8B) = 16B, each divided by the DP degree at its ZeRO stage and by the TP
degree for TP-sharded matrices (expert matrices divide by ep·tp instead).
Activations follow the saved-tensor inventory from the model profiler,
scaled by the local microbatch, divided by TP for the inner (head-/ff-
sharded) region and by TP for the boundary region only under SP, divided by
the context-parallel degree everywhere (cp shards the sequence through the
whole layer — ring attention), and reduced by the recomputation level.  The pipeline path multiplies activations by the
schedule's in-flight microbatch count (``CostEnv.pp_inflight``): GPipe holds
all M = max(grad_accum, pp) microbatches at peak, 1F1B holds min(pp, M),
interleaved holds a pp·(1+(v-1)/v) warm-up term.  Shared-weight groups
(zamba2's shared attention block) count their parameters once.
"""
from __future__ import annotations


from repro_torch.core.cost_model import CostEnv
from repro_torch.core.profiler_model import LayerProfile, ModelProfile
from repro_torch.core.strategy import LayerStrategy

MASTER_BYTES = 4.0
GRAD_BYTES = 4.0
OPT_BYTES = 8.0          # adam m+v fp32 (AdamWConfig can halve this — see notes)


def layer_state_bytes(profile: LayerProfile, strat: LayerStrategy, env: CostEnv,
                      *, count_params: bool = True) -> float:
    # ZeRO shards states over the dp·cp group — cp replicates parameters
    # (only activations are sequence-sharded), so its ranks join the layout
    dp, tp, ep = env.state_dp(strat), strat.tp, strat.ep
    dense_tp = profile.param_count_tp / tp
    dense_rest = profile.param_count - profile.param_count_tp - profile.expert_param_count
    experts = profile.expert_param_count / max(ep * tp, 1)
    p_local = dense_tp + dense_rest + experts
    if not count_params:
        return 0.0
    master = MASTER_BYTES * p_local / (dp if strat.zero >= 3 else 1)
    grads = GRAD_BYTES * p_local / (dp if strat.zero >= 2 else 1)
    opt = getattr(env, "opt_bytes", OPT_BYTES) * p_local / (dp if strat.zero >= 1 else 1)
    transient_bf16 = 2.0 * p_local / (dp if strat.zero >= 3 else 1)
    return master + grads + opt + transient_bf16


def layer_act_bytes(profile: LayerProfile, strat: LayerStrategy, env: CostEnv) -> float:
    samples = env.local(strat)
    tp = strat.tp
    cp = max(strat.cp, 1)     # context parallelism shards the seq dim of the
                              # FULL layer's activations — inner and boundary
    boundary = profile.act_boundary / (tp if strat.sp else 1) / cp
    if strat.remat == "full":
        inner = 0.0
        boundary = profile.act_boundary / (4.0 if not strat.sp else 4.0 * tp) / cp
    elif strat.remat == "selective":
        inner = profile.act_selective_inner / tp / cp
    else:
        inner = profile.act_inner / tp / cp
    # Schedule-aware in-flight count (CostEnv.pp_inflight): GPipe holds every
    # one of the step's M = max(grad_accum, pp) microbatches at peak — the old
    # `pp` here under-counted whenever grad_accum > pp and let the search emit
    # plans that OOM at runtime; 1F1B earns min(pp, M); interleaved pays a
    # pp·(1+(v-1)/v) warm-up term.
    return samples * (inner + boundary) * env.pp_inflight()


def layer_memory(profile: LayerProfile, strat: LayerStrategy, env: CostEnv,
                 *, count_params: bool = True) -> float:
    return (layer_state_bytes(profile, strat, env, count_params=count_params)
            + layer_act_bytes(profile, strat, env))


def fixed_memory(model_profile: ModelProfile, strat: LayerStrategy, env: CostEnv) -> float:
    """Embedding states + logits working set (per device).  The logits are
    seq-sharded under cp (the lm head consumes cp-sharded boundary acts)."""
    cfg = model_profile.cfg
    p_embed = model_profile.embed_params
    vocab_shardable = cfg.vocab_size % max(strat.tp, 1) == 0
    tp = strat.tp if vocab_shardable else 1
    p_local = p_embed / tp / (env.state_dp(strat) if strat.zero >= 3 else 1)
    states = (MASTER_BYTES + GRAD_BYTES + getattr(env, "opt_bytes", OPT_BYTES) + 2.0) * p_local
    logits = (2.5 * model_profile.logits_bytes * env.local(strat)
              / max(tp, 1) / max(strat.cp, 1))
    return states + logits


def plan_memory(model_profile: ModelProfile, strategies: list, env: CostEnv,
                fixed_strategy=None) -> float:
    """Peak per-device bytes for a full per-layer strategy assignment.
    ``fixed_strategy`` is the strategy applied to embeddings/logits (the
    plan's default_strategy in the runtime)."""
    total = fixed_memory(model_profile, fixed_strategy or strategies[0], env)
    seen_shared: set = set()
    for lp, st in zip(model_profile.layers, strategies):
        count = True
        if lp.shared_group is not None:
            count = lp.shared_group not in seen_shared
            seen_shared.add(lp.shared_group)
        total += layer_memory(lp, st, env, count_params=count)
    if env.pp > 1:
        total = total / env.pp * 1.0 + fixed_memory(
            model_profile, fixed_strategy or strategies[0], env) * (
            1.0 - 1.0 / env.pp)  # stage share of layers; embed/head on every stage
    return total * env.cluster.mem_overhead * env.calibration.mem_scale


def kv_cache_bytes(cfg, batch: int, seq_len: int) -> float:
    """Serving-side cache size (global, bf16)."""
    if cfg.family == "ssm":
        di = cfg.ssm_expand * cfg.d_model
        H = di // cfg.ssm_head_dim
        per_layer = batch * (H * cfg.ssm_state * cfg.ssm_head_dim * 4.0
                             + (cfg.conv_width - 1) * (di + 2 * cfg.ssm_groups * cfg.ssm_state) * 2.0)
        return cfg.num_layers * per_layer
    kv = 2.0 * batch * seq_len * cfg.num_kv_heads * cfg.resolved_head_dim * 2.0
    if cfg.family == "hybrid":
        di = cfg.ssm_expand * cfg.d_model
        H = di // cfg.ssm_head_dim
        mamba = cfg.num_layers * batch * (H * cfg.ssm_state * cfg.ssm_head_dim * 4.0)
        return mamba + (cfg.num_layers // cfg.attn_every) * kv
    layers = cfg.num_layers
    return layers * kv
