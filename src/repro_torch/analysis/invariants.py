"""Shared divisibility/capacity predicates — the single source of truth.

Every gate the search engine, decision tree, context-parallel runtime and
elastic replanner apply lives here as a pure-stdlib predicate, and the plan
verifier (:mod:`repro_torch.analysis.plan_check`) checks the *same* functions — so
the verifier and the search can never disagree about what is realizable.
Pure stdlib on purpose: the repo linter's CI job installs no numpy.
"""
from __future__ import annotations


def cp_seq_divisible(seq_len: int, cp: int) -> bool:
    """Ring flash-attention needs the zig-zag split to divide the sequence
    into 2·cp equal chunks (parallel/context.py layout)."""
    return cp >= 1 and (cp == 1 or seq_len % (2 * cp) == 0)


def pp_layers_divisible(num_layers: int, pp: int) -> bool:
    """stage_stack splits the block stack into pp equal stages."""
    return pp >= 1 and (pp == 1 or num_layers % pp == 0)


def batch_shardable(batch: int, dp: int) -> bool:
    """A (micro)batch must shard evenly over the DP degree — fractional
    per-device samples make GSPMD replicate instead of shard."""
    return dp >= 1 and batch % dp == 0


def ga_divides_batch(global_batch: int, grad_accum: int) -> bool:
    """Gradient accumulation slices the global batch into equal microbatches."""
    return grad_accum >= 1 and global_batch % grad_accum == 0


def mesh_factorizable(stage_devices: int, tp: int, cp: int) -> tuple[bool, int]:
    """(ok, dp) for one pipeline stage: dp·tp·cp must exactly tile the
    stage's devices (rectangular mesh, no remainder ranks)."""
    denom = max(tp * cp, 1)
    dp = stage_devices // denom
    return (dp >= 1 and dp * denom == stage_devices), max(dp, 1)


def heads_shardable(num_heads: int, tp: int) -> bool:
    """tp | heads; a failure is padding waste (ceil sharding), not an error."""
    return tp >= 1 and (tp == 1 or num_heads % tp == 0)


def experts_shardable(num_experts: int, ep: int, dp: int) -> bool:
    """EP shards the expert dim over (part of) the data axis: ep must divide
    the expert count and fit inside the DP degree."""
    return ep >= 1 and (ep == 1 or (num_experts > 0
                                    and num_experts % ep == 0 and ep <= dp))
