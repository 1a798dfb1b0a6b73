"""Mixture-of-Experts transformer (moonshot 64 experts / top-6, grok 8 /
top-2): the port of ``repro.models.moe``.

Dispatch is GShard-style and capacity-based, written as an index
permutation, as in JAX: one small integer scatter (``slot_inverse``) builds
the slot -> token-choice map, and tokens move in both directions, and in
both backwards, by gathers (``dispatch`` / ``combine``, each a
``torch.autograd.Function`` whose backward is the opposite gather, JAX's
``custom_vjp`` pairs).  The experts run as batched products over the expert
dim (``torch.bmm`` on (E, C, d) x (E, d, f)), JAX's ``einsum``s: one batched
product per weight, so the ``selective`` remat policy recomputes them as
JAX's ``dots_with_no_batch_dims_saveable`` does, and saves the router's and
the shared expert's plain products.

Tokens past an expert's capacity are dropped from the expert path (GShard
semantics) and still flow through the residual and the shared expert.  The
capacity comes from the call's own token count T, so a decode step of 4
rows has C = 8 and every expert runs on its 8 slots.  The router's Switch
aux loss rides the block's ``extra`` scalar (``DenseTransformerLM``).

Nothing here reads a tensor on the host: C is a shape, ``F.one_hot`` with
an explicit class count does no host check on CUDA, and the slot count,
scatter-min and gathers run on the device; bf16 expert weights feed a bf16
pass with no copy.  So ``jit_prefill_step`` / ``jit_decode_step`` capture a
serving pass as a CUDA graph (C = 960 at prefill T = 8192, C = 8 at decode
T = 4), the profiler spans recording nothing inside it.

The routing, slot assignment and gathers are plain torch, as they are plain
``jnp`` in JAX; each stage is a profiler span (``moe_route``,
``moe_dispatch``, ``moe_experts``, ``moe_combine``).  Indices are int64
(JAX: int32), the dtype torch's gathers and scatters take.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.registry import ModelConfig
from repro_torch.models import ffn
from repro_torch.models.common import ParamDef
from repro_torch.models.transformer import DenseTransformerLM


def moe_ffn_defs(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    # explicit scales (lint: paramdef-scale), 1/sqrt(fan_in) as JAX writes them
    defs = {
        "router": ParamDef((d, e), ("embed", "experts"), init="small_normal"),
        "w_in": ParamDef((e, d, f), ("experts", "embed", "ff"), scale=1.0 / math.sqrt(d),
                         cast=True),
        "w_out": ParamDef((e, f, d), ("experts", "ff", "embed"), scale=1.0 / math.sqrt(f),
                          cast=True),
    }
    if cfg.mlp_type in ("swiglu", "geglu"):
        defs["w_gate"] = ParamDef((e, d, f), ("experts", "embed", "ff"),
                                  scale=1.0 / math.sqrt(d), cast=True)
    if cfg.shared_expert_ff:
        defs["shared"] = ffn.ffn_defs(cfg, cfg.shared_expert_ff)
    return defs


def _capacity(cfg: ModelConfig, num_tokens: int) -> int:
    cap = int(cfg.moe_capacity_factor * num_tokens * cfg.experts_per_token / cfg.num_experts)
    return max(cap, 8)


def route(router_logits: torch.Tensor, cfg: ModelConfig):
    """router_logits (T, E) fp32 -> (gates (T, k), expert_idx (T, k) int64,
    aux loss): the top-k of the softmax, sorted, renormalised; the Switch
    aux loss E · sum_e mean(p_e) · mean(top-1 == e)."""
    probs = torch.softmax(router_logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.experts_per_token, dim=-1, sorted=True)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    E = router_logits.shape[1]
    me = probs.mean(dim=0)
    ce = F.one_hot(idx[:, 0], E).float().mean(dim=0)
    return gates, idx, E * torch.sum(me * ce)


def assign_slots(expert_idx: torch.Tensor, num_experts: int, capacity: int):
    """Greedy slot assignment, GShard priority (the j-th choice after the
    (j-1)-th): expert_idx (T, k) -> slots (T, k) int64 in [0, capacity) and
    keep (T, k) bool.  A choice's slot is the number of choices of its
    expert before it in priority order (every token's first choice, then
    every token's second, ...): JAX's per-choice cumsum of one-hots plus the
    counts of the earlier choices, as one running count over an (E, k·T)
    one-hot whose scan runs along its contiguous dim."""
    T, k = expert_idx.shape
    order = expert_idx.t().reshape(-1)                                   # (k·T,)
    experts = torch.arange(num_experts, device=expert_idx.device)
    onehot = (order[None, :] == experts[:, None]).long()                 # (E, k·T)
    slot = torch.cumsum(onehot, dim=1).gather(0, order[None, :])[0] - 1
    slot = slot.reshape(k, T).t()
    return slot.clamp(0, capacity - 1), slot < capacity


def slot_inverse(idx: torch.Tensor, slots: torch.Tensor, keep: torch.Tensor,
                 E: int, C: int) -> torch.Tensor:
    """(E·C,) map: slot -> flat token-choice index (T·k = empty), by a
    scatter-min of token-choice ids into E·C + 1 entries whose last is the
    overflow bin of the dropped choices."""
    T, k = idx.shape
    flat = torch.where(keep.reshape(-1), (idx * C + slots).reshape(-1), E * C)
    ids = torch.arange(T * k, dtype=torch.long, device=idx.device)
    inv = torch.full((E * C + 1,), T * k, dtype=torch.long, device=idx.device)
    return inv.scatter_reduce_(0, flat, ids, "amin")[: E * C]


class _Dispatch(torch.autograd.Function):
    """xt (T, D) -> (E·C, D): slot s holds token ``inv[s] // k``, or zeros
    when it is empty.  Backward: each kept choice gathers its slot's grad,
    summed over the token's k choices."""

    @staticmethod
    def forward(ctx, xt, inv, flat_slots, keep):
        T = xt.shape[0]
        k = flat_slots.shape[1]
        ctx.save_for_backward(flat_slots, keep)
        ctx.in_dtype = xt.dtype
        vals = xt.index_select(0, torch.clamp(inv // k, 0, T - 1))
        return vals * (inv < T * k).to(xt.dtype)[:, None]

    @staticmethod
    def backward(ctx, g):
        flat_slots, keep = ctx.saved_tensors
        EC, D = g.shape
        T, k = flat_slots.shape
        safe = flat_slots.reshape(-1).clamp(0, EC - 1)
        gathered = g.index_select(0, safe) * keep.reshape(-1, 1).to(g.dtype)
        return gathered.reshape(T, k, D).sum(dim=1).to(ctx.in_dtype), None, None, None


class _Combine(torch.autograd.Function):
    """expert_flat (E·C, D) -> per-choice outputs (T, k, D), zero for a
    dropped choice.  Backward: each slot gathers the grad of the choice it
    holds (zero for an empty slot)."""

    @staticmethod
    def forward(ctx, expert_flat, inv, flat_slots, keep):
        EC, D = expert_flat.shape
        T, k = flat_slots.shape
        ctx.save_for_backward(inv)
        ctx.in_dtype = expert_flat.dtype
        safe = flat_slots.reshape(-1).clamp(0, EC - 1)
        out = expert_flat.index_select(0, safe) * keep.reshape(-1, 1).to(expert_flat.dtype)
        return out.reshape(T, k, D)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        T_k = g.shape[0] * g.shape[1]
        g_flat = g.reshape(T_k, g.shape[2])
        d = g_flat.index_select(0, inv.clamp(0, T_k - 1)) * (inv < T_k).to(g.dtype)[:, None]
        return d.to(ctx.in_dtype), None, None, None


def dispatch(xt, inv, flat_slots, keep) -> torch.Tensor:
    """xt (T, D), inv (E·C,), flat_slots (T, k), keep (T, k) -> (E·C, D)."""
    return _Dispatch.apply(xt, inv, flat_slots, keep)


def combine(expert_flat, inv, flat_slots, keep) -> torch.Tensor:
    """expert_flat (E·C, D) -> per-choice outputs (T, k, D)."""
    return _Combine.apply(expert_flat, inv, flat_slots, keep)


def moe_ffn_apply(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, D) -> (y (B, S, D) in x's dtype, fp32 aux loss)."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    E = cfg.num_experts
    C = _capacity(cfg, T)

    with record_function("moe_route"):
        router_logits = xt.float() @ params["router"].float()
        gates, idx, aux = route(router_logits, cfg)
        slots, keep = assign_slots(idx, E, C)
        inv = slot_inverse(idx, slots, keep, E, C)
        flat_slots = idx * C + slots                                     # (T, k)
    with record_function("moe_dispatch"):
        expert_in = dispatch(xt, inv, flat_slots, keep).reshape(E, C, D)

    with record_function("moe_experts"):
        h = torch.bmm(expert_in, params["w_in"].to(x.dtype))
        if cfg.mlp_type in ("swiglu", "geglu"):
            g = torch.bmm(expert_in, params["w_gate"].to(x.dtype))
            act = F.silu if cfg.mlp_type == "swiglu" else ffn._gelu
            h = act(g) * h
        elif cfg.mlp_type == "relu2":
            r = F.relu(h)
            h = r * r
        elif cfg.mlp_type == "gelu":
            h = ffn._gelu(h)
        else:
            raise ValueError(f"unknown mlp_type {cfg.mlp_type!r}")
        expert_out = torch.bmm(h, params["w_out"].to(x.dtype))

    with record_function("moe_combine"):
        gathered = combine(expert_out.reshape(E * C, D), inv, flat_slots, keep)
        w = (gates * keep.to(gates.dtype)).to(x.dtype)
        y = torch.bmm(w[:, None, :], gathered)[:, 0].reshape(B, S, D)

    if cfg.shared_expert_ff:
        y = y + ffn.ffn_apply(params["shared"], x, cfg)
    return y, aux


class MoETransformerLM(DenseTransformerLM):
    """Dense attention + the MoE FFN.  The router's aux loss is each block's
    ``extra``, summed over the layers by ``forward_train``; the serving
    passes drop it."""

    def ffn_defs(self) -> dict:
        return moe_ffn_defs(self.cfg)

    def ffn_apply(self, params: dict, x: torch.Tensor):
        y, aux = moe_ffn_apply(params, x, self.cfg)
        return y, aux.float()
