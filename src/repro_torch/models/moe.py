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

**On a mesh** (training: a layer group's rules active) the layer computes
what JAX's GSPMD computes from the same rules, whose traced call is the
global microbatch: the rows of the layer's batch group
(``collectives.batch_group``), rank after rank.  So C is the capacity of
the global token count, the Switch aux loss takes global means (their sums
through ``reduce_from``: each rank's probabilities get their own share of
the grad), and the slots are JAX's: every rank all-gathers each rank's
(choice, expert) counts and offsets its own running count by the choices
ranked before its own (:func:`distributed_slots`).  A rank then computes
the experts for its own kept choices only, in a buffer of as many slots as
the fullest expert holds (its counts read on the host: the step is eager).
Under expert parallelism the rules shard the expert dim over the data axis
(``experts_group``): each kept choice's row goes to the rank holding its
expert by ``collectives.exchange`` and its output comes back the same way,
and that rank's buffer holds, at slot s of expert e, JAX's slot s among the
choices of the ranks that exchange with it.  The router, sharded the same
way, is gathered whole (``gather_sum``; kept in fp32).  JAX's ``lc`` sites
on the expert buffers become a tensor-parallel region when ``ff`` is
sharded: the dispatched rows enter it (``region_in``) and the expert
outputs leave it after ``w_out`` (an all-reduce over the model axis); the
routing reads the boundary's tokens outside it (under sequence
parallelism the gathered sequence), so every tp rank routes the same tokens
alike.  It is one path: off a mesh, and on a batch group of one rank with
no expert or tensor parallelism, every collective is the identity and the
numbers are the one-device ones, bitwise.
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
from repro_torch.parallel import collectives


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


def route(router_logits: torch.Tensor, cfg: ModelConfig, group=None, num_tokens: int = 0):
    """router_logits (T, E) fp32 -> (gates (T, k), expert_idx (T, k) int64,
    aux loss): the top-k of the softmax, sorted, renormalised; the Switch
    aux loss E · sum_e mean(p_e) · mean(top-1 == e).  With a ``group`` of
    ranks the means are over its ``num_tokens`` tokens: the sums
    all-reduced, the probabilities' through ``reduce_from``."""
    probs = torch.softmax(router_logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.experts_per_token, dim=-1, sorted=True)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    E = router_logits.shape[1]
    top1 = F.one_hot(idx[:, 0], E).float()
    if group is None or group.size == 1:
        me, ce = probs.mean(dim=0), top1.mean(dim=0)
    else:
        me = collectives.reduce_from(probs.sum(dim=0), group) / num_tokens
        ce = collectives.all_reduce(top1.sum(dim=0), group) / num_tokens
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


def choice_counts(expert_idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """expert_idx (T, k) -> (k, E) int64: how many tokens make expert e
    their j-th choice."""
    return F.one_hot(expert_idx, num_experts).sum(dim=0)


def slot_bases(counts: torch.Tensor) -> torch.Tensor:
    """counts (R, k, E), rank r's ``choice_counts`` in batch order ->
    (R, k, E): the slot of rank r's first j-th choice of expert e in
    GShard's priority order over the concatenated ranks, i.e. every
    rank's choices before the j-th, plus the j-th choices of the ranks
    before r."""
    R, k, E = counts.shape
    flat = counts.transpose(0, 1).reshape(k * R, E)                     # (j, r) order
    return (torch.cumsum(flat, dim=0) - flat).reshape(k, R, E).transpose(0, 1)


def distributed_slots(expert_idx: torch.Tensor, counts: torch.Tensor, rank: int,
                      capacity: int):
    """JAX's ``assign_slots`` on the ranks' concatenated tokens, computed on
    rank ``rank`` from its own expert_idx (T, k) and every rank's counts
    (R, k, E): (slots (T, k) clamped to [0, capacity), keep (T, k), the
    unclamped slots).  A choice's slot is its rank's base for its (choice,
    expert) plus the tokens of this rank before it with the same choice of
    the same expert.  On one rank it is ``assign_slots``."""
    E = counts.shape[2]
    base = slot_bases(counts)[rank]                                      # (k, E)
    onehot = F.one_hot(expert_idx, E)                                    # (T, k, E)
    within = (torch.cumsum(onehot, dim=0) - 1).gather(2, expert_idx[..., None])[..., 0]
    slot = within + base.gather(1, expert_idx.t()).t()
    return slot.clamp(0, capacity - 1), slot < capacity, slot


def kept_counts(counts: torch.Tensor, capacity: int) -> torch.Tensor:
    """counts (R, k, E) -> (R, E): how many of rank r's choices of expert e
    keep a slot below ``capacity``."""
    kept = torch.minimum((capacity - slot_bases(counts)).clamp(min=0), counts)
    return kept.sum(dim=1)


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


def _experts(params: dict, expert_in: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(E, C, D) -> (E, C, D): every expert's FFN on its slots, one batched
    product per weight."""
    dtype = expert_in.dtype
    h = torch.bmm(expert_in, params["w_in"].to(dtype))
    if cfg.mlp_type in ("swiglu", "geglu"):
        g = torch.bmm(expert_in, params["w_gate"].to(dtype))
        act = F.silu if cfg.mlp_type == "swiglu" else ffn._gelu
        h = act(g) * h
    elif cfg.mlp_type == "relu2":
        r = F.relu(h)
        h = r * r
    elif cfg.mlp_type == "gelu":
        h = ffn._gelu(h)
    else:
        raise ValueError(f"unknown mlp_type {cfg.mlp_type!r}")
    return torch.bmm(h, params["w_out"].to(dtype))


def moe_ffn_apply(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, D) -> (y (B, S, D) in x's dtype, fp32 aux loss); on a mesh,
    under the layer group's rules (see the module note)."""
    E = cfg.num_experts
    batch = collectives.batch_group()
    ranks = 1 if batch is None else batch.size
    local_experts = params["w_in"].shape[0]
    ep = collectives.experts_group() if local_experts < E else None
    if ep is not None and ep.size * local_experts != E:
        raise ValueError(f"{local_experts} experts a rank over {ep.size} ranks is not {E}")
    sharded = params["w_in"].shape[-1] < cfg.d_ff
    tp = collectives.tp_state()
    xr = collectives.region_in(x, sharded=False)     # the routed tokens: whole sequence
    B, S, D = xr.shape
    T = B * S
    xt = xr.reshape(T, D)
    # the dispatched tokens: entering the experts' region when ff is sharded
    xd = collectives.region_in(x, sharded=True).reshape(T, D) if sharded else xt
    C = _capacity(cfg, T * ranks)
    router = params["router"]
    if router.shape[1] < E:
        router = collectives.gather_sum(router, 1, collectives.experts_group())

    with record_function("moe_route"):
        router_logits = xt.float() @ router.float()
        gates, idx, aux = route(router_logits, cfg, batch, T * ranks)
        if ranks == 1:
            pos, keep = assign_slots(idx, E, C)
            cap = C
        else:
            with torch.no_grad():
                counts = collectives.all_gather(choice_counts(idx, E)[None], 0, batch)
                _, keep, _ = distributed_slots(idx, counts, batch.index, C)
                # the ranks whose choices share a buffer: this one, or those
                # exchanging with it; slots are counted among them alone
                members = [batch.index] if ep is None else collectives.member_indices(ep, batch)
                me = 0 if ep is None else ep.index
                pos = distributed_slots(idx, counts[members], me, C)[2]
                kept = kept_counts(counts, C)[members].cpu()              # (|members|, E)
            cap = max(int(kept.sum(dim=0).max()), 1)
            pos = pos.clamp(max=cap - 1)
        flat_slots = idx * cap + pos                                     # (T, k)

    with record_function("moe_dispatch"):
        if ep is None:
            inv = slot_inverse(idx, pos, keep, E, cap)
            expert_in = dispatch(xd, inv, flat_slots, keep)
        else:
            # kept choices in their owners' slot order, sent and placed
            order = torch.sort(torch.where(keep, flat_slots, E * cap).reshape(-1),
                               stable=True)
            send = kept[me].reshape(ep.size, local_experts).sum(dim=1).tolist()
            recv = kept[:, me * local_experts:(me + 1) * local_experts].sum(dim=1).tolist()
            n_send, n_recv, dev = sum(send), sum(recv), idx.device
            # one row at least, a row past n_send empty (the overflow id)
            ids = order.indices[:max(n_send, 1)]
            inv_send = torch.where(torch.arange(ids.shape[0], device=dev) < n_send, ids,
                                   idx.numel())
            send_slot = torch.zeros(idx.numel(), dtype=torch.long, device=dev)
            send_slot[ids[:n_send]] = torch.arange(n_send, device=dev)
            send_slot = send_slot.reshape(idx.shape)
            rows = dispatch(xd, inv_send, send_slot, keep)
            # each received row's slot in this rank's buffer, beside the rows
            dest = collectives.all_to_all(order.values[:n_send] % (local_experts * cap),
                                          send, recv, ep)[:, None]
            rows = collectives.exchange(rows, send, recv, ep)
            received = torch.arange(dest.shape[0], device=dev)[:, None] < n_recv
            inv = torch.full((local_experts * cap,), dest.shape[0], dtype=torch.long,
                             device=dev)
            inv[dest[:n_recv, 0]] = torch.arange(n_recv, device=dev)
            expert_in = dispatch(rows, inv, dest, received)

    with record_function("moe_experts"):
        expert_out = _experts(params, expert_in.reshape(local_experts, cap, D), cfg)
        if sharded:
            expert_out = collectives.reduce_from(expert_out, tp.group)
        expert_out = expert_out.reshape(local_experts * cap, D)

    with record_function("moe_combine"):
        if ep is not None:
            back = combine(expert_out, inv, dest, received)[:, 0]
            expert_out = collectives.exchange(back, recv, send, ep)
            flat_slots, inv = send_slot, inv_send
        gathered = combine(expert_out, inv, flat_slots, keep)
        w = (gates * keep.to(gates.dtype)).to(x.dtype)
        y = torch.bmm(w[:, None, :], gathered)[:, 0].reshape(B, S, D)
    y = collectives.region_out(y, sharded=False)      # under SP: this rank's sequence shard

    if cfg.shared_expert_ff:
        y = y + ffn.ffn_apply(params["shared"], x, cfg, cfg.shared_expert_ff)
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
