"""Model profiler — per-layer compute / parameter / activation profiles.

The paper's model profiler measures per-layer forward time and memory on the
target device.  The search reads profiles derived *analytically* from the
architecture config (exact FLOP/byte counting); :func:`measure_block` is the
measured path — one block's forward and backward, each a CUDA graph as JAX
jits them, timed on the card — whose cells :mod:`repro_torch.core.calibrate`
fits the cost model's coefficients from.

All per-layer quantities are **per sample** (batch=1, one sequence of
``seq_len``); the cost/memory models scale them by local batch and shard
sizes.  FLOP parts carry the dimension TP shards so the cost model can apply
ceil() padding waste (e.g. qwen3's 40 heads on a 16-wide model axis).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.configs.registry import ModelConfig


@dataclasses.dataclass(frozen=True)
class FlopPart:
    flops: float          # fwd FLOPs per sample
    shard_dim: int        # size of the dim TP shards (ceil waste); 0 = not TP-sharded


@dataclasses.dataclass
class LayerProfile:
    name: str
    kind: str                       # attn_block | moe_block | mamba_block | enc_block | dec_block
    seq_len: int
    flop_parts: list                # list[FlopPart]
    flops_quadratic: float          # S² attention portion (selective-remat recompute)
    param_count: int
    param_count_tp: int             # params on TP-shardable matrices
    shared_group: Optional[str]     # same string => weights shared across layers
    act_inner: float                # bytes/sample saved in the TP region (divides by tp)
    act_boundary: float             # bytes/sample at block boundaries (divides by tp iff sp)
    act_selective_inner: float      # inner bytes kept under selective remat
    tp_collectives: int             # all-reduce volume factors per fwd (count of S*d AR)
    ep_a2a_bytes: float             # MoE dispatch+combine bytes/sample (over ep group)
    expert_param_count: int = 0     # sharded over ep instead of tp
    cp_ring_bytes: float = 0.0      # k+v bytes/sample one full ring pass moves
                                    # (0 => layer cannot context-parallelize)

    @property
    def flops(self) -> float:
        return sum(p.flops for p in self.flop_parts)

    @property
    def param_bytes(self) -> float:
        return 2.0 * self.param_count


@dataclasses.dataclass
class ModelProfile:
    cfg: ModelConfig
    seq_len: int
    layers: list                    # list[LayerProfile]
    embed_params: int
    head_flops: float               # lm head fwd FLOPs/sample
    logits_bytes: float             # fp32 logits bytes/sample
    d_model: int

    def total_params(self) -> int:
        seen = set()
        total = self.embed_params
        for lp in self.layers:
            if lp.shared_group is not None:
                if lp.shared_group in seen:
                    continue
                seen.add(lp.shared_group)
            total += lp.param_count
        return total

    def model_flops_per_token(self) -> float:
        """6·N (dense) / 6·N_active (MoE) — the §Roofline MODEL_FLOPS basis."""
        cfg = self.cfg
        n = self.total_params()
        if cfg.num_experts:
            active = 0
            for lp in self.layers:
                dense = lp.param_count - lp.expert_param_count
                active += dense + lp.expert_param_count * cfg.experts_per_token / cfg.num_experts
            active += self.embed_params
            n = active
        return 6.0 * n


# --------------------------------------------------------------------------
# analytic per-family profiles
# --------------------------------------------------------------------------

def _attn_parts(cfg: ModelConfig, S: int, causal_frac: float) -> tuple[list, float]:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    parts = [
        FlopPart(2.0 * S * d * H * hd, H),                 # wq
        FlopPart(2.0 * S * d * 2 * KV * hd, KV),           # wk, wv
        FlopPart(2.0 * S * S * H * hd * 2 * causal_frac, H),  # scores + att@v
        FlopPart(2.0 * S * H * hd * d, H),                 # wo
    ]
    quad = parts[2].flops
    return parts, quad


def _mlp_parts(cfg: ModelConfig, S: int, d_ff: int) -> list:
    n_mats = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    return [FlopPart(2.0 * S * cfg.d_model * d_ff * n_mats, d_ff)]


def _attn_acts(cfg: ModelConfig, S: int) -> tuple[float, float, float]:
    """(inner, boundary, selective_inner) bytes/sample for an attention+mlp block."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    f = cfg.d_ff
    bpe = 2.0
    qkv = S * (H + 2 * KV) * hd * bpe
    attn_out = S * H * hd * bpe
    softmax_stats = S * H * 4.0 * 2                       # flash m/l fp32
    mlp = (3 if cfg.mlp_type in ("swiglu", "geglu") else 2) * S * f * bpe
    inner = qkv + attn_out + softmax_stats + mlp
    boundary = 4 * S * d * bpe                            # ln1/ln2 inputs + residuals
    selective_inner = qkv + attn_out                      # keep matmul outs, drop mlp acts
    return inner, boundary, selective_inner


def _dense_block(cfg: ModelConfig, S: int, causal_frac: float, name: str,
                 kind: str = "attn_block", shared: Optional[str] = None) -> LayerProfile:
    attn_parts, quad = _attn_parts(cfg, S, causal_frac)
    mlp_parts = _mlp_parts(cfg, S, cfg.d_ff)
    d, H, KV, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.resolved_head_dim, cfg.d_ff)
    p_attn = d * (H + 2 * KV) * hd + H * hd * d
    p_bias = (H + 2 * KV) * hd if cfg.qkv_bias else 0
    p_qknorm = 2 * hd if cfg.qk_norm else 0
    p_mlp = (3 if cfg.mlp_type in ("swiglu", "geglu") else 2) * d * f
    p_norm = 2 * d
    inner, boundary, sel = _attn_acts(cfg, S)
    return LayerProfile(
        name=name, kind=kind, seq_len=S,
        flop_parts=attn_parts + mlp_parts, flops_quadratic=quad,
        param_count=p_attn + p_bias + p_qknorm + p_mlp + p_norm,
        param_count_tp=p_attn + p_mlp,
        shared_group=shared,
        act_inner=inner, act_boundary=boundary, act_selective_inner=sel,
        tp_collectives=2, ep_a2a_bytes=0.0,
        # k+v blocks, bf16.  The runtime rings k/v AFTER GQA expansion
        # (attention_block expands to the q-head count before attention_math),
        # so the per-hop volume scales with H, not KV — and divides by tp in
        # the cost model, since the expanded heads are tp-sharded.
        cp_ring_bytes=2.0 * S * H * hd * 2.0,
    )


def _moe_block(cfg: ModelConfig, S: int, causal_frac: float, name: str) -> LayerProfile:
    base = _dense_block(cfg, S, causal_frac, name, kind="moe_block")
    d, f, E, k = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.experts_per_token
    cf = cfg.moe_capacity_factor
    n_mats = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    # replace dense mlp part with expert mlp over k*cf tokens + router + shared
    parts = [p for p in base.flop_parts[:-1]]
    parts.append(FlopPart(2.0 * S * k * cf * d * f * n_mats, f))   # expert ffn
    parts.append(FlopPart(2.0 * S * d * E, 0))                     # router
    p_mlp_dense = n_mats * d * cfg.d_ff
    p_experts = E * n_mats * d * f
    p_shared = (3 if cfg.mlp_type in ("swiglu", "geglu") else 2) * d * cfg.shared_expert_ff \
        if cfg.shared_expert_ff else 0
    if cfg.shared_expert_ff:
        parts.append(FlopPart(2.0 * S * d * cfg.shared_expert_ff *
                              (3 if cfg.mlp_type in ("swiglu", "geglu") else 2), cfg.shared_expert_ff))
    p_attn_side = base.param_count - p_mlp_dense
    inner, boundary, sel = _attn_acts(cfg, S)
    # replace mlp acts with expert buffer acts (capacity tokens)
    inner = inner - (n_mats * S * cfg.d_ff * 2.0) + (n_mats + 1) * S * k * cf * f * 2.0
    return dataclasses.replace(
        base,
        flop_parts=parts,
        param_count=p_attn_side + p_experts + p_shared + d * E,
        param_count_tp=base.param_count_tp - p_mlp_dense + p_shared,
        expert_param_count=p_experts,
        act_inner=inner,
        act_selective_inner=sel,
        ep_a2a_bytes=2.0 * S * k * d * 2.0,               # dispatch + combine, bf16
    )


def _mamba_block(cfg: ModelConfig, S: int, name: str) -> LayerProfile:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    H = di // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    G, N, W = cfg.ssm_groups, cfg.ssm_state, cfg.conv_width
    Q = 64  # chunk
    proj = 2.0 * S * d * (2 * di + 2 * G * N + H)
    conv = 2.0 * S * (di + 2 * G * N) * W
    ssd = (2.0 * S * Q * N * H      # C·Bᵀ within chunk
           + 2.0 * S * Q * P * H    # M @ X
           + 4.0 * S * N * P * H)   # state contribs + inter-chunk out
    gate_out = 2.0 * S * di * d
    parts = [
        FlopPart(proj, di), FlopPart(conv, di),
        FlopPart(ssd, H), FlopPart(gate_out, di),
    ]
    p = (d * (2 * di + 2 * G * N + H) + W * (di + 2 * G * N)
         + 3 * H + di + di * d + d)
    acts_inner = (2 * S * di + 2 * S * (di + 2 * G * N)   # z/x + conv outs
                  + S * H * 4 + 2 * S * G * N             # dt fp32 + B/C
                  + (S // Q + 1) * H * N * P * 4          # chunk states fp32
                  + S * di) * 2.0
    return LayerProfile(
        name=name, kind="mamba_block", seq_len=S,
        flop_parts=parts, flops_quadratic=0.0,
        param_count=p, param_count_tp=d * (2 * di + 2 * G * N + H) + di * d,
        shared_group=None,
        act_inner=acts_inner, act_boundary=2 * S * d * 2.0,
        act_selective_inner=acts_inner * 0.5,
        tp_collectives=2, ep_a2a_bytes=0.0,
    )


def profile_model(cfg: ModelConfig, seq_len: int, *, causal_frac: float = 1.0) -> ModelProfile:
    """causal_frac: 0.5 when the attention kernel skips the upper triangle."""
    S = seq_len
    layers: list[LayerProfile] = []
    if cfg.family in ("dense", "vlm", "moe"):
        S_eff = S  # vlm: seq_len already includes the vis prefix at call sites
        for i in range(cfg.num_layers):
            if cfg.family == "moe":
                layers.append(_moe_block(cfg, S_eff, causal_frac, f"layer{i}"))
            else:
                layers.append(_dense_block(cfg, S_eff, causal_frac, f"layer{i}"))
    elif cfg.family == "ssm":
        for i in range(cfg.num_layers):
            layers.append(_mamba_block(cfg, S, f"layer{i}"))
    elif cfg.family == "hybrid":
        for i in range(cfg.num_layers):
            layers.append(_mamba_block(cfg, S, f"mamba{i}"))
            if (i + 1) % cfg.attn_every == 0:
                layers.append(_dense_block(cfg, S, causal_frac, f"shared_attn@{i}",
                                           shared="shared_attn"))
    elif cfg.family == "audio":
        for i in range(cfg.enc_layers):
            layers.append(_dense_block(cfg, cfg.enc_frames, 1.0, f"enc{i}", kind="enc_block"))
        for i in range(cfg.num_layers):
            blk = _dense_block(cfg, S, causal_frac, f"dec{i}", kind="dec_block")
            # add cross-attention (kv over enc frames)
            d, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                            cfg.resolved_head_dim)
            F = cfg.enc_frames
            cross = [
                FlopPart(2.0 * S * d * H * hd, H),
                FlopPart(2.0 * F * d * 2 * KV * hd, KV),
                FlopPart(2.0 * S * F * H * hd * 2, H),
                FlopPart(2.0 * S * H * hd * d, H),
            ]
            blk = dataclasses.replace(
                blk,
                flop_parts=blk.flop_parts + cross,
                flops_quadratic=blk.flops_quadratic + cross[2].flops,
                param_count=blk.param_count + 2 * d * H * hd + 2 * d * KV * hd + d,
                param_count_tp=blk.param_count_tp + 2 * d * H * hd + 2 * d * KV * hd,
                tp_collectives=3,
            )
            layers.append(blk)
    else:
        raise ValueError(cfg.family)

    embed_params = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    head_flops = 2.0 * S * cfg.d_model * cfg.vocab_size
    logits_bytes = 4.0 * S * cfg.vocab_size
    return ModelProfile(cfg=cfg, seq_len=S, layers=layers,
                        embed_params=embed_params, head_flops=head_flops,
                        logits_bytes=logits_bytes, d_model=cfg.d_model)


# --------------------------------------------------------------------------
# measured path (one block on the model's device: the card by default)
# --------------------------------------------------------------------------

_DTYPES = {"fp32": "float32", "bf16": "bfloat16"}


def _block_apply_fn(cfg: ModelConfig, device="cuda", dtype: str = "bf16"):
    """(params, apply) for one block on ``device``, its parameters from
    ``init_params`` (seed 0) in ``dtype``; ``apply(p, x) -> y`` is the
    block's training forward on the kernel path (K1, K2 and K3 on the card,
    their plain versions on the CPU).  As in JAX, the ssm and hybrid
    families measure a Mamba2 block, the dense, vlm and moe families a
    decoder block (``block_defs`` / ``block_apply``; the MoE block's router
    aux loss stays out of ``y``, as JAX's ``[0]`` leaves it out)."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.models.common import init_params, resolve_device

    tdt = getattr(torch, _DTYPES[dtype])
    gen = lambda dev: torch.Generator(device=dev).manual_seed(0)
    if cfg.family in ("ssm", "hybrid"):
        from repro_torch.models.mamba2 import mamba_block_apply, mamba_block_defs

        dev = resolve_device(device)
        params = init_params(mamba_block_defs(cfg), gen(dev), dev, tdt)
        return params, lambda p, x: mamba_block_apply(p, x, cfg, impl="kernel")[0]
    if cfg.family not in ("dense", "vlm", "moe"):
        raise NotImplementedError(
            f"the {cfg.family!r} family has no block to measure: JAX's measure_block reaches "
            "model.block_apply, which EncDecLM lacks (src/repro/models/encdec.py:19), and "
            "raises AttributeError; the port measures dense, vlm, moe, ssm and hybrid blocks")
    model = build_model(cfg, impl="kernel", device=device)
    params = init_params(model.block_defs(), gen(model.device), model.device, tdt)
    return params, lambda p, x: model.block_apply(p, x, mode="train")[0]


def _timed(fn, *args, device, iters: int = 3) -> float:
    """Median wall time of ``fn(*args)`` over ``iters`` calls after one
    untimed call, each call closed by a device synchronize.  The untimed
    call builds the kernel library and lets cuBLAS pick its algorithms; for
    a compiled step it is the warm-up and capture, so the timed calls are
    graph replays (JAX's protocol: the first call compiles)."""
    import torch

    def run():
        fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _grad_fn(apply):
    """``(p, x) -> grads`` of ``sum(apply(p, x).float())`` with respect to
    every leaf of ``p``, in ``tree_leaves`` order."""
    import torch

    from repro_torch.models.common import tree_leaves, tree_map

    def grad(p, x):
        live = tree_map(lambda a: a.detach().requires_grad_(), p)
        with torch.enable_grad():
            loss = apply(live, x).float().sum()
            return torch.autograd.grad(loss, tree_leaves(live))

    return grad


def _forward_fn(apply):
    import torch

    def fwd(p, x):
        with torch.no_grad():
            return apply(p, x)

    return fwd


@dataclasses.dataclass
class BlockSteps:
    """One block's measured steps on its device, each called as
    ``step(params, x)``: ``forward`` (``no_grad``) -> y, ``grad`` -> the
    grads of ``sum(y)`` in ``tree_leaves(params)`` order, ``grad_remat``
    the same under the ``full`` remat policy (``parallel/remat.py``);
    ``apply`` is the block's eager training forward ``apply(p, x) -> y``."""
    params: dict
    x: Any
    apply: Callable
    forward: Callable
    grad: Callable
    grad_remat: Callable


def block_steps(cfg: ModelConfig, seq_len: int, *, batch: int = 1, dtype: str = "bf16",
                device="cuda", compiled: bool = True,
                input_seed: Optional[int] = None) -> BlockSteps:
    """The steps ``measure_block`` times for one (cfg, seq, batch, dtype)
    cell, on the block's parameters and input ``x`` (zeros as in JAX, or a
    seeded standard normal with ``input_seed``).

    ``compiled`` makes each step a ``runtime/compiled.py::compile_step`` —
    the port's ``compat.jit``, as JAX jits the forward and both grads: the
    parameters held, ``x`` fed, one graph pool for the three.  On the card
    the first call warms the step up and captures it as a CUDA graph (a
    capture that fails raises; nothing falls back to the eager call), and
    later calls replay it; on the CPU the same plumbing calls the step
    directly.  ``compiled=False`` gives the eager steps (the oracle)."""
    import torch

    from repro_torch.models.common import tree_leaves
    from repro_torch.parallel.remat import apply_remat

    params, apply = _block_apply_fn(cfg, device, dtype)
    dev = tree_leaves(params)[0].device
    shape = (batch, seq_len, cfg.d_model)
    tdt = getattr(torch, _DTYPES[dtype])
    if input_seed is None:
        x = torch.zeros(shape, dtype=tdt, device=dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(input_seed)
        x = torch.randn(shape, generator=gen, device=dev).to(tdt)
    steps = {"forward": _forward_fn(apply), "grad": _grad_fn(apply),
             "grad_remat": _grad_fn(apply_remat(apply, "full"))}
    if compiled:
        from repro_torch.runtime.compiled import compile_step

        pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
        steps = {name: compile_step(fn, dev, held=(0,), pool=pool,
                                    name=f"{cfg.name} block {name}")
                 for name, fn in steps.items()}
    return BlockSteps(params=params, x=x, apply=apply, **steps)


def measure_block_time(cfg: ModelConfig, seq_len: int, batch: int = 1,
                       iters: int = 5, device="cuda") -> float:
    """Median wall time of one bf16 block forward on ``device``, compiled
    (``block_steps``: a graph replay on the card)."""
    steps = block_steps(cfg, seq_len, batch=batch, device=device)
    return _timed(steps.forward, steps.params, steps.x, device=steps.x.device, iters=iters)


@dataclasses.dataclass(frozen=True)
class BlockMeasurement:
    """One measured profile-cache cell (see profile_cache.ProfileEntry for
    field semantics — this is the wire format measure_block hands back)."""
    fwd_time_s: float
    bwd_time_s: float
    remat_extra_s: float
    peak_bytes: float
    flops_fwd: float
    act_bytes_pred: float
    iters: int


def measure_block(cfg: ModelConfig, seq_len: int, *, batch: int = 1,
                  iters: int = 3, dtype: str = "bf16",
                  with_remat: bool = True, device="cuda", compiled: bool = True,
                  input_seed: Optional[int] = None) -> BlockMeasurement:
    """Measure one (cfg, seq, batch, dtype) cell for the profile cache on
    ``device``: the block forward's wall time, grad-minus-forward backward
    time, the ``full`` remat policy's overhead, each step compiled as JAX
    compiles it (``block_steps``; ``compiled=False``: eager), and the
    forward's peak memory (the eager ``no_grad`` forward's working set plus
    its arguments, read from ``torch.cuda.max_memory_allocated`` over a
    second eager forward once the graphs are gone, so cuBLAS's workspace
    for the current stream is not counted; 0.0 on the CPU), plus the
    analytic FLOP/activation bases the calibration fits against.

    ``x`` is zeros, as in the JAX package; ``input_seed`` draws it from a
    seeded standard normal instead (to see whether zeros flatter the card)."""
    import torch

    from repro_torch.models.common import tree_leaves

    steps = block_steps(cfg, seq_len, batch=batch, dtype=dtype, device=device,
                        compiled=compiled, input_seed=input_seed)
    params, x, apply, dev = steps.params, steps.x, steps.apply, steps.x.device
    fwd_t = _timed(steps.forward, params, x, device=dev, iters=iters)
    total_t = _timed(steps.grad, params, x, device=dev, iters=iters)
    bwd_t = max(total_t - fwd_t, 0.0)

    remat_extra = 0.0
    if with_remat:
        ck_t = _timed(steps.grad_remat, params, x, device=dev, iters=iters)
        remat_extra = max(ck_t - total_t, 0.0)
    del steps                               # the graphs and their pool

    peak = 0.0
    if dev.type == "cuda":
        fwd = _forward_fn(apply)
        args = sum(a.numel() * a.element_size() for a in tree_leaves(params) + [x])
        fwd(params, x)          # the graphs ran on their own stream: warm this one
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        fwd(params, x)
        torch.cuda.synchronize(dev)
        peak = float(torch.cuda.max_memory_allocated(dev) - base + args)

    lp = profile_model(cfg, seq_len, causal_frac=1.0).layers[0]
    return BlockMeasurement(
        fwd_time_s=fwd_t, bwd_time_s=bwd_t, remat_extra_s=remat_extra,
        peak_bytes=peak, flops_fwd=lp.flops * batch,
        act_bytes_pred=(lp.act_inner + lp.act_boundary) * batch, iters=iters)
