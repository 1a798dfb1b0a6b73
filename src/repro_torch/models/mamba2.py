"""Mamba2 (SSD) blocks — attention-free LM, O(1)-state decode (the port of
``repro.models.mamba2``).

Block: RMSNorm -> {z, x, B, C, dt} projections -> causal depthwise conv on
(x|B|C) -> SSD scan -> D-skip -> gated RMSNorm(y * silu(z)) -> out-proj.
The parameter tree, the cast order and the cache layout are the JAX
package's, so ``params_from_jax`` carries weights across unchanged, with one
move: the JAX model casts x, B and C to fp32 before the SSD scan and y back
after it; here the scan takes them in the working dtype and upcasts inside
(the kernel and ``ssd_chunked`` alike), returning y in that dtype.  A bf16 ->
fp32 cast is exact and y is rounded once either way, so the function is the
same; a bf16 model skips four casts per layer.

``impl="kernel"`` runs the RMSNorm kernel (K2; the gate norm as its gated
form, one pass over y and z) and the SSD scan kernel (K3) on CUDA tensors
and their plain versions on CPU tensors; ``impl="ref"`` runs the plain
PyTorch math everywhere.  Decode runs ``ssd_step`` in plain torch
on every device, as the JAX package does (jnp, not a kernel).

``forward_train`` is differentiable, as JAX's: its layer loop is a
``layer_runner`` (the runtime's applies each layer's remat policy), K3 runs
under ``ssd_autograd`` (backward: a plain fp32 recompute) and the gate norm
as ``rmsnorm(y * silu(z))`` through K2's autograd function.  On a mesh
under tensor parallelism each layer is a region (``mamba_block_apply``);
the residual stream between layers holds the boundary layout (sequence
shards under sequence parallelism, where ``ln`` and ``final_norm`` take
``seq_partial``), as the dense family's does.

Decode state per layer: the conv ring buffer (the last W-1 inputs of each
conv channel) and the SSD state (B, H, N, P) fp32.  Two departures from the
JAX model, both on purpose:

- ``forward_prefill`` left-pads the conv buffers with zeros when the prompt
  is shorter than W-1 (what ``_causal_conv``'s padding means); the JAX model
  slices ``xv[:, S-(W-1):]``, which for S < W-1 keeps fewer rows and makes
  the first decode step fail;
- ``forward_decode`` writes the new state into ``cache`` in place (one
  buffer at full width rather than a second 0.7 GB stack per step).

Decode reads nothing on the host (``_conv_step`` and ``ssd_step`` are tensor
ops and ``cache_index`` is unused), so ``jit_decode_step`` captures it as a
CUDA graph; the graph's warm-up runs on a clone of the state, which a call
advances.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.registry import ModelConfig
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import _expand_groups
from repro_torch.models import embedding
from repro_torch.models.common import (ParamDef, init_params, resolve_device, stacked,
                                       unstack_layers)
from repro_torch.models.norms import gated_rmsnorm, rmsnorm, rmsnorm_defs
from repro_torch.models.transformer import default_layer_runner
from repro_torch.parallel import collectives
from repro_torch.parallel.axes import lc


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    return d_inner, H, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim


def mamba_block_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_inner, H, G, N, P = _dims(cfg)
    W = cfg.conv_width
    return {
        "ln": rmsnorm_defs(d),
        "w_z": ParamDef((d, d_inner), ("embed", "ssm_inner"), cast=True),
        "w_x": ParamDef((d, d_inner), ("embed", "ssm_inner"), cast=True),
        "w_B": ParamDef((d, G * N), ("embed", "ssm_groups"), cast=True),
        "w_C": ParamDef((d, G * N), ("embed", "ssm_groups"), cast=True),
        "w_dt": ParamDef((d, H), ("embed", "ssm_heads"), cast=True),
        "conv_x": ParamDef((W, d_inner), ("conv", "ssm_inner"), scale=0.5, cast=True),
        "conv_B": ParamDef((W, G * N), ("conv", "ssm_groups"), scale=0.5, cast=True),
        "conv_C": ParamDef((W, G * N), ("conv", "ssm_groups"), scale=0.5, cast=True),
        "A_log": ParamDef((H,), ("ssm_heads",), init="zeros"),
        "D": ParamDef((H,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamDef((H,), ("ssm_heads",), init="zeros"),
        "gate_norm": rmsnorm_defs(d_inner),
        "w_out": ParamDef((d_inner, d), ("ssm_inner", "embed"), cast=True),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C); w: (W, C)."""
    W = w.shape[0]
    pad = F.pad(x, (0, 0, W - 1, 0))                 # F.pad: last dim first
    out = torch.zeros_like(x)
    for k in range(W):
        out = out + pad[:, k:k + x.shape[1], :] * w[W - 1 - k][None, None, :]
    return out


def _conv_step(buf: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor):
    """buf: (B, W-1, C) past inputs; x_t: (B, C). Returns (new_buf, y_t).

    Tap order mirrors ``_causal_conv``: w[0] multiplies the NEWEST sample,
    w[W-1] the oldest — the window is oldest->newest, so flip w."""
    dtype = torch.promote_types(buf.dtype, x_t.dtype)
    window = torch.cat([buf.to(dtype), x_t[:, None, :].to(dtype)], dim=1)   # (B, W, C)
    y = torch.einsum("bwc,wc->bc", window, torch.flip(w, [0]).to(dtype))
    return window[:, 1:, :], y


def _projections(params: dict, h: torch.Tensor):
    dtype = h.dtype
    return tuple(torch.matmul(h, params[k].to(dtype))
                 for k in ("w_z", "w_x", "w_B", "w_C", "w_dt"))


def _conv_tail(v: torch.Tensor, keep: int) -> torch.Tensor:
    """The last ``keep`` rows of (B, S, C), left-padded with zeros when S < keep."""
    v = v[:, max(v.shape[1] - keep, 0):, :]
    return F.pad(v, (0, 0, keep - v.shape[1], 0))


def local_groups(H: int, G: int, tp: int, rank: int) -> tuple[int, int]:
    """The groups ``[g0, g1)`` whose B/C rank ``rank`` of ``tp`` reads: it
    holds the contiguous heads ``[rank·H/tp, (rank+1)·H/tp)``, and head h
    reads group ``h // (H/G)`` (``_expand_groups``).  So each of its heads
    reads the group ``_expand_groups`` gives it at the local counts,
    ``H/tp`` heads over ``g1 - g0`` groups.  Raises ``ValueError`` naming
    the dims where tp does not divide H, or where a rank's heads straddle
    groups unevenly (neither tp | G nor G | tp): there ``spec_for_shape``
    would shard some of the layer's leaves and not others, which GSPMD
    reshards and the port does not."""
    if H % G:
        raise ValueError(f"{H} SSM heads do not fall into {G} groups")
    if H % tp or (G % tp and tp % G):
        raise ValueError(f"tp {tp} over {H} SSM heads (ssm_heads) in {G} groups "
                         f"(ssm_groups): tp must divide the heads, and tp | G or G | tp, "
                         "so that every rank's heads read whole groups")
    per_rank, per_group = H // tp, H // G
    first = rank * per_rank
    return first // per_group, (first + per_rank - 1) // per_group + 1


def check_tp(cfg: ModelConfig, tp: int) -> None:
    """Raise ``ValueError`` where ``tp`` ranks cannot each hold whole groups
    of ``cfg``'s Mamba2 heads (``local_groups``)."""
    _, H, G, _, _ = _dims(cfg)
    local_groups(H, G, tp, 0)


def _tp_params(params: dict, N: int, H: int, G: int, group) -> dict:
    """A sharded layer's params on this rank: B and C's projections and
    convolutions cut to the groups its heads read (``local_groups``), their
    grads summed over the model axis, since every rank holds them whole and
    uses them in part (so do the gate norm's scale, sliced by
    ``gated_rmsnorm``)."""
    g0, g1 = local_groups(H, G, group.size, group.index)
    out = dict(params)
    for name in ("w_B", "w_C", "conv_B", "conv_C"):
        out[name] = collectives.partial_grad(params[name])[:, g0 * N:g1 * N]
    return out


def mamba_block_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                      mode: str = "train", state: Optional[dict] = None,
                      impl: str = "kernel"):
    """x: (B, S, D).  ``mode`` train | prefill | decode (S = 1, ``state``
    {"conv_x","conv_B","conv_C","ssm"} of this layer).  Returns (x + block
    output, new state or None).

    Under tensor parallelism (training on a mesh) the layer is a region, as
    JAX's ``lc`` sites lay it out: ``w_z`` / ``w_x`` / ``conv_x`` hold this
    rank's ``d_inner`` columns, ``w_dt``, ``A_log``, ``D`` and ``dt_bias``
    its heads and ``w_out`` its rows; the region sees the whole sequence
    (``region_in`` gathers it under sequence parallelism), K3 runs on the
    local heads and the groups they read, the gate norm on the split row,
    and ``region_out`` sums the row-parallel ``w_out`` (a reduce-scatter to
    sequence shards under SP)."""
    d_inner, H, G, N, P = _dims(cfg)
    tp = collectives.tp_state() if mode == "train" else None
    ln = params["ln"]
    sharded = False
    if tp is not None:
        sharded = params["w_x"].shape[-1] < d_inner
        ln = collectives.seq_partial(ln)
    h = rmsnorm(ln, x, cfg.norm_eps, impl)
    if tp is not None:
        h = collectives.region_in(h, sharded)
        if sharded:
            params = _tp_params(params, N, H, G, tp.group)
    Bsz, S, _ = h.shape
    z, xv, Bv, Cv, dt_raw = _projections(params, h)
    width = xv.shape[-1]                    # d_inner, or this rank's columns of it
    H_loc, G_loc = dt_raw.shape[-1], Bv.shape[-1] // N

    A = -torch.exp(params["A_log"].float())
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())

    new_state = None
    if mode == "decode":
        cbx, ox = _conv_step(state["conv_x"], xv[:, 0], params["conv_x"].to(xv.dtype))
        cbB, oB = _conv_step(state["conv_B"], Bv[:, 0], params["conv_B"].to(xv.dtype))
        cbC, oC = _conv_step(state["conv_C"], Cv[:, 0], params["conv_C"].to(xv.dtype))
        ox, oB, oC = F.silu(ox), F.silu(oB), F.silu(oC)
        xh = ox.reshape(Bsz, H, P).float()
        Bt = _expand_groups(oB.reshape(Bsz, 1, G, N), H)[:, 0].float()
        Ct = _expand_groups(oC.reshape(Bsz, 1, G, N), H)[:, 0].float()
        ssm, y_t = ssd_ops.ssd_step(state["ssm"], xh, dt[:, 0], A, Bt, Ct)
        y = y_t[:, None].to(x.dtype)                                   # (B,1,H,P)
        y = y + params["D"].to(x.dtype)[None, None, :, None] * xh[:, None].to(x.dtype)
        new_state = {"conv_x": cbx, "conv_B": cbB, "conv_C": cbC, "ssm": ssm}
    elif mode in ("train", "prefill"):
        ox = F.silu(_causal_conv(xv, params["conv_x"].to(xv.dtype)))
        oB = F.silu(_causal_conv(Bv, params["conv_B"].to(xv.dtype)))
        oC = F.silu(_causal_conv(Cv, params["conv_C"].to(xv.dtype)))
        xh = ox.reshape(Bsz, S, H_loc, P)
        Bm = oB.reshape(Bsz, S, G_loc, N)
        Cm = oC.reshape(Bsz, S, G_loc, N)
        y, final = ssd_ops.ssd(xh, dt, A, Bm, Cm, impl=impl)        # y in xh's dtype
        y = y + params["D"].to(x.dtype)[None, None, :, None] * xh
        if mode == "prefill":
            keep = cfg.conv_width - 1
            new_state = {"conv_x": _conv_tail(xv, keep), "conv_B": _conv_tail(Bv, keep),
                         "conv_C": _conv_tail(Cv, keep), "ssm": final}
    else:
        raise ValueError(f"unknown mode {mode!r}")

    y = y.reshape(Bsz, y.shape[1], width)
    y = gated_rmsnorm(params["gate_norm"], y, z[:, : y.shape[1]], cfg.norm_eps, impl)
    out = torch.matmul(y, params["w_out"].to(x.dtype))
    if tp is not None:
        out = collectives.region_out(out, sharded)
    return x + out, new_state


def stack_states(states: list[dict]) -> dict:
    """Per-layer prefill states -> one (L, ...) tensor per key."""
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


class Mamba2LM(nn.Module):
    """Pure-SSM LM (mamba2-2.7b).  ``impl="kernel"`` runs the hand-written
    CUDA kernels on CUDA tensors (their plain versions on CPU tensors);
    ``impl="ref"`` runs the plain PyTorch math everywhere."""

    def __init__(self, cfg: ModelConfig, impl: str = "kernel", device="cuda"):
        super().__init__()
        if impl not in ("kernel", "ref"):
            raise ValueError(f"unknown impl {impl!r}")
        self.cfg = cfg
        self.impl = impl
        self.device = resolve_device(device)

    # ---------------------------------------------------------- params
    def block_defs(self) -> dict:
        return mamba_block_defs(self.cfg)

    def param_defs(self) -> dict:
        cfg = self.cfg
        return {
            "embed": embedding.embed_defs(cfg),
            "blocks": stacked(self.block_defs(), cfg.num_layers),
            "final_norm": rmsnorm_defs(cfg.d_model),
        }

    def init(self, generator: torch.Generator, dtype: torch.dtype = torch.float32) -> dict:
        """Fresh parameters on the model's device (``generator`` lives there)."""
        return init_params(self.param_defs(), generator, self.device, dtype)

    def block_apply(self, params: dict, x: torch.Tensor, *, mode: str = "train",
                    cache: Optional[dict] = None, cache_index=None, kv_len=None):
        """The uniform block interface JAX's pipeline calls: (x, the layer's
        new state or None, an fp32 zero for the side loss), through
        ``mamba_block_apply``; ``cache_index`` and ``kv_len`` are unused."""
        out, state = mamba_block_apply(params, x, self.cfg, mode=mode, state=cache,
                                       impl=self.impl)
        return out, state, torch.zeros((), dtype=torch.float32, device=x.device)

    def _layers(self, params: dict) -> list[dict]:
        """Each layer's params: views of the stacked ``blocks`` (one unbind
        per leaf, so a backward stacks the layer grads once)."""
        return unstack_layers(params["blocks"])

    def _decode_layer(self, bp: dict, x: torch.Tensor, cache: dict, layer: int):
        """Mamba layer ``layer`` on one token per row; its new state is
        written into the stacked ``cache`` in place."""
        state = {k: v[layer] for k, v in cache.items()}
        x, new = mamba_block_apply(bp, x, self.cfg, mode="decode", state=state, impl=self.impl)
        for k, v in new.items():
            cache[k][layer].copy_(v)
        return x

    # ------------------------------------------------------------ forward
    def forward_train(self, params: dict, tokens: torch.Tensor, *, vis_embeds=None,
                      layer_runner=None, dtype=torch.bfloat16):
        """tokens (B, S) -> (fp32 logits (B, S, V), the runner's extra: fp32
        0.0, as JAX's).  ``layer_runner`` walks the stacked blocks, as in
        JAX; ``vis_embeds`` is accepted and unused, as in JAX."""
        runner = layer_runner or default_layer_runner
        x = embedding.embed_tokens(params["embed"], tokens, dtype, self.cfg.vocab_size)
        x = lc(x, "batch", "seq", "embed")

        def apply_block(bp, h):
            out, _ = mamba_block_apply(bp, h, self.cfg, mode="train", impl=self.impl)
            return out, 0.0

        x, extra = runner(params["blocks"], x, apply_block)
        x = rmsnorm(collectives.seq_partial(params["final_norm"]), x, self.cfg.norm_eps,
                    self.impl)
        return embedding.lm_head(params["embed"], x, self.cfg), extra

    # ------------------------------------------------------------ serving
    def _state_shapes(self, batch: int):
        cfg = self.cfg
        d_inner, H, G, N, P = _dims(cfg)
        W, L = cfg.conv_width, cfg.num_layers
        return {
            "conv_x": ((L, batch, W - 1, d_inner), torch.bfloat16),
            "conv_B": ((L, batch, W - 1, G * N), torch.bfloat16),
            "conv_C": ((L, batch, W - 1, G * N), torch.bfloat16),
            "ssm": ((L, batch, H, N, P), torch.float32),
        }

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
        """Zero decode state, as the JAX model makes it: conv buffers bf16
        and the SSD state fp32 whatever ``dtype`` says; ``max_len`` and
        ``dtype`` are kept for the uniform interface."""
        return {k: torch.zeros(s, dtype=d, device=self.device)
                for k, (s, d) in self._state_shapes(batch).items()}

    @torch.no_grad()
    def forward_prefill(self, params: dict, tokens: torch.Tensor, *,
                        max_len: Optional[int] = None, dtype=torch.bfloat16):
        """Full-prompt pass.  Returns (last-position fp32 logits (B, 1, V),
        cache {"conv_x","conv_B","conv_C": (L, B, W-1, C) in ``dtype``,
        "ssm": (L, B, H, N, P) fp32}); ``max_len`` is unused (the state is
        constant in context length)."""
        x = embedding.embed_tokens(params["embed"], tokens, dtype)
        states = []
        for bp in self._layers(params):
            x, st = mamba_block_apply(bp, x, self.cfg, mode="prefill", impl=self.impl)
            states.append(st)
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps, self.impl)
        logits = embedding.lm_head(params["embed"], x[:, -1:, :], self.cfg)
        return logits, stack_states(states)

    @torch.no_grad()
    def forward_decode(self, params: dict, tokens: torch.Tensor, cache: dict, cache_index, *,
                       kv_len=None, dtype=torch.bfloat16):
        """One token per row, tokens (B, 1).  The new state is written into
        ``cache`` in place; ``cache_index`` and ``kv_len`` are unused (the
        state carries the position).  Returns (fp32 logits (B, 1, V), cache)."""
        x = embedding.embed_tokens(params["embed"], tokens, dtype)
        for layer, bp in enumerate(self._layers(params)):
            x = self._decode_layer(bp, x, cache, layer)
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps, self.impl)
        return embedding.lm_head(params["embed"], x, self.cfg), cache

    def text_offset(self) -> int:
        """Positions before the text in ``forward_train``'s logits: none."""
        return 0
