"""Decoder-only transformer LM: the dense family, the base class of the
MoE family (``models/moe.py``), which swaps the FFN through the
``ffn_defs``/``ffn_apply`` hook as JAX's does (training and serving passes),
and the VLM family (``VLMTransformerLM``: the same tree, with stub patch
embeddings ``vis_embeds`` (B, Sv, D) prepended to the token embeddings in
``forward_train`` and ``forward_prefill``; decode embeds tokens only).

The parameters are a nested dict of tensors with the JAX package's keys and
stacked ``blocks`` (leading layer dim); the forward passes take that dict
explicitly, so weights from JAX (``params_from_jax``) and the port's own
initialiser are interchangeable.  The JAX ``lax.scan`` over layers is a
Python loop over the stacked tensors.

``forward_decode`` accepts ``cache_index`` as an int, a 0-d tensor or a
``(B,)`` tensor: the per-slot form is the written-out ``vmap`` of the JAX
scheduler — each slot gets its own rope positions, cache write position and
causal offset.  A tensor is never read on the host, so the step can be
captured as a CUDA graph (``runtime/compiled.py``); it gives the int form's
logits bitwise.

``forward_train`` is differentiable: gradients reach the fp32 master leaves
through the ``.to(dtype)`` casts, and the tied ``embed.tok`` from both the
gather and the head.  Its layer loop is a ``layer_runner`` (the runtime's
applies each layer's remat policy); ``default_layer_runner`` is the plain
loop in place of JAX's ``lax.scan``.  Each block returns the FFN's fp32
side loss (``extra``: the MoE router's aux loss, 0.0 for the dense FFN);
``forward_train`` sums it over the layers, the serving passes drop it.

Under tensor parallelism (training on a mesh) the attention and the FFN are
regions of their own (``models/attention.py``, ``models/ffn.py``); the
residual stream between them holds the boundary layout, sequence shards
under sequence parallelism, where the norms' scales get their grads summed
over the model axis (``collectives.seq_partial``).  ``forward_train`` moves
the embedding to that layout (``lc``: JAX's ``lc(x, "batch", "seq",
"embed")``), and the head back to the whole sequence.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.registry import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import embedding, ffn
from repro_torch.models.common import (init_params, resolve_device, stacked, take_layer,
                                       unstack_layers)
from repro_torch.models.norms import rmsnorm, rmsnorm_defs
from repro_torch.parallel import collectives
from repro_torch.parallel.axes import lc


def default_layer_runner(stacked_params: dict, x: torch.Tensor, apply_block):
    """``apply_block(layer_params, h) -> (h, extra)`` over the stacked
    layers; extra (fp32 scalar, e.g. an MoE aux loss) adds up."""
    extra = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer_params in unstack_layers(stacked_params):
        x, e = apply_block(layer_params, x)
        extra = extra + e
    return x, extra


def decoder_block_defs(cfg: ModelConfig) -> dict:
    """One pre-norm decoder block: RMSNorm -> attention -> RMSNorm -> FFN."""
    return {
        "ln1": rmsnorm_defs(cfg.d_model),
        "attn": attn.attn_defs(cfg),
        "ln2": rmsnorm_defs(cfg.d_model),
        "mlp": ffn.ffn_defs(cfg),
    }


def dense_ffn_apply(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """The dense FFN as an FFN hook: (y, 0.0), having no side loss."""
    return ffn.ffn_apply(params, x, cfg), 0.0


def decoder_block_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, impl: str, *,
                        mode: str, cache: Optional[dict] = None, cache_index=None,
                        kv_len=None, positions=None, ffn_apply=None):
    """``decoder_block_defs``' block on x (B, S, D): ln1 -> attention ->
    residual -> ln2 -> FFN -> residual.  ``ffn_apply(params["mlp"], h) ->
    (y, extra)`` replaces the dense FFN (the MoE family's hook).  Returns
    (x, the attention's new cache (see ``attention.attention_block``), the
    FFN's fp32 side loss: 0.0 for the dense FFN)."""
    h = rmsnorm(collectives.seq_partial(params["ln1"]), x, cfg.norm_eps, impl)
    a, new_cache = attn.attention_block(
        params["attn"], h, cfg=cfg, mode=mode, cache=cache,
        cache_index=cache_index, kv_len=kv_len, impl=impl, positions=positions)
    x = x + a
    h = rmsnorm(collectives.seq_partial(params["ln2"]), x, cfg.norm_eps, impl)
    if ffn_apply is None:
        y, extra = dense_ffn_apply(params["mlp"], h, cfg)
    else:
        y, extra = ffn_apply(params["mlp"], h)
    return x + y, new_cache, extra


class DenseTransformerLM(nn.Module):
    """``impl="kernel"`` runs the hand-written CUDA kernels on CUDA tensors
    (their plain versions on CPU tensors); ``impl="ref"`` runs the plain
    PyTorch math everywhere — the comparison path."""

    def __init__(self, cfg: ModelConfig, impl: str = "kernel", device="cuda"):
        super().__init__()
        if impl not in ("kernel", "ref"):
            raise ValueError(f"unknown impl {impl!r}")
        self.cfg = cfg
        self.impl = impl
        self.device = resolve_device(device)

    # ---------------------------------------------------------- params
    def block_defs(self) -> dict:
        return {**decoder_block_defs(self.cfg), "mlp": self.ffn_defs()}

    def ffn_defs(self) -> dict:
        return ffn.ffn_defs(self.cfg)

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

    # ---------------------------------------------------------- blocks
    def ffn_apply(self, params: dict, x: torch.Tensor):
        """(y, extra): the FFN's output and its fp32 side loss (0.0 here)."""
        return dense_ffn_apply(params, x, self.cfg)

    def block_apply(self, params: dict, x: torch.Tensor, *, mode: str,
                    cache: Optional[dict] = None, cache_index=None, kv_len=None,
                    positions=None):
        """(x, new cache, extra); see ``decoder_block_apply``."""
        return decoder_block_apply(params, x, self.cfg, self.impl, mode=mode, cache=cache,
                                   cache_index=cache_index, kv_len=kv_len,
                                   positions=positions, ffn_apply=self.ffn_apply)

    # ---------------------------------------------------------- training
    def _embed_inputs(self, params: dict, tokens: torch.Tensor,
                      vis_embeds: Optional[torch.Tensor] = None, dtype=torch.bfloat16):
        """Token embeddings (B, S, D), with ``vis_embeds`` (B, Sv, D) cast to
        ``dtype`` and prepended along the sequence when given."""
        x = embedding.embed_tokens(params["embed"], tokens, dtype, self.cfg.vocab_size)
        if vis_embeds is not None:
            x = torch.cat([vis_embeds.to(dtype), x], dim=1)
        return x

    def forward_train(self, params: dict, tokens: torch.Tensor, *,
                      vis_embeds: Optional[torch.Tensor] = None, layer_runner=None,
                      dtype=torch.bfloat16):
        """tokens (B, S) -> (fp32 logits (B, Sv + S, V), extra fp32 scalar);
        Sv = 0 without ``vis_embeds``."""
        runner = layer_runner or default_layer_runner
        x = lc(self._embed_inputs(params, tokens, vis_embeds, dtype), "batch", "seq", "embed")

        def apply_block(bp, h):
            out, _, extra = self.block_apply(bp, h, mode="train")
            return out, extra

        x, extra = runner(params["blocks"], x, apply_block)
        x = rmsnorm(collectives.seq_partial(params["final_norm"]), x, self.cfg.norm_eps,
                    self.impl)
        return embedding.lm_head(params["embed"], x, self.cfg), extra

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}

    @torch.no_grad()
    def forward_prefill(self, params: dict, tokens: torch.Tensor, *,
                        max_len: Optional[int] = None,
                        vis_embeds: Optional[torch.Tensor] = None, dtype=torch.bfloat16):
        """Full-sequence pass that also materialises the KV cache (padded to
        ``max_len``).  ``vis_embeds`` (B, Sv, D) takes the first Sv
        positions, so the cache must hold Sv + S + the tokens to decode.
        Returns (last-position fp32 logits (B, 1, V), cache {"k","v": (L, B,
        max_len, KV, hd)})."""
        cfg = self.cfg
        x = self._embed_inputs(params, tokens, vis_embeds, dtype)
        S = x.shape[1]
        max_len = max_len or S
        ks, vs = [], []
        for layer in range(cfg.num_layers):
            x, kv, _ = self.block_apply(take_layer(params["blocks"], layer), x,
                                        mode="prefill")
            pad = (0, 0, 0, 0, 0, max_len - S)
            ks.append(torch.nn.functional.pad(kv["k"], pad))
            vs.append(torch.nn.functional.pad(kv["v"], pad))
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps, self.impl)
        logits = embedding.lm_head(params["embed"], x[:, -1:, :], cfg)
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}

    @torch.no_grad()
    def forward_decode(self, params: dict, tokens: torch.Tensor, cache: dict, cache_index, *,
                       kv_len: Optional[torch.Tensor] = None, dtype=torch.bfloat16):
        """tokens (B, Sq) at write position ``cache_index`` (int, 0-d or (B,)),
        cache {"k","v": (L, B, S_max, KV, hd)}.  The new k/v are written into
        ``cache`` in place; returns (fp32 logits (B, Sq, V), cache).  On the
        kernel path the attention kernel's positions are built once here and
        shared by every layer."""
        cfg = self.cfg
        x = embedding.embed_tokens(params["embed"], tokens, dtype)
        positions = None
        if attn.uses_kernel(self.impl, x):
            B, Sq = tokens.shape
            positions = attn.flash_positions(
                cache_index, Sq, cache["k"].shape[2],
                attn.valid_lengths(cache_index, Sq, B, kv_len, x.device), B, x.device)
        for layer in range(cfg.num_layers):
            layer_cache = {"k": cache["k"][layer], "v": cache["v"][layer]}
            x, _, _ = self.block_apply(take_layer(params["blocks"], layer), x,
                                       mode="decode", cache=layer_cache,
                                       cache_index=cache_index, kv_len=kv_len,
                                       positions=positions)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps, self.impl)
        return embedding.lm_head(params["embed"], x, cfg), cache

    def text_offset(self) -> int:
        """Positions before the text in ``forward_train``'s logits: none."""
        return 0


class VLMTransformerLM(DenseTransformerLM):
    """InternVL2-style: the LM backbone reading stub patch embeddings
    (``vis_embeds``, ``cfg.vis_tokens`` positions) as a prefix; the
    parameter tree is the dense one."""

    def text_offset(self) -> int:
        """The prefix positions ``loss_fn`` slices off the train logits."""
        return self.cfg.vis_tokens
