"""Whisper-style encoder-decoder (the port of ``repro.models.encdec``).  The
conv/mel frontend is a stub, as in JAX: the encoder's inputs are
precomputed frame embeddings (B, enc_frames, d_model).

Encoder: per layer RMSNorm (K2) -> non-causal self-attention with RoPE at
``arange(F)`` (K1) -> RMSNorm (K2) -> FFN, then ``enc_norm``.  Decoder: per
layer RMSNorm -> causal self-attention -> RMSNorm (``ln_x``) ->
cross-attention over the encoder output (no RoPE, no mask) -> RMSNorm ->
FFN, then ``final_norm`` and the head.  Serving keeps a self-attention KV
cache and the cross-attention K/V computed once at prefill.

On a mesh (training) the encoder's attention and FFN, and the decoder's
self-attention, cross-attention and FFN, are tensor-parallel regions
(``models/attention.py``, ``models/ffn.py``); the frames and the decoder's
embedding enter the boundary layout (``lc``: JAX's ``lc(frames, "batch",
"seq", "embed")``), every norm between the regions takes ``seq_partial``
(it runs on sequence shards under sequence parallelism), each
cross-attention region gathers the encoder output it reads, and the head
gathers the sequence back, as the dense head does.

The parameters are JAX's tree key for key (``embed``, ``enc_blocks``,
``enc_norm``, ``dec_blocks``, ``final_norm``; stacked layers), so
``params_from_jax`` carries weights across unchanged.  ``frames=None``
means zeros, as in JAX: with this config's bias-free RMSNorm blocks every
encoder layer then outputs 0, so a check of the encoder feeds real frames.

Neither serving pass reads a tensor on the host: fed frames already in the
pass's dtype are used in place, and decode reads the cross cache where it
lies (a layer's slice is contiguous, so no copy) and writes only the
self-attention cache.  So ``jit_prefill_step`` (the encoder inside the
graph) and ``jit_decode_step`` capture them as CUDA graphs.
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
from repro_torch.parallel.axes import lc
from repro_torch.parallel.collectives import seq_partial


class EncDecLM(nn.Module):
    """``impl="kernel"`` runs the CUDA kernels on CUDA tensors (their plain
    versions on CPU tensors); ``impl="ref"`` the plain PyTorch math."""

    supports_layer_grouping = False  # two stacks + cross-attention; one strategy

    def __init__(self, cfg: ModelConfig, impl: str = "kernel", device="cuda"):
        super().__init__()
        if impl not in ("kernel", "ref"):
            raise ValueError(f"unknown impl {impl!r}")
        self.cfg = cfg
        self.impl = impl
        self.device = resolve_device(device)

    # ------------------------------------------------------------ params
    def enc_block_defs(self) -> dict:
        cfg = self.cfg
        return {
            "ln1": rmsnorm_defs(cfg.d_model),
            "attn": attn.attn_defs(cfg),
            "ln2": rmsnorm_defs(cfg.d_model),
            "mlp": ffn.ffn_defs(cfg),
        }

    def dec_block_defs(self) -> dict:
        cfg = self.cfg
        return {
            "ln1": rmsnorm_defs(cfg.d_model),
            "self_attn": attn.attn_defs(cfg),
            "ln_x": rmsnorm_defs(cfg.d_model),
            "cross_attn": attn.attn_defs(cfg, cross=True),
            "ln2": rmsnorm_defs(cfg.d_model),
            "mlp": ffn.ffn_defs(cfg),
        }

    def param_defs(self) -> dict:
        cfg = self.cfg
        return {
            "embed": embedding.embed_defs(cfg),
            "enc_blocks": stacked(self.enc_block_defs(), cfg.enc_layers),
            "enc_norm": rmsnorm_defs(cfg.d_model),
            "dec_blocks": stacked(self.dec_block_defs(), cfg.num_layers),
            "final_norm": rmsnorm_defs(cfg.d_model),
        }

    def init(self, generator: torch.Generator, dtype: torch.dtype = torch.float32) -> dict:
        """Fresh parameters on the model's device (``generator`` lives there)."""
        return init_params(self.param_defs(), generator, self.device, dtype)

    # ------------------------------------------------------------ encoder
    def encode(self, params: dict, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, F, D) stub embeddings -> encoder output (B, F, D); on a
        mesh, in the boundary layout (this rank's frames under sequence
        parallelism)."""
        cfg = self.cfg
        x = lc(frames, "batch", "seq", "embed")
        for lp in unstack_layers(params["enc_blocks"]):
            h = rmsnorm(seq_partial(lp["ln1"]), x, cfg.norm_eps, self.impl)
            a, _ = attn.attention_block(lp["attn"], h, cfg=cfg, mode="encoder", impl=self.impl)
            x = x + a
            h = rmsnorm(seq_partial(lp["ln2"]), x, cfg.norm_eps, self.impl)
            x = x + ffn.ffn_apply(lp["mlp"], h, cfg)
        return rmsnorm(seq_partial(params["enc_norm"]), x, cfg.norm_eps, self.impl)

    def _frames(self, frames, batch: int, dtype) -> torch.Tensor:
        """The encoder's input in ``dtype``; None means zeros, as in JAX."""
        if frames is None:
            cfg = self.cfg
            return torch.zeros((batch, cfg.enc_frames, cfg.d_model), dtype=dtype,
                               device=self.device)
        return frames.to(self.device, dtype)

    # ------------------------------------------------------------ decoder block
    def _dec_block(self, lp: dict, x: torch.Tensor, enc_out, *, mode: str,
                   self_cache=None, cross_cache=None, cache_index=None, kv_len=None,
                   positions=None):
        """(x, the self-attention's new cache, the cross-attention's)."""
        cfg = self.cfg
        h = rmsnorm(seq_partial(lp["ln1"]), x, cfg.norm_eps, self.impl)
        a, new_self = attn.attention_block(
            lp["self_attn"], h, cfg=cfg, mode=mode, cache=self_cache,
            cache_index=cache_index, kv_len=kv_len, impl=self.impl, positions=positions)
        x = x + a
        h = rmsnorm(seq_partial(lp["ln_x"]), x, cfg.norm_eps, self.impl)
        # no kv_len: every encoder frame is valid (JAX passes none either)
        a, new_cross = attn.attention_block(
            lp["cross_attn"], h, cfg=cfg, mode=mode, cache=cross_cache,
            kv_source=enc_out, cross=True, impl=self.impl)
        x = x + a
        h = rmsnorm(seq_partial(lp["ln2"]), x, cfg.norm_eps, self.impl)
        return x + ffn.ffn_apply(lp["mlp"], h, cfg), new_self, new_cross

    # ------------------------------------------------------------ training
    def forward_train(self, params: dict, tokens: torch.Tensor, *, frames=None,
                      layer_runner=None, dtype=torch.bfloat16):
        """tokens (B, S) decoder input, frames (B, F, D) -> (fp32 logits
        (B, S, V), fp32 0.0).  ``layer_runner`` is accepted and ignored, as
        JAX's scans both stacks itself: no remat policy applies to this
        family in either package."""
        x_enc = self._frames(frames, tokens.shape[0], dtype)
        enc_out = self.encode(params, x_enc)
        x = embedding.embed_tokens(params["embed"], tokens, dtype, self.cfg.vocab_size)
        x = lc(x, "batch", "seq", "embed")
        for lp in unstack_layers(params["dec_blocks"]):
            x, _, _ = self._dec_block(lp, x, enc_out, mode="train")
        x = rmsnorm(seq_partial(params["final_norm"]), x, self.cfg.norm_eps, self.impl)
        extra = torch.zeros((), dtype=torch.float32, device=x.device)
        return embedding.lm_head(params["embed"], x, self.cfg), extra

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
        cfg = self.cfg

        def kv(length):
            shape = (cfg.num_layers, batch, length, cfg.num_kv_heads, cfg.resolved_head_dim)
            return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                    "v": torch.zeros(shape, dtype=dtype, device=self.device)}

        return {"self": kv(max_len), "cross": kv(cfg.enc_frames)}

    def abstract_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
        cfg = self.cfg
        return {
            "self": attn.abstract_kv_cache(cfg, batch, max_len, cfg.num_layers, dtype),
            "cross": attn.abstract_kv_cache(cfg, batch, cfg.enc_frames, cfg.num_layers, dtype),
        }

    def cache_logical_axes(self) -> dict:
        kv = {"k": ("layers", "batch", "seq", "kv_heads", None),
              "v": ("layers", "batch", "seq", "kv_heads", None)}
        return {"self": kv, "cross": dict(kv)}

    @torch.no_grad()
    def forward_prefill(self, params: dict, tokens: torch.Tensor, *, frames=None,
                        max_len: Optional[int] = None, dtype=torch.bfloat16):
        """Encode ``frames``, then a full decoder pass that fills the caches.
        Returns (last-position fp32 logits (B, 1, V), {"self": {"k","v": (L,
        B, max_len, KV, hd)}, "cross": {"k","v": (L, B, F, KV, hd)}})."""
        cfg = self.cfg
        B, S = tokens.shape
        max_len = max_len or S
        enc_out = self.encode(params, self._frames(frames, B, dtype))
        x = embedding.embed_tokens(params["embed"], tokens, dtype)
        pad = (0, 0, 0, 0, 0, max_len - S)
        caches = {"self": {"k": [], "v": []}, "cross": {"k": [], "v": []}}
        for layer in range(cfg.num_layers):
            x, new_self, new_cross = self._dec_block(
                take_layer(params["dec_blocks"], layer), x, enc_out, mode="prefill")
            for name in ("k", "v"):
                caches["self"][name].append(torch.nn.functional.pad(new_self[name], pad))
                caches["cross"][name].append(new_cross[name])
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps, self.impl)
        logits = embedding.lm_head(params["embed"], x[:, -1:, :], cfg)
        return logits, {kind: {name: torch.stack(ts) for name, ts in kv.items()}
                        for kind, kv in caches.items()}

    @torch.no_grad()
    def forward_decode(self, params: dict, tokens: torch.Tensor, cache: dict, cache_index, *,
                       kv_len: Optional[torch.Tensor] = None, dtype=torch.bfloat16):
        """tokens (B, Sq) at write position ``cache_index`` (int or (B,)).
        The new self-attention k/v are written into ``cache`` in place;
        returns (fp32 logits (B, Sq, V), cache).  On the kernel path the
        self-attention's positions are built once here for every layer."""
        cfg = self.cfg
        x = embedding.embed_tokens(params["embed"], tokens, dtype)
        positions = None
        if attn.uses_kernel(self.impl, x):
            B, Sq = tokens.shape
            positions = attn.flash_positions(
                cache_index, Sq, cache["self"]["k"].shape[2],
                attn.valid_lengths(cache_index, Sq, B, kv_len, x.device), B, x.device)
        for layer in range(cfg.num_layers):
            x, _, _ = self._dec_block(
                take_layer(params["dec_blocks"], layer), x, None, mode="decode",
                self_cache={"k": cache["self"]["k"][layer], "v": cache["self"]["v"][layer]},
                cross_cache={"k": cache["cross"]["k"][layer], "v": cache["cross"]["v"][layer]},
                cache_index=cache_index, kv_len=kv_len, positions=positions)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps, self.impl)
        return embedding.lm_head(params["embed"], x, cfg), cache

    def text_offset(self) -> int:
        return 0
