"""Zamba2-style hybrid: a Mamba2 backbone plus one weight-SHARED attention
block applied after every ``attn_every`` Mamba layers (the port of
``repro.models.hybrid``).

zamba2-7b: 81 Mamba layers, ``attn_every`` 6 -> 13 application sites of the
shared block, then 3 trailing Mamba layers.  The shared block's parameters
are stored once (``params["shared_attn"]``); every site applies them.

The JAX model reshapes the stacked layers into (sites, attn_every) segments
and scans them; here one Python loop walks the 81 layers in the same order
and applies the shared block after layer ``attn_every·(s+1) - 1`` for site
s, so the trailing layers need no path of their own.

Decode state: the per-layer Mamba state of ``Mamba2LM`` (conv buffers bf16,
SSD state fp32 at ``init_cache``) and one KV cache per *site* (weights
shared, caches not): ``{"mamba": {...}, "attn": {"k","v": (sites, B,
max_len, KV, hd)}}``, the JAX layout.  ``forward_prefill`` writes each
site's K/V straight into a zeroed buffer of ``max_len`` rows in the compute
dtype (JAX pads each site's K/V to ``max_len``); ``forward_decode`` writes
the new state and K/V into ``cache`` in place, builds the flash kernel's
positions once per step and hands them to every site.  Prompts shorter than
``conv_width - 1`` keep ``Mamba2LM``'s left-padded conv buffers.

On a serving mesh (the step engine's rules, ``runtime/serve.py``) the
Mamba layers are ``Mamba2LM``'s serving regions and the shared block's
sites ``decoder_block_apply``'s, whose attention is a TP region; each
site's cache is laid out as the dense family's is: every KV head on every
rank of the model axis, its positions split over it where they divide
(``collectives.cache_seq_group``).  ``forward_prefill`` then keeps this
rank's slice of each site's positions, ``forward_decode`` builds K1's
positions with the slice's key offset and every site decodes by
flash-decode (``models/attention.py``), and ``init_cache`` sizes this
rank's shard of both halves.

Neither pass reads a tensor on the host (a 0-d tensor ``cache_index`` goes
to the positions and every site's cache write as a tensor), so
``jit_prefill_step`` / ``jit_decode_step`` capture them as CUDA graphs, K3
once per Mamba layer inside the prefill's; the nested cache is donated leaf
by leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.registry import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import embedding
from repro_torch.models.common import stacked, tree_map
from repro_torch.models.mamba2 import Mamba2LM, mamba_block_apply, mamba_block_defs, stack_states
from repro_torch.models.norms import rmsnorm, rmsnorm_defs
from repro_torch.models.transformer import (decoder_block_apply, decoder_block_defs,
                                             local_cache_dims)
from repro_torch.parallel import collectives
from repro_torch.parallel.axes import lc


class HybridLM(Mamba2LM):
    """``impl="kernel"`` runs K1, K2 and K3 on CUDA tensors (their plain
    versions on CPU tensors); ``impl="ref"`` runs the plain PyTorch math
    everywhere."""

    supports_layer_grouping = False  # the segment structure owns the stack layout

    def __init__(self, cfg: ModelConfig, impl: str = "kernel", device="cuda"):
        super().__init__(cfg, impl, device)
        if cfg.attn_every < 1:
            raise ValueError(f"{cfg.name}: the hybrid family needs attn_every >= 1, "
                             f"got {cfg.attn_every}")
        self.n_apps = cfg.num_layers // cfg.attn_every          # shared-block sites
        self.covered = self.n_apps * cfg.attn_every
        self.remainder = cfg.num_layers - self.covered

    # ---------------------------------------------------------- params
    def shared_block_defs(self) -> dict:
        return decoder_block_defs(self.cfg)

    def param_defs(self) -> dict:
        cfg = self.cfg
        return {
            "embed": embedding.embed_defs(cfg),
            "blocks": stacked(mamba_block_defs(cfg), cfg.num_layers),
            # stored ONCE and read at every site, so none of it is cast
            "shared_attn": tree_map(lambda d: dataclasses.replace(d, cast=False),
                                    self.shared_block_defs()),
            "final_norm": rmsnorm_defs(cfg.d_model),
        }

    # ---------------------------------------------------------- layers
    def _site(self, layer: int) -> Optional[int]:
        """The shared block's site that follows Mamba layer ``layer``, or None."""
        every = self.cfg.attn_every
        return (layer + 1) // every - 1 if (layer + 1) % every == 0 else None

    def _shared_apply(self, params: dict, x: torch.Tensor, *, mode: str, **kw):
        """The shared block at one site: (x, the attention's new cache)."""
        x, new_cache, _ = decoder_block_apply(params["shared_attn"], x, self.cfg, self.impl,
                                              mode=mode, **kw)
        return x, new_cache

    def _head(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps, self.impl)
        return embedding.lm_head(params["embed"], x, self.cfg)

    # ------------------------------------------------------------ forward
    def forward_train(self, params: dict, tokens: torch.Tensor, *, vis_embeds=None,
                      layer_runner=None, dtype=torch.bfloat16):
        """tokens (B, S) -> (fp32 logits (B, S, V), aux 0.0), differentiable.
        ``layer_runner`` is accepted and not used: JAX scans the Mamba
        segments and the shared block itself and takes no runner, so no
        remat policy applies to this family in either package.
        ``vis_embeds`` is unused, as in JAX.  On a mesh the embedding enters
        the boundary layout (``lc``) and the Mamba layers and the shared
        block are tensor-parallel regions of their own."""
        x = embedding.embed_tokens(params["embed"], tokens, dtype, self.cfg.vocab_size)
        x = lc(x, "batch", "seq", "embed")
        for layer, bp in enumerate(self._layers(params)):
            x, _ = mamba_block_apply(bp, x, self.cfg, mode="train", impl=self.impl)
            if self._site(layer) is not None:
                x, _ = self._shared_apply(params, x, mode="train")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        x = rmsnorm(collectives.seq_partial(params["final_norm"]), x, self.cfg.norm_eps,
                    self.impl)
        return embedding.lm_head(params["embed"], x, self.cfg), aux

    # ------------------------------------------------------------ serving
    def _kv_shape(self, batch: int, max_len: int) -> tuple[int, ...]:
        cfg = self.cfg
        return (self.n_apps, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
        """Zero decode state: ``Mamba2LM``'s per-layer state and one K/V
        cache per site in ``dtype``; under a serving mesh's rules this
        rank's shard of both (the sites' rows and positions as
        ``DenseTransformerLM.init_cache`` cuts them)."""
        shape = self._kv_shape(*local_cache_dims(batch, max_len))
        return {"mamba": super().init_cache(batch, max_len, dtype),
                "attn": {k: torch.zeros(shape, dtype=dtype, device=self.device)
                         for k in ("k", "v")}}

    def abstract_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
        return {"mamba": super().abstract_cache(batch, max_len, dtype),
                "attn": attn.abstract_kv_cache(self.cfg, batch, max_len, self.n_apps, dtype)}

    def cache_logical_axes(self) -> dict:
        return {
            "mamba": super().cache_logical_axes(),
            "attn": {"k": ("layers", "batch", "seq", "kv_heads", None),
                     "v": ("layers", "batch", "seq", "kv_heads", None)},
        }

    @torch.no_grad()
    def forward_prefill(self, params: dict, tokens: torch.Tensor, *,
                        max_len: Optional[int] = None, dtype=torch.bfloat16):
        """Full-prompt pass.  Returns (last-position fp32 logits (B, 1, V),
        cache {"mamba": the (L, B, ...) states, "attn": {"k","v": (sites, B,
        max_len, KV, hd)} in ``dtype``, rows past the prompt zero}).  Under a
        serving mesh's rules the logits are this rank's vocab columns and
        the cache its shard: each site's slice of the positions where
        ``cache_seq`` splits them."""
        x = embedding.embed_tokens(params["embed"], tokens, dtype, self.cfg.vocab_size)
        B, S = tokens.shape
        seq = collectives.cache_seq_group()
        positions = max_len or S
        if seq is not None:
            positions //= seq.size
        offset = 0 if seq is None else seq.index * positions
        kv = {k: torch.zeros(self._kv_shape(B, positions), dtype=x.dtype, device=x.device)
              for k in ("k", "v")}
        states = []
        for layer, bp in enumerate(self._layers(params)):
            x, st = mamba_block_apply(bp, x, self.cfg, mode="prefill", impl=self.impl)
            states.append(st)
            site = self._site(layer)
            if site is not None:
                x, new = self._shared_apply(params, x, mode="prefill")
                for k in ("k", "v"):
                    attn.write_cache_shard(kv[k][site], new[k], 0, offset)
        return self._head(params, x[:, -1:, :]), {"mamba": stack_states(states), "attn": kv}

    @torch.no_grad()
    def forward_decode(self, params: dict, tokens: torch.Tensor, cache: dict, cache_index, *,
                       kv_len: Optional[torch.Tensor] = None, dtype=torch.bfloat16):
        """One token per row, tokens (B, 1), written at ``cache_index`` (int
        or (B,)) with per-row valid lengths ``kv_len`` (default
        ``cache_index + 1``).  The new state and K/V are written into
        ``cache`` in place; returns (fp32 logits (B, 1, V), cache).  K1's
        positions are built once and shared by every site: on the kernel
        path, and over a sequence-sharded cache (flash-decode, keys from this
        rank's slice on) on either."""
        x = embedding.embed_tokens(params["embed"], tokens, dtype, self.cfg.vocab_size)
        kcache, vcache = cache["attn"]["k"], cache["attn"]["v"]
        positions = None
        seq = collectives.cache_seq_group()
        if attn.uses_kernel(self.impl, x) or seq is not None:
            B, Sq = tokens.shape
            S_l = kcache.shape[2]
            positions = attn.flash_positions(
                cache_index, Sq, S_l, attn.valid_lengths(cache_index, Sq, B, kv_len, x.device),
                B, x.device, k_offset=seq.index * S_l if seq is not None else 0)
        for layer, bp in enumerate(self._layers(params)):
            x = self._decode_layer(bp, x, cache["mamba"], layer)
            site = self._site(layer)
            if site is not None:
                x, _ = self._shared_apply(
                    params, x, mode="decode", cache={"k": kcache[site], "v": vcache[site]},
                    cache_index=cache_index, kv_len=kv_len, positions=positions)
        return self._head(params, x), cache
