"""Token embedding and LM head (optionally tied)."""
from __future__ import annotations

import torch

from repro_torch.configs.registry import ModelConfig
from repro_torch.models.common import ParamDef


def embed_defs(cfg: ModelConfig) -> dict:
    defs = {"tok": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), init="small_normal")}
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return defs


def embed_tokens(params: dict, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Gather rows, then cast (the same values as casting the table first)."""
    return params["tok"][tokens].to(dtype)


def lm_head(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Returns fp32 logits (B, S, V), the product taken in x's dtype."""
    if cfg.tie_embeddings:
        w = params["tok"].to(x.dtype).T
    else:
        w = params["head"].to(x.dtype)
    return torch.matmul(x, w).float()
