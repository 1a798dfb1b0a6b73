"""Token embedding and LM head (optionally tied).

Under tensor parallelism (``parallel.collectives.tp_state``) a table whose
vocab dim is sharded over the model axis holds this rank's rows: the lookup
masks tokens outside them and all-reduces, and the head's logits stay
vocab-sharded, as JAX's ``lc(logits, "batch", None, "vocab")`` says.  A
table that ``spec_for_shape`` leaves whole (a vocab the model axis does not
divide) is used whole on every rank.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.registry import ModelConfig
from repro_torch.models.common import ParamDef
from repro_torch.parallel import collectives


def embed_defs(cfg: ModelConfig) -> dict:
    # the table is not cast: the lookup's grad sums a repeated token's rows
    defs = {"tok": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), init="small_normal")}
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab"), cast=True)
    return defs


def embed_tokens(params: dict, tokens: torch.Tensor, dtype=torch.bfloat16,
                 vocab_size: Optional[int] = None) -> torch.Tensor:
    """Gather rows, then cast (the same values as casting the table first).
    Given ``vocab_size``, a table of fewer rows under tensor parallelism is
    this rank's vocab shard: every rank gets the whole (B, S, D) lookup."""
    table = params["tok"]
    tp = collectives.tp_state()
    if tp is None or vocab_size is None or table.shape[0] == vocab_size:
        return table[tokens].to(dtype)
    rows = table.shape[0]
    local = tokens - tp.group.index * rows
    inside = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)] * inside.unsqueeze(-1)
    return collectives.reduce_from(x, tp.group).to(dtype)


def lm_head(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Returns fp32 logits (B, S, V), the product taken in x's dtype; this
    rank's vocab columns (B, S, V / tp) when the table is vocab-sharded."""
    if cfg.tie_embeddings:
        w = params["tok"].to(x.dtype).T
    else:
        w = params["head"].to(x.dtype)
    x = collectives.region_in(x, sharded=w.shape[1] < cfg.vocab_size)
    return torch.matmul(x, w).float()
