"""Feed-forward variants: SwiGLU (llama/qwen), squared-ReLU (nemotron), GELU.

Plain matrix products, as the JAX package leaves them to XLA.  Under
tensor parallelism ``w_in`` / ``w_gate`` hold this rank's ff columns and
``w_out`` its ff rows: the FFN is a region (``collectives.region_in`` /
``region_out``, JAX's ``lc`` sites on ``h`` and ``y``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.registry import ModelConfig
from repro_torch.models.common import ParamDef
from repro_torch.parallel import collectives


def ffn_defs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff if d_ff is not None else cfg.d_ff
    defs = {
        "w_in": ParamDef((d, f), ("embed", "ff"), cast=True),
        "w_out": ParamDef((f, d), ("ff", "embed"), cast=True),
    }
    if cfg.mlp_type in ("swiglu", "geglu"):
        defs["w_gate"] = ParamDef((d, f), ("embed", "ff"), cast=True)
    return defs


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def ffn_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
              d_ff: int | None = None) -> torch.Tensor:
    """``d_ff``: the FFN's whole width where it is not ``cfg.d_ff`` (the MoE
    shared expert's), which tells this rank's ff columns from all of them."""
    sharded = params["w_in"].shape[-1] < (d_ff or cfg.d_ff)
    x = collectives.region_in(x, sharded)
    h = torch.matmul(x, params["w_in"].to(x.dtype))
    if cfg.mlp_type in ("swiglu", "geglu"):
        g = torch.matmul(x, params["w_gate"].to(x.dtype))
        act = F.silu if cfg.mlp_type == "swiglu" else _gelu
        h = act(g) * h
    elif cfg.mlp_type == "relu2":
        r = F.relu(h)
        h = r * r
    elif cfg.mlp_type == "gelu":
        h = _gelu(h)
    else:
        raise ValueError(f"unknown mlp_type {cfg.mlp_type!r}")
    return collectives.region_out(torch.matmul(h, params["w_out"].to(x.dtype)), sharded)
