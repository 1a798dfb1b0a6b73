"""Normalization layers (fp32 statistics, output in input dtype).

``impl="kernel"`` (the default) goes through ``kernels/rmsnorm/ops.py``'s
``rmsnorm_autograd``: the CUDA kernel on a CUDA tensor, its plain version on
a CPU tensor, and, when a grad is wanted, a backward that recomputes the
fp32 statistics from the saved input (the JAX package's no-save
``jax.checkpoint`` around its norm).
``impl="ref"`` is the plain PyTorch math of the JAX ``_rmsnorm`` on any
device — the comparison path only.

``gated_rmsnorm`` is Mamba2's gate norm ``rmsnorm(y * silu(z))``: with
nothing to differentiate (serving) it is one call of the gated kernel, which
reads y and z and writes the output; with a grad to take it is the
composition through ``rmsnorm_autograd``, so K2 still runs under autograd.
Under tensor parallelism the row is split: y and z hold this rank's
columns of ``d_inner`` and the scale is whole on every rank (its logical
axis is ``norm``, which TP does not shard).  There ``gated_rmsnorm`` takes
this rank's slice of the scale, its grad summed over the model axis
(``collectives.partial_grad``), and runs K2's split-row form
(``rmsnorm_split_autograd``): the statistics over the whole row, as
JAX's norm over the GSPMD-sharded row all-reduces its partial sums.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.kernels.rmsnorm.ref import gated_rmsnorm_reference, rmsnorm_reference
from repro_torch.models.common import ParamDef
from repro_torch.parallel import collectives


def rmsnorm_defs(dim: int) -> dict:
    return {"scale": ParamDef((dim,), ("norm",), init="ones")}


def _rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float, impl: str) -> torch.Tensor:
    if impl == "ref":
        return rmsnorm_reference(x, scale, eps)
    if impl != "kernel":
        raise ValueError(f"unknown impl {impl!r}")
    return rmsnorm_ops.rmsnorm_autograd(x.contiguous(), scale, eps)


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5, impl: str = "kernel") -> torch.Tensor:
    return _rmsnorm(params["scale"], x, eps, impl)


def gated_rmsnorm(params: dict, y: torch.Tensor, z: torch.Tensor, eps: float = 1e-5,
                  impl: str = "kernel") -> torch.Tensor:
    """``rmsnorm(y * silu(z))``, z of y's shape and dtype (JAX:
    ``rmsnorm(params, y * jax.nn.silu(z), eps)``).  y narrower than the
    scale: this rank's columns of a row split over the model axis."""
    scale = params["scale"]
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    width, cols = scale.shape[0], y.shape[-1]
    if cols < width:
        tp = collectives.tp_state()
        if tp is None or cols * tp.group.size != width:
            raise ValueError(f"gated_rmsnorm: {cols} of {width} columns, and the model axis "
                             f"is {None if tp is None else tp.group.size} ranks")
        scale_cols = collectives.partial_grad(scale).narrow(0, tp.group.index * cols, cols)
        return rmsnorm_ops.rmsnorm_split_autograd(y * F.silu(z), scale_cols, eps, width,
                                                  tp.group, plain=impl == "ref")
    if impl == "ref":
        return gated_rmsnorm_reference(y, z, scale, eps)
    if torch.is_grad_enabled() and (y.requires_grad or z.requires_grad or scale.requires_grad):
        return rmsnorm_ops.rmsnorm_autograd((y * F.silu(z)).contiguous(), scale, eps)
    return rmsnorm_ops.rmsnorm(y.contiguous(), scale, eps, gate=z.contiguous())


def head_rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5,
                 impl: str = "kernel") -> torch.Tensor:
    """qk-norm: normalize over the trailing head_dim."""
    return _rmsnorm(scale, x, eps, impl)
