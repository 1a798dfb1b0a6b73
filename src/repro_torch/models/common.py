"""Parameter-definition machinery (the port's counterpart of
``repro.models.common``).

A model declares its parameters as a nested dict of :class:`ParamDef` (shape,
logical axes, init rule) and consumes the matching nested dict of tensors.
The tree keys, shapes and stacked ``blocks`` layout are the JAX package's, so
:func:`params_from_jax` can hand JAX-initialised weights to the port and
every parity test compares the two packages on the same weights.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import numpy as np
import torch

# Logical axis vocabulary (same names as the JAX package).
LOGICAL_AXES = (
    "layers", "vocab", "embed", "q_heads", "kv_heads", "head_dim", "ff",
    "experts", "ssm_inner", "ssm_heads", "ssm_state", "ssm_groups", "conv",
    "norm", "stages",
)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    there is none — no entry point quietly moves to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions on the CPU")
    return dev


#: The most elements of one fp32 draw (1 GiB); a larger leaf is drawn in pieces.
DRAW_ELEMENTS = 1 << 28


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative description of one parameter tensor."""

    shape: tuple[int, ...]
    logical_axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones | small_normal
    scale: float | None = None    # stddev override for normal inits
    # the layers read this leaf once, through ``.to(<the forward's dtype>)``,
    # so a ZeRO-3 gather may move it in that dtype (runtime/train.py); a
    # leaf read at several sites is not cast, as its grads sum in fp32
    cast: bool = False

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(
                f"shape {self.shape} vs logical_axes {self.logical_axes} rank mismatch")
        for ax in self.logical_axes:
            if ax is not None and ax not in LOGICAL_AXES:
                raise ValueError(f"unknown logical axis {ax!r}")

    def num_params(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def std(self) -> float:
        """The normal init's stddev — the same rule as the JAX ParamDef."""
        if self.init == "small_normal":
            return 0.02
        if self.scale is not None:
            return self.scale
        fan_in = self.shape[-2] if len(self.shape) >= 2 else max(self.shape[-1], 1)
        return 1.0 / math.sqrt(max(fan_in, 1))

    def materialize(self, generator: torch.Generator, device: torch.device,
                    dtype: torch.dtype) -> torch.Tensor:
        """The leaf in ``dtype``, drawn in fp32 into a preallocated tensor of
        ``dtype`` in pieces of at most ``DRAW_ELEMENTS`` (its flat layout, in
        order), each cast as it lands, so the fp32 draw never exists whole:
        moonshot's stacked ``w_out`` alone would be a 35 GB fp32 draw beside
        the bf16 model.  A leaf of one piece gets the values of a draw of
        its own shape."""
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        std = self.std()
        n = self.num_params()
        out = torch.empty(self.shape, dtype=dtype, device=device)
        flat = out.view(-1)
        for start in range(0, n, DRAW_ELEMENTS):
            piece = torch.randn((min(DRAW_ELEMENTS, n - start),), generator=generator,
                                device=device, dtype=torch.float32)
            flat[start:start + piece.numel()].copy_(piece.mul_(std))
        return out


ParamTree = dict  # nested dict[str, ParamDef | ParamTree] / dict[str, Tensor | ...]


def tree_paths(defs: ParamTree, prefix: tuple[str, ...] = ()) -> list[tuple[tuple[str, ...], Any]]:
    """Sorted (path, leaf) pairs of a nested dict."""
    out = []
    for k in sorted(defs):
        v = defs[k]
        if isinstance(v, Mapping):
            out.extend(tree_paths(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def tree_leaves(tree: ParamTree) -> list:
    """The leaves of a nested dict, in sorted path order."""
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn, *trees: ParamTree) -> ParamTree:
    """``fn`` over the leaves of nested dicts of one structure."""
    first = trees[0]
    return {k: (tree_map(fn, *(t[k] for t in trees)) if isinstance(first[k], Mapping)
                else fn(*(t[k] for t in trees))) for k in first}


def init_params(defs: ParamTree, generator: torch.Generator, device,
                dtype: torch.dtype = torch.float32) -> ParamTree:
    """Materialise a nested dict of ParamDefs on ``device``, drawing from
    ``generator`` (which must live on that device) in sorted path order.
    Each tensor is drawn in fp32 and cast to ``dtype`` one at a time, a
    large one piece by piece (``ParamDef.materialize``), so a bf16 model's
    peak is the bf16 model plus one piece of at most 1 GiB."""
    dev = resolve_device(device)
    values = {path: d.materialize(generator, dev, dtype)
              for path, d in tree_paths(defs)}
    return _nest(defs, values, ())


def abstract_params(defs: ParamTree, dtype: torch.dtype = torch.float32) -> ParamTree:
    """``init_params``' tree as tensors on the ``meta`` device: each leaf's
    shape in ``dtype`` (the fp32 masters by default), nothing allocated or
    drawn.  The dry run builds its traced inputs from it."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=dtype, device="meta"), defs)


def _nest(defs: ParamTree, values: dict, prefix: tuple[str, ...]) -> ParamTree:
    """``defs``' nesting with the leaf at each path taken from ``values``.
    A module-level function: a nested one that calls itself sits in a
    reference cycle with its closure, which kept ``values`` — every freshly
    drawn parameter — alive until the cyclic collector ran."""
    return {k: (_nest(v, values, prefix + (k,)) if isinstance(v, Mapping)
                else values[prefix + (k,)]) for k, v in defs.items()}


def params_from_jax(tree: Mapping, device, dtype: torch.dtype = torch.float32) -> ParamTree:
    """The JAX parameter tree (leaves as numpy arrays, any float dtype incl.
    ml_dtypes bfloat16) -> the port's tree: same keys, same shapes (stacked
    ``blocks`` with a leading layer dim, ``wq (d,h,hd)``, ``wo (h,hd,d)`` …),
    on ``device`` in ``dtype``."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(          # np.array copies: the
        np.array(a, np.float32)).to(dev, dtype), tree)    # tensor owns its memory


def count_params(defs: ParamTree) -> int:
    return sum(d.num_params() for _, d in tree_paths(defs))


def cast_tree(params: ParamTree, dtype: torch.dtype) -> ParamTree:
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, params)


def stacked(defs: ParamTree, num: int) -> ParamTree:
    """Prepend a ``layers`` dim of size ``num`` to every ParamDef."""
    return tree_map(lambda v: dataclasses.replace(
        v, shape=(num,) + v.shape, logical_axes=("layers",) + v.logical_axes), defs)


def take_layer(params: ParamTree, idx: int) -> ParamTree:
    """One layer of a stacked param tree (views, no copy)."""
    return tree_map(lambda x: x[idx], params)


def unstack_layers(params: ParamTree) -> list[ParamTree]:
    """Every layer of a stacked param tree (views, no copy), by one
    ``torch.unbind`` per leaf: its backward stacks the per-layer grads into
    one stacked grad, where indexing layer by layer would add up one
    zero-filled stacked grad per layer."""
    parts = {id(x): torch.unbind(x, 0) for x in tree_leaves(params)}
    num = len(next(iter(parts.values())))
    return [tree_map(lambda x: parts[id(x)][i], params) for i in range(num)]
