"""Per-layer recomputation policies (the paper's extra parallel dimension);
the port of ``repro.parallel.remat`` on ``torch.utils.checkpoint``.

``none``      — save everything (fastest, most memory)
``selective`` — save only the outputs of plain matrix products (``aten.mm``
                and ``aten.addmm``: the q/k/v/out projections and the FFN,
                which the models write as 2-D matmuls) and recompute the
                rest: norms, rope, attention (its batched ``bmm`` products
                and softmax) and elementwise work.  The counterpart of JAX's
                ``dots_with_no_batch_dims_saveable``.
``full``      — save nothing inside the layer (recompute the whole layer)

Both recomputing policies use non-reentrant checkpointing, which reruns the
layer's forward on the first use of a saved tensor in the backward and may
stop as soon as every saved tensor is back.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def selective_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Save the outputs of 2-D matrix products; recompute everything else."""
    if op in _SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def apply_remat(fn, policy: str):
    """``fn`` wrapped so that its activations follow ``policy``."""
    if policy == "none":
        return fn
    if policy == "full":
        kw = {}
    elif policy == "selective":
        kw = {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                              selective_policy)}
    else:
        raise ValueError(f"unknown remat policy {policy!r}")

    @functools.wraps(fn)
    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped
