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
stop as soon as every saved tensor is back.  No block of the port draws
random numbers, so the checkpoint keeps no RNG state
(``preserve_rng_state=False``: the same numbers) and a grad through it
touches no generator when it is captured as a CUDA graph
(``core/profiler_model.block_steps``).
"""
from __future__ import annotations

import functools

import torch
# ``checkpoint`` imports torch._dynamo on its first call; that import runs
# ``torch.fx.wrap``, whose frame refers to itself, so every frame above it
# (the first train step's, with its parameters, grads and optimizer state)
# would stay alive until the cyclic collector runs.  Imported here, the
# chain above it is this module's import.
import torch._dynamo  # noqa: F401
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
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    return wrapped
