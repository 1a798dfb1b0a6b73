"""Training runtime on one device (the single-device part of
``repro.runtime.train``).

``construct_hybrid_parallel_model`` (named after the paper's API) takes a
model and an :class:`ExecutionPlan` and returns a :class:`HybridParallelModel`
whose ``train_step(params, opt_state, batch)`` applies the plan: each
layer's remat policy from ``plan.layer_strategies``, gradient accumulation
over ``plan.grad_accum`` microbatches (the mean of their losses and grads,
summed in fp32), then AdamW.  Parameters keep the canonical stacked
``blocks`` tree; grouping them by strategy is a sharding concern of the
parallel runtime.

One device only: a mesh, or a plan that spans more than one device (a mesh
shape of more than one device, or tp, cp, ep or pp above 1), raises
``NotImplementedError``.  ZeRO stages are accepted: over one device they
shard nothing.  Nothing is compiled (``jit_train_step`` returns the eager
step), and the checkpoint hooks wait for the checkpointing slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.strategy import ExecutionPlan
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.transformer import default_layer_runner
from repro_torch.parallel.remat import apply_remat
from repro_torch.runtime import optimizer as opt_lib

AUX_LOSS_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-4


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor):
    """logits (B,S,V) fp32; labels (B,S) int, -1 = masked.  Returns (mean
    nll + z-loss, metrics dict).  The label logit is a ``gather`` at the
    clamped label, then masked: on one device this is exactly the JAX
    package's iota-masked sum, without a (B,S,V) mask or temporary."""
    valid = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp(min=0).long().unsqueeze(-1)).squeeze(-1)
    nll = (lse - ll) * valid
    denom = torch.clamp(valid.sum(), min=1.0)
    loss = nll.sum() / denom
    zloss = Z_LOSS_WEIGHT * torch.sum(torch.square(lse) * valid) / denom
    return loss + zloss, {"nll": loss, "zloss": zloss, "tokens": valid.sum()}


# --------------------------------------------------------------------------
# layer runner (per-layer remat)
# --------------------------------------------------------------------------

def make_layer_runner(plan: ExecutionPlan):
    """A ``layer_runner`` applying layer i's remat policy
    (``plan.layer_strategies[i]``, or the default strategy for every layer
    when the plan lists none) around ``default_layer_runner``'s loop."""

    def runner(blocks, x, apply_block):
        num_layers = tree_leaves(blocks)[0].shape[0]
        strategies = plan.layer_strategies or [plan.default_strategy] * num_layers
        if len(strategies) != num_layers:
            raise ValueError(f"plan has {len(strategies)} layer strategies for "
                             f"{num_layers} layers")
        policies = iter(s.remat for s in strategies)
        return default_layer_runner(
            blocks, x, lambda p, h: apply_remat(apply_block, next(policies))(p, h))

    return runner


def _to_device(value, device: torch.device):
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(np.ascontiguousarray(value))
    return value.to(device)


def _single_device(plan: ExecutionPlan, mesh) -> None:
    strategies = list(plan.layer_strategies) + [plan.default_strategy]
    many = (mesh is not None or plan.num_devices > 1 or plan.pp > 1
            or any(s.tp > 1 or s.cp > 1 or s.ep > 1 for s in strategies))
    if many:
        raise NotImplementedError(
            "repro_torch trains on one device only; a mesh, or a plan over more than one "
            f"device (mesh {plan.mesh_shape}, pp {plan.pp}, tp/cp/ep above 1), waits for "
            "the parallel-runtime slice")


# --------------------------------------------------------------------------
# hybrid parallel model bundle
# --------------------------------------------------------------------------

@dataclasses.dataclass
class HybridParallelModel:
    model: Any
    plan: ExecutionPlan
    opt_cfg: opt_lib.AdamWConfig

    @property
    def device(self) -> torch.device:
        return self.model.device

    # ------------------------------------------------------------ params
    def init_params(self, generator: torch.Generator) -> dict:
        """fp32 master weights on the model's device (``generator`` lives there)."""
        return self.model.init(generator, torch.float32)

    def init_opt_state(self, params) -> opt_lib.AdamWState:
        return opt_lib.adamw_init(params, self.opt_cfg)

    # ------------------------------------------------------------ steps
    def loss_fn(self, params, batch, dtype=torch.bfloat16):
        """(loss, metrics) of one batch, the forward computed in ``dtype``
        over the fp32 master weights (bf16 in ``train_step``; the parity
        checks also run fp32)."""
        side = {k: batch[k] for k in ("vis_embeds", "frames") if k in batch}
        logits, extra = self.model.forward_train(
            params, batch["tokens"], layer_runner=make_layer_runner(self.plan), dtype=dtype,
            **side)
        off = self.model.text_offset()
        if off:
            logits = logits[:, off:, :]
        loss, metrics = softmax_xent(logits, batch["labels"])
        metrics["aux"] = extra
        return loss + AUX_LOSS_WEIGHT * extra, metrics

    def value_and_grad(self, params, batch, dtype=torch.bfloat16):
        """(loss, metrics, grads) of one batch; grads in the params' tree and
        dtype.  ``batch`` arrays (numpy or torch) move to the model's device."""
        batch = {k: _to_device(v, self.device) for k, v in batch.items()}
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        flat = tree_leaves(live)
        with torch.enable_grad():
            loss, metrics = self.loss_fn(live, batch, dtype)
            grads = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_map(lambda p: grads[id(p)], live)

    def train_step(self, params, opt_state: opt_lib.AdamWState, batch: dict,
                   dtype=torch.bfloat16, *, donate: bool = False):
        """One optimizer step over the global batch: the mean loss and grads
        of ``plan.grad_accum`` microbatches (grads summed in fp32), then
        AdamW inside the profiler span ``optimizer``, as the JAX step's named
        scope marks it.  ``dtype`` is the forward's compute dtype (bf16, as
        in the JAX step; the parity checks also run fp32).

        ``donate=True`` writes the update into ``params`` and ``opt_state``
        in place (``adamw_update_``: the same numbers), so no second copy of
        the fp32 state is held, as JAX's donated buffers let XLA reuse
        them; the caller must not read the old trees."""
        batch = {k: _to_device(v, self.device) for k, v in batch.items()}
        k = max(self.plan.grad_accum, 1)
        B = batch["tokens"].shape[0]
        if B % k:
            raise ValueError(f"global batch {B} is not a multiple of grad_accum {k}")
        micro = {name: v.reshape((k, B // k) + tuple(v.shape[1:])) for name, v in batch.items()}
        grads = None
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(k):
            l, metrics, g = self.value_and_grad(params, {n: v[i] for n, v in micro.items()},
                                                dtype)
            loss = loss + l
            if grads is None:       # fp32; a private copy to sum into when k > 1
                grads = tree_map(lambda x: x.float().clone() if k > 1 else x.float(), g)
            else:
                tree_map(lambda acc, x: acc.add_(x), grads, g)
            del g
        if k > 1:
            grads = tree_map(lambda g: g.div_(k), grads)
        loss = loss / k
        with record_function("optimizer"):
            update = opt_lib.adamw_update_ if donate else opt_lib.adamw_update
            new_params, new_opt, stats = update(params, grads, opt_state, self.opt_cfg)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics.update(stats)
        return new_params, new_opt, metrics

    def jit_train_step(self, donate: bool = True):
        """The eager ``train_step``: nothing is compiled in the port."""
        return self.train_step


def construct_hybrid_parallel_model(
    model,
    plan: ExecutionPlan,
    mesh=None,
    opt_cfg: Optional[opt_lib.AdamWConfig] = None,
) -> HybridParallelModel:
    """The paper's runtime entry point (Fig. 2 line 13), on one device: the
    model's (``"cuda"`` unless it was built with ``device="cpu"``).  Trains
    every family: the decoders (dense, MoE, and the VLM, whose batches
    carry ``vis_embeds``), Mamba2 and the hybrid, and the encoder-decoder
    (whose batches carry ``frames``); ``loss_fn`` adds the MoE router's aux
    loss at ``AUX_LOSS_WEIGHT``."""
    _single_device(plan, mesh)
    return HybridParallelModel(model=model, plan=plan, opt_cfg=opt_cfg or opt_lib.AdamWConfig())
