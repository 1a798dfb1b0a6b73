"""AdamW on nested dicts of tensors (the port of
``repro.runtime.optimizer``).

The update is functional, as in the JAX package: ``adamw_update`` returns
new parameter and state trees and leaves its inputs untouched;
``adamw_update_`` writes the same values into its inputs (a donated
step).  Global-norm
clipping at ``grad_clip``, bias corrections computed as fp32 tensors
(``b1 ** t`` with t fp32), ``eps`` outside the bias-corrected square root,
and weight decay on every leaf of rank >= 2.  The rank rule is the JAX
package's and is kept as it is: the stacked block norm scales ``(L, D)`` and
the qkv biases ``(L, H, hd)`` have rank >= 2 and so are decayed; only
unstacked vectors such as ``final_norm.scale`` are not.

On a mesh the trees hold local shards: ``global_norm`` takes their spec
tree and sums each leaf's squares over exactly the mesh axes that leaf is
sharded on, so a leaf held whole counts once, and the update takes that
norm (``gnorm=``) instead of the local one.  The rank rule reads the
shard's rank, which is the leaf's.

``abstract_adamw_state`` waits for the dry-run slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import spec_dims


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    m_dtype: torch.dtype = torch.float32     # bf16 halves optimizer memory
    v_dtype: torch.dtype = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor             # () int32
    m: Any                         # tree like params
    v: Any


def adamw_init(params, cfg: AdamWConfig) -> AdamWState:
    zeros = lambda dt: tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=zeros(cfg.m_dtype), v=zeros(cfg.v_dtype))


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """The 2-norm of every leaf together.  With ``specs`` (the tree's spec
    tree) and ``mesh``, leaves are local shards: the squares of the leaves
    sharded over one set of axes (those of more than one rank) are summed
    and all-reduced over that set."""
    if specs is None:
        sq = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
        return torch.sqrt(torch.sum(torch.stack(sq)))
    parts: dict = {}
    for x, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        axes = {a for _, dim_axes in spec_dims(spec) for a in dim_axes if mesh.shape[a] > 1}
        key = tuple(a for a in mesh.axis_names if a in axes)
        parts.setdefault(key, []).append(torch.sum(torch.square(x.float())))
    total = None
    for key in sorted(parts, key=len):
        part = torch.sum(torch.stack(parts[key]))
        if key:
            part = collectives.all_reduce(part, mesh.group(key))
        total = part if total is None else total + part
    return torch.sqrt(total)


def _leaf_update(grads, state: AdamWState, cfg: AdamWConfig, gnorm=None):
    """(new step, ``upd(p, g, m, v) -> (new_p, new_m, new_v)`` for one leaf,
    the grads' global norm: ``gnorm`` when given, else ``grads``')."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0) if cfg.grad_clip
             else 1.0)
    step = state.step + 1
    t = step.float()
    b1 = torch.tensor(cfg.b1, dtype=torch.float32, device=t.device)
    b2 = torch.tensor(cfg.b2, dtype=torch.float32, device=t.device)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = m.float() * cfg.b1 + g * (1.0 - cfg.b1)
        v32 = v.float() * cfg.b2 + g * g * (1.0 - cfg.b2)
        u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        p32 = p.float()
        if p.dim() >= 2 and cfg.weight_decay:   # rank rule: see the module note
            u = u + cfg.weight_decay * p32
        new_p = (p32 - cfg.lr * u).to(p.dtype)
        return new_p, m32.to(cfg.m_dtype), v32.to(cfg.v_dtype)

    return step, upd, gnorm


def adamw_update(params, grads, state: AdamWState, cfg: AdamWConfig, gnorm=None):
    """Returns (new_params, new_state, stats)."""
    step, upd, gnorm = _leaf_update(grads, state, cfg, gnorm)
    flat = tree_map(upd, params, grads, state.m, state.v)
    pick = lambda i: tree_map(lambda t3: t3[i], flat)
    return pick(0), AdamWState(step, pick(1), pick(2)), {"grad_norm": gnorm}


def adamw_update_(params, grads, state: AdamWState, cfg: AdamWConfig, gnorm=None):
    """``adamw_update`` with its results written into ``params``, ``state.m``
    and ``state.v`` in place, leaf by leaf (the same numbers): only one
    leaf's temporaries are live at a time, never a second tree.  Returns
    (params, the new state over the same m/v tensors, stats)."""
    step, upd, gnorm = _leaf_update(grads, state, cfg, gnorm)
    for p, g, m, v in zip(*map(tree_leaves, (params, grads, state.m, state.v))):
        for dst, new in zip((p, m, v), upd(p, g, m, v)):
            dst.copy_(new)
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm}
