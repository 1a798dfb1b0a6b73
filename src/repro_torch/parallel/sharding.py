"""LayerStrategy -> sharding rules (the port of ``repro.parallel.sharding``).

Two rule sets per strategy, copied from JAX:

* **activation rules** — ``batch`` maps to the DP axes; ``seq`` maps to the
  model axis only under sequence parallelism (block boundaries); head / ff
  / vocab axes map to the model axis under TP.  The port reads them through
  ``parallel.collectives.tp_state`` (the region operators) and
  :func:`residual_layout` (the runner's layout changes between groups).

* **parameter rules** — TP shards head / ff / vocab dims on the model axis;
  ZeRO additionally shards the ``embed`` / ``norm`` dims over the DP axes:
  params at stage 3, grads at stage >= 2, optimizer state at stage >= 1.

Where JAX pads a dim that does not divide, ``spec_for_shape`` leaves it
whole, and the port computes that part replicated on every rank.

Port-side additions: :func:`place_params` cuts this rank's local shard of
every leaf from the canonical tree, :func:`gather_params` puts the canonical
leaves back together (both per spec tree, on a ``launch.mesh.ProcessMesh``);
:func:`zero_dims` names the dim a leaf's ZeRO layout adds, :func:`reshard`
moves a shard between two layouts of one leaf (under expert parallelism
the MoE router's ZeRO layout shards ``embed`` where its compute layout
shards ``experts``: ``MeshRules.spec``'s dedup).
``cache_spec_tree`` waits for the serving mesh.  ``act_rules`` sets the
ring (``ring=cp``) that ``axes.ring_context`` reads.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.strategy import ExecutionPlan, LayerStrategy
from repro_torch.models.common import ParamDef, tree_map
from repro_torch.parallel import collectives
from repro_torch.parallel.axes import MeshRules, MeshShape, P, Spec

# logical axes that tensor parallelism shards over the model axis
_TP_PARAM_AXES = ("q_heads", "kv_heads", "ff", "vocab", "ssm_inner", "ssm_heads")
_TP_ACT_AXES = ("q_heads", "kv_heads", "ff", "vocab", "ssm_inner", "ssm_heads")


def act_rules(plan: ExecutionPlan, strategy: LayerStrategy,
              mesh: Optional[MeshShape]) -> MeshRules:
    dp = plan.dp_axes_for(strategy)
    tp = plan.tp_axis if strategy.tp > 1 else None
    cp = plan.cp_axis if strategy.cp > 1 and "cp" in plan.mesh_axes else None
    rules: dict = {"batch": dp}
    seq_targets = tuple(t for t in (cp, tp if strategy.sp else None) if t)
    if seq_targets:
        # boundary seq: cp shards it everywhere, sp additionally over tp
        rules["seq"] = seq_targets if len(seq_targets) > 1 else seq_targets[0]
    if cp:
        rules["cp_seq"] = cp
    if tp:
        for ax in _TP_ACT_AXES:
            rules[ax] = tp
    if strategy.ep > 1:
        rules["experts"] = "data"
    rules["moe_capacity"] = dp          # spec() dedup resolves overlaps
    return MeshRules(rules=rules, mesh=mesh, ring=cp)


def param_rules(
    plan: ExecutionPlan,
    strategy: LayerStrategy,
    mesh: Optional[MeshShape],
    *,
    zero_sharded: bool,        # True => apply the ZeRO dp-sharding layout
) -> MeshRules:
    # params replicate over cp, so the ZeRO layout may spread states over
    # dp·cp — state_axes_for adds "cp"
    dp = plan.state_axes_for(strategy)
    rules: dict = {}
    if strategy.tp > 1:
        for ax in _TP_PARAM_AXES:
            rules[ax] = plan.tp_axis
    if strategy.ep > 1:
        rules["experts"] = "data"
    if zero_sharded:
        rules["embed"] = dp
        rules["norm"] = dp
    return MeshRules(rules=rules, mesh=mesh)


# --------------------------------------------------------------------------
# param/grad/opt-state spec trees
# --------------------------------------------------------------------------

def _specs_from_defs(defs_tree, rules: MeshRules):
    """ParamDef tree -> spec tree (divisibility-checked per shape)."""

    def walk(sub):
        return {
            k: (rules.spec_for_shape(v.logical_axes, v.shape)
                if isinstance(v, ParamDef) else walk(v))
            for k, v in sub.items()
        }

    return walk(defs_tree)


def group_blocks(tree: dict, plan: ExecutionPlan, supports_grouping: bool = True) -> dict:
    """Split the stacked ``blocks`` subtree into per-strategy groups.

    {"blocks": stacked(L)} -> {"blocks": {"g000": stacked(n0), ...}}.
    Group keys sort lexicographically in layer order.  The groups are views
    of the stacked leaves."""
    if "blocks" not in tree or plan.uniform() or not supports_grouping:
        return tree
    out = dict(tree)
    out["blocks"] = {
        f"g{i:03d}": tree_map(lambda a, g=g: a[g.start:g.stop], tree["blocks"])
        for i, g in enumerate(plan.groups())
    }
    return out


def is_grouped(blocks) -> bool:
    return isinstance(blocks, dict) and bool(blocks) and all(
        k.startswith("g") and k[1:].isdigit() for k in blocks)


def ungroup_blocks(tree: dict, plan: ExecutionPlan, supports_grouping: bool = True) -> dict:
    if ("blocks" not in tree or plan.uniform() or not supports_grouping
            or not is_grouped(tree["blocks"])):
        return tree
    out = dict(tree)
    parts = [tree["blocks"][k] for k in sorted(tree["blocks"])]
    out["blocks"] = tree_map(lambda *xs: torch.cat(xs, dim=0), *parts)
    return out


def param_spec_tree(
    model,
    plan: ExecutionPlan,
    mesh: Optional[MeshShape],
    *,
    kind: str = "param",      # param | grad | opt
    zero: bool = True,
) -> dict:
    """Spec tree matching ``group_blocks(params, plan)``.

    kind="param": ZeRO dp-sharding only at stage 3.
    kind="grad" : at stages >= 2.   kind="opt": at stages >= 1.
    ``zero=False`` gives the tensor-parallel layout alone, the one the
    layers compute in (the port's addition)."""
    threshold = {"param": 3, "grad": 2, "opt": 1}[kind]
    supports = getattr(model, "supports_layer_grouping", True)
    grouped_mode = not plan.uniform() and supports
    defs = model.param_defs()

    def rules_for(strategy: LayerStrategy) -> MeshRules:
        return param_rules(plan, strategy, mesh,
                           zero_sharded=zero and strategy.zero >= threshold)

    out: dict = {}
    for key, sub in defs.items():
        if key == "blocks" and grouped_mode:
            out[key] = {
                f"g{i:03d}": _specs_from_defs(sub, rules_for(g.strategy))
                for i, g in enumerate(plan.groups())
            }
        else:
            strat = (plan.layer_strategies[0] if key == "blocks" and plan.layer_strategies
                     else plan.default_strategy)
            out[key] = _specs_from_defs(sub, rules_for(strat))
    return out


def batch_spec(plan: ExecutionPlan, global_batch: Optional[int] = None,
               mesh: Optional[MeshShape] = None) -> Spec:
    """tokens/labels (B, S): batch over the DP axes (replicated if indivisible,
    e.g. long_500k's global_batch=1, or with no DP axes)."""
    dp = plan.dp_axes_for(plan.default_strategy)
    if not dp:
        return P(None, None)
    if global_batch is not None and mesh is not None:
        n = 1
        for a in dp:
            n *= mesh.shape[a]
        if global_batch % n != 0:
            return P(None, None)
    return P(dp if len(dp) > 1 else dp[0], None)


# --------------------------------------------------------------------------
# the port's local shards
# --------------------------------------------------------------------------

def spec_dims(spec: Spec):
    """(dim, mesh axes) of every sharded dim of a spec."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            yield dim, entry if isinstance(entry, tuple) else (entry,)


def shard_leaf(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's shard of a whole leaf (a copy, never a view)."""
    out = x
    for dim, axes in spec_dims(spec):
        out = collectives.take_shard(out, dim, mesh.group(axes))
    return out.clone() if out is x else out


def unshard_leaf(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole leaf, all-gathered from every rank's shard."""
    for dim, axes in spec_dims(spec):
        x = collectives.all_gather(x, dim, mesh.group(axes))
    return x


def place_params(canonical: dict, specs: dict, mesh) -> dict:
    """This rank's local shard of every leaf of ``canonical`` (a tree of the
    spec tree's structure: group it first for a grouped plan)."""
    return tree_map(lambda x, s: shard_leaf(x, s, mesh), canonical, specs)


def gather_params(local: dict, specs: dict, mesh) -> dict:
    """The inverse of :func:`place_params`: every leaf whole, on every rank."""
    return tree_map(lambda x, s: unshard_leaf(x, s, mesh), local, specs)


def _entries(spec: Spec, n: int) -> list:
    return [tuple(e) if isinstance(e, tuple) else ((e,) if e else ())
            for e in tuple(spec) + (None,) * (n - len(spec))]


def spec_axes(spec: Spec) -> set:
    """The mesh axes a spec shards over."""
    return {a for _, axes in spec_dims(spec) for a in axes}


def reshard(x: torch.Tensor, src: Spec, dst: Spec, mesh) -> torch.Tensor:
    """A local shard laid out by ``src`` -> the same leaf's shard laid out by
    ``dst``: every dim whose mesh axes differ is all-gathered, then cut as
    ``dst`` says (a pure change of layout; ``x`` itself where they agree)."""
    n = max(len(src), len(dst))
    a, b = _entries(src, n), _entries(dst, n)
    for dim in range(n):
        if a[dim] and a[dim] != b[dim]:
            x = collectives.all_gather(x, dim, mesh.group(a[dim]))
    for dim in range(n):
        if b[dim] and a[dim] != b[dim]:
            x = collectives.take_shard(x, dim, mesh.group(b[dim]))
    return x


def zero_dims(full: Spec, base: Spec):
    """(dim, mesh axes) where the spec ``full`` shards a dim that ``base``
    (the same leaf's tensor-parallel spec) keeps whole: the ZeRO dp split."""
    base = tuple(base) + (None,) * (len(full) - len(base))
    return [(d, axes) for d, axes in spec_dims(full) if base[d] is None]


def residual_layout(plan: ExecutionPlan, strategy: LayerStrategy, mesh) -> str:
    """The residual stream's layout over the model axis in a layer of this
    strategy (``collectives.relayout``): ``"seq"`` under sequence
    parallelism, ``"batch"`` where a tp 1 layer absorbs the model axis
    into data parallelism, else ``"rep"``."""
    if mesh is None or "model" not in mesh.shape or mesh.shape["model"] == 1:
        return "rep"
    if strategy.tp > 1:
        return "seq" if strategy.sp else "rep"
    return "batch" if "model" in plan.dp_axes_for(strategy) else "rep"
