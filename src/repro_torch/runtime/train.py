"""Training runtime (the port of ``repro.runtime.train``).

``construct_hybrid_parallel_model`` (named after the paper's API) takes a
model, an :class:`ExecutionPlan` and a mesh, and returns a
:class:`HybridParallelModel` whose ``train_step(params, opt_state, batch)``
applies the plan: each group's activation rules and remat policy, gradient
accumulation over ``plan.grad_accum`` microbatches (the mean of their
losses and grads, summed in fp32), the grads reduced as the ZeRO stage
says, then AdamW.

``mesh=None`` is one device: the canonical stacked ``blocks`` tree, with
each layer's remat policy.  On a ``launch.mesh.ProcessMesh`` the runtime
builds ``param_specs``, ``grad_specs`` and ``opt_specs`` as JAX does, and
each rank holds its local shards of the grouped tree (``place_params``;
``gather_params`` is the inverse).  The global batch is split into
microbatches first, then each microbatch over the default strategy's dp
ranks, as JAX reshapes then shards; the loss is normalised by the global
valid-token count.  A leaf's grad is summed over exactly the batch axes of
its layer group (the state axes) that its ``param_specs`` layout does not
shard it over: the rest of the sum has been taken by the forward's own
collectives' backwards (ZeRO-3's gather, the MoE router's gather and the
expert exchange over the data axis).  By ZeRO stage: stage 0 and 1
all-reduce (stage 1 then updates this rank's optimizer shard and
all-gathers the params), stage 2 reduce-scatters into the optimizer
layout, stage 3 holds the params dp-sharded and all-gathers them per layer
inside the runner, one message a layer, through an autograd function whose
backward reduce-scatters (so a ``full`` remat regathers on recompute); a
leaf whose ``ParamDef`` is ``cast`` is gathered in the forward's dtype
(``_gather_sum``).  Where two layouts of one leaf do not nest (the MoE
router under expert parallelism), it moves between them by
``sharding.reshard``.  Where two consecutive groups differ in layout (tp,
sp, or a tp 1 group absorbing the model axis into dp), the residual stream
changes layout at the boundary (``collectives.relayout``).

Context parallelism (cp > 1, the dense family, as JAX limits it: GALV031)
splits each rank's rows of a microbatch once more, over the ``cp`` axis,
into its zig-zag shard of the sequence (``parallel.context.zigzag_shard``;
the labels are already shifted, so tokens and labels split together keep
every loss term), and every layer's rules carry the microbatch's global
length (``MeshRules.seq_len``), so attention runs the ring over the ``cp``
group with RoPE at the shard's global positions.  The loss is normalised
by the valid tokens over the batch and cp axes together, and the ranks'
losses sum over both.  cp is a state axis (``ExecutionPlan.
state_axes_for``): every leaf's grad is summed over it with the batch axes,
and ZeRO shards states over dp·cp.

The MoE family routes the global microbatch (``models/moe.py``): its aux
loss has one value on every rank of a batch group, so ``loss_fn`` adds it
to each rank's loss at 1 / (the group's size) of its value and at its whole
grad (each rank's grad is that rank's share), and the summed loss and
grads count it once, as JAX's step does.

A plan with pp > 1 is refused here, naming ``runtime.train_pp.PipelineTrainer``,
which the launcher picks for it as JAX's does (that trainer reuses this
one's layout, collectives and update on its staged trees, and under cp
its rows, ring rules and loss group: pp x cp runs there); a plan mixing
cp = 1 and cp > 1 is refused naming its Queue 1 item, and cp on a family
other than dense is an error (GALV031); ep > 1 is an
error where GALV006 fails or no layer has experts, and so is a tp that
does not divide a Mamba2 layer's heads or whose ranks' heads straddle its
B/C groups.  Nothing is compiled (``jit_train_step`` returns the eager
step).

Checkpoints hold the canonical trees (``runtime/checkpoint.py``):
``checkpoint_state`` gathers every leaf whole on every rank (the params
under ``param_specs``, m and v under ``opt_specs``, beside the step
scalar), and ``place_params`` / ``place_opt_state`` cut this rank's shards
of a restored canonical state, so a checkpoint saved under one plan
restores under another.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.core.strategy import ExecutionPlan
from repro_torch.models.common import tree_leaves, tree_map, unstack_layers
from repro_torch.models.mamba2 import check_tp as check_mamba2_tp
from repro_torch.models.transformer import default_layer_runner
from repro_torch.parallel import collectives
from repro_torch.parallel import context
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.axes import axis_rules, current_rules
from repro_torch.parallel.remat import apply_remat
from repro_torch.runtime import checkpoint as ckpt_lib
from repro_torch.runtime import optimizer as opt_lib

AUX_LOSS_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-4


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, *, vocab=None, dp=None,
                 count=None):
    """logits (B,S,V) fp32; labels (B,S) int, -1 = masked.  Returns (mean
    nll + z-loss, metrics dict).  The label logit is a ``gather`` at the
    clamped label, then masked: on one device this is exactly the JAX
    package's iota-masked sum, without a (B,S,V) mask or temporary.

    ``vocab=(group, first)``: the logits are this rank's vocab columns from
    ``first`` on, and the loss partitions along vocab as JAX's comment
    says: the max and the sum of exponentials are all-reduced over
    ``group`` for the lse, and the label logit is the masked local gather,
    all-reduced.  ``dp``: the group the batch is split over; the mean is
    over its global valid-token count, so the ranks' losses sum to it;
    ``count`` gives that count instead (the pipeline reads the step's
    before its forward, and normalises each microbatch by it)."""
    valid = (labels >= 0).float()
    if vocab is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.clamp(min=0).long().unsqueeze(-1)).squeeze(-1)
    else:
        group, first = vocab
        width = logits.shape[-1]
        m = collectives.all_reduce(logits.detach().amax(dim=-1), group, op=dist.ReduceOp.MAX)
        se = torch.exp(logits - m.unsqueeze(-1)).sum(dim=-1)
        lse = m + torch.log(collectives.reduce_from(se, group))
        local = labels.long() - first
        inside = (local >= 0) & (local < width)
        ll = torch.gather(logits, -1, local.clamp(0, width - 1).unsqueeze(-1)).squeeze(-1)
        ll = collectives.reduce_from(ll * inside, group)
    nll = (lse - ll) * valid
    if count is None:
        count = collectives.all_reduce(valid.sum(), dp)
    denom = torch.clamp(count, min=1.0)
    loss = nll.sum() / denom
    zloss = Z_LOSS_WEIGHT * torch.sum(torch.square(lse) * valid) / denom
    return loss + zloss, {"nll": loss, "zloss": zloss, "tokens": count}


# --------------------------------------------------------------------------
# layer runner (per-group strategies + remat)
# --------------------------------------------------------------------------

def make_layer_runner(plan: ExecutionPlan, mesh=None, gather=None):
    """A ``layer_runner`` applying each layer's strategy.

    Without a mesh: layer i's remat policy (``plan.layer_strategies[i]``, or
    the default strategy for every layer when the plan lists none) around
    ``default_layer_runner``'s loop over the canonical stacked blocks.

    On a mesh: each group of the grouped blocks (``g000``, ...; one group
    for a uniform plan) runs under its ``act_rules`` with its remat policy,
    the residual stream moved into the group's layout before it and back
    to the default strategy's after the last.  ``gather(i, layer_params)``
    (ZeRO-3) all-gathers one layer of group i; it runs inside the remat
    region, so a recompute regathers."""
    if mesh is None:
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

    groups = plan.groups()
    home = shd.residual_layout(plan, plan.default_strategy, mesh)
    model_axis = mesh.group("model") if "model" in mesh.shape else None

    def runner(blocks, x, apply_block):
        # the microbatch's global length, which a ring reads (loss_fn sets it)
        outer = current_rules()
        seq_len = None if outer is None else outer.seq_len
        if shd.is_grouped(blocks):
            items = [(blocks[f"g{i:03d}"], i, g.strategy) for i, g in enumerate(groups)]
        else:
            strat = plan.layer_strategies[0] if plan.layer_strategies else plan.default_strategy
            items = [(blocks, 0, strat)]
        extra = torch.zeros((), dtype=torch.float32, device=x.device)
        layout = home
        for stacked_params, i, strat in items:
            rules = dataclasses.replace(shd.act_rules(plan, strat, mesh), seq_len=seq_len)
            target = shd.residual_layout(plan, strat, mesh)
            x = collectives.relayout(x, layout, target, model_axis)
            layout = target

            def layer(lp, h, rules=rules, i=i):
                with axis_rules(rules):     # also around a recompute
                    return apply_block(gather(i, lp) if gather else lp, h)

            fn = apply_remat(layer, strat.remat)
            for lp in unstack_layers(stacked_params):
                x, e = fn(lp, x)
                extra = extra + e
        return collectives.relayout(x, layout, home, model_axis), extra

    return runner


def _to_device(value, device: torch.device):
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(np.ascontiguousarray(value))
    return value.to(device)


_ITEM = "Queue 1 item 4"


def check_supported(model, plan: ExecutionPlan, mesh) -> None:
    """Refuse a pipelined plan (``runtime.train_pp.PipelineTrainer`` runs
    it), then ``check_layout``."""
    if plan.pp > 1:
        raise NotImplementedError(
            f"pipeline parallelism (pp {plan.pp}): construct_hybrid_parallel_model does "
            "not pipeline; runtime.train_pp.PipelineTrainer(model, plan, mesh) runs the "
            "plan, as the launcher picks it")
    check_layout(model, plan, mesh)


def check_layout(model, plan: ExecutionPlan, mesh) -> None:
    """Refuse what later PRs bring, naming its Queue 1 item (a plan mixing
    cp = 1 and cp > 1, or whose default strategy's cp is not its groups':
    a relayout over ``cp`` between batch and zig-zag sequence shards), and
    reject cp on a family other than dense (GALV031, as JAX's verifier),
    a plan over more than one device without a mesh, a mesh that is not
    the plan's (a cp that is not its ``cp`` axis: GALV032), and a tp whose
    Mamba2 layout the port cannot nest (``mamba2.check_tp``: tp must
    divide the SSM heads, and tp | G or G | tp; GSPMD would reshard such a
    layer)."""
    strategies = list(plan.layer_strategies) + [plan.default_strategy]
    family = model.cfg.family
    cps = {s.cp for s in strategies}
    if max(cps) > 1:
        if family != "dense":
            raise ValueError(f"GALV031: cp {max(cps)} on the {family} family: context "
                             "parallelism runs dense attention blocks alone, as JAX's")
        if len(cps) > 1:
            raise NotImplementedError(
                f"a plan mixing cp = 1 and cp > 1 (cp {sorted(cps)} over its groups and "
                f"default strategy) waits for {_ITEM}'s relayout over cp between batch "
                "and zig-zag sequence shards")
    for s in strategies:
        if s.ep == 1:
            continue
        if family != "moe":
            raise ValueError(f"ep {s.ep} on the {family} family: no layer has experts to "
                             "shard (the search proposes ep for moe blocks alone)")
        if model.cfg.num_experts % s.ep:
            raise ValueError(f"GALV006: ep {s.ep} does not divide "
                             f"{model.cfg.num_experts} experts")
        if mesh is not None and mesh.shape.get("data", 1) == 1:
            raise ValueError(f"ep {s.ep} shards the experts over the data axis, and mesh "
                             f"{mesh.shape} has none")
    if mesh is None:
        if plan.num_devices > 1 or any(max(s.tp, s.ep, s.cp) > 1 for s in strategies):
            raise ValueError(f"a plan over mesh {plan.mesh_shape} with tp up to "
                             f"{max(s.tp for s in strategies)}, ep up to "
                             f"{max(s.ep for s in strategies)} and cp up to {max(cps)} "
                             "needs a mesh (repro_torch.launch.mesh.make_mesh)")
        return
    if not hasattr(mesh, "group"):
        raise TypeError(f"mesh must be a repro_torch.launch.mesh.ProcessMesh, got "
                        f"{type(mesh).__name__}")
    if (tuple(mesh.axis_names), tuple(mesh.sizes)) != (tuple(plan.mesh_axes),
                                                      tuple(plan.mesh_shape)):
        raise ValueError(f"plan mesh {plan.mesh_axes} {plan.mesh_shape} vs mesh "
                         f"{mesh.axis_names} {mesh.sizes}")
    cp = max(cps)
    if cp > 1 and mesh.shape.get("cp") != cp:
        raise ValueError(f"GALV032: cp {cp} needs a 'cp' axis of {cp} ranks, mesh {mesh.shape}")
    for s in strategies:
        if s.tp == 1:
            continue
        if mesh.shape.get("model") != s.tp:
            raise ValueError(f"tp {s.tp} needs a model axis of {s.tp} ranks, mesh "
                             f"{mesh.shape}")
        if family in ("ssm", "hybrid"):
            check_mamba2_tp(model.cfg, s.tp)    # raises, naming the dims


# --------------------------------------------------------------------------
# hybrid parallel model bundle
# --------------------------------------------------------------------------

@dataclasses.dataclass
class HybridParallelModel:
    model: Any
    plan: ExecutionPlan
    opt_cfg: opt_lib.AdamWConfig
    mesh: Any = None

    # filled by construct_hybrid_parallel_model on a mesh
    param_specs: Any = None
    grad_specs: Any = None
    opt_specs: Any = None
    tp_specs: Any = None          # the layout the layers compute in (no ZeRO)

    @property
    def device(self) -> torch.device:
        return self.model.device if self.mesh is None else self.mesh.device

    # ------------------------------------------------------------ layout
    def _layout(self) -> None:
        """Spec trees, and per leaf the groups that move it between them."""
        model, plan, mesh = self.model, self.plan, self.mesh
        spec = self._spec_tree
        self.param_specs = spec(kind="param")
        self.grad_specs = spec(kind="grad")
        self.opt_specs = spec(kind="opt")
        self.tp_specs = spec(kind="param", zero=False)
        dims = lambda full, base: [(d, mesh.group(a)) for d, a in shd.zero_dims(full, base)]
        self._param_zero = tree_map(dims, self.param_specs, self.tp_specs)
        # per leaf, whether its ParamDef lets a ZeRO-3 gather move it in the
        # forward's dtype (every block group holds the same leaves)
        casts = tree_map(lambda d: d.cast, model.param_defs())
        self._cast = {key: ({g: casts[key] for g in sub}
                            if key == "blocks" and shd.is_grouped(sub) else casts[key])
                      for key, sub in self.param_specs.items()}
        # each leaf's state axes: those of its layer group's strategy, as
        # param_spec_tree assigns the strategies
        default = plan.default_strategy
        first = plan.layer_strategies[0] if plan.layer_strategies else default
        strategy_of = {f"g{i:03d}": g.strategy for i, g in enumerate(plan.groups())}
        state_of = lambda s: (lambda _: plan.state_axes_for(s))
        state = {
            key: ({g: tree_map(state_of(strategy_of[g]), sub[g]) for g in sub}
                  if key == "blocks" and shd.is_grouped(sub)
                  else tree_map(state_of(first if key == "blocks" else default), sub))
            for key, sub in self.param_specs.items()}
        self._grad_reduce = tree_map(self._grad_reduction, state, self.param_specs,
                                     self.grad_specs)
        self._default_rules = shd.act_rules(plan, default, mesh)
        self._batch_group = mesh.group(plan.dp_axes_for(default))
        # under cp the default strategy's cp is every group's (check_layout)
        self._cp = default.cp
        self._cp_group = mesh.group("cp") if self._cp > 1 else None
        # the ranks whose losses sum to the global one: batch and cp axes
        self._loss_group = (mesh.group(plan.dp_axes_for(default) + ("cp",))
                            if self._cp > 1 else self._batch_group)
        self._whole_model_gather = not self._supports_grouping

    def _spec_tree(self, **kw) -> dict:
        """A spec tree of this trainer's layout (``param_spec_tree``'s
        keywords)."""
        return shd.param_spec_tree(self.model, self.plan, self.mesh, **kw)

    #: leading dims of a ``blocks`` leaf before a layer's own dims (its layer)
    _stacked_dims = 1

    def _grad_reduction(self, state: tuple, param: tuple, grad: tuple):
        """How a leaf's local grad (``param`` layout, partial over the state
        axes the leaf is not sharded on) becomes its ``grad`` layout, summed:
        (the group summed over, the dim reduce-scattered over it or None).
        The model axis is never a state axis under tp > 1: a leaf every rank
        of it holds whole but uses in part has had its grad summed over it
        at its use (``collectives.partial_grad``).  So the Mamba2 gate
        scale under ZeRO-3, gathered over the data axes and used in part
        over the model axis, arrives summed over both: its gather's backward
        reduce-scatters over data, ``partial_grad`` all-reduces over model,
        and nothing is left to reduce here."""
        sharded = shd.spec_axes(param)
        axes = tuple(a for a in state if a not in sharded)
        added = shd.zero_dims(grad, param)
        nested = all(grad[d:d + 1] == param[d:d + 1] for d, _ in shd.spec_dims(param))
        scatter = (added[0][0] if nested and len(added) == 1 and added[0][1] == axes
                   else None)
        return self.mesh.group(axes), scatter

    @property
    def _supports_grouping(self) -> bool:
        return getattr(self.model, "supports_layer_grouping", True)

    def group(self, params):
        if self.mesh is None:
            return params
        return shd.group_blocks(params, self.plan, self._supports_grouping)

    def ungroup(self, params):
        if self.mesh is None:
            return params
        return shd.ungroup_blocks(params, self.plan, self._supports_grouping)

    # ------------------------------------------------------------ params
    def init_params(self, generator: torch.Generator) -> dict:
        """fp32 master weights on the model's device (``generator`` lives
        there); on a mesh, this rank's shards of the same canonical draw."""
        canonical = self.model.init(generator, torch.float32)
        if self.mesh is None:
            return canonical
        return self.place_params(canonical)

    def place_params(self, canonical: dict) -> dict:
        """This rank's shards (``param_specs``) of a canonical tree, on this
        trainer's device (a restored tree lies on the CPU)."""
        return self._place(canonical, self.param_specs)

    def place_opt_state(self, canonical_opt: opt_lib.AdamWState) -> opt_lib.AdamWState:
        """This rank's optimizer state (m and v cut by ``opt_specs``) from a
        canonical one, as ``checkpoint_state`` gives it and a checkpoint
        restores it."""
        step = torch.as_tensor(canonical_opt.step).to(self.device)
        return opt_lib.AdamWState(step=step, m=self._place(canonical_opt.m, self.opt_specs),
                                  v=self._place(canonical_opt.v, self.opt_specs))

    def _place(self, canonical: dict, specs) -> dict:
        if self.mesh is not None:
            canonical = shd.place_params(self.group(canonical), specs, self.mesh)
        return tree_map(lambda x: x.to(self.device), canonical)

    def checkpoint_state(self, params, opt_state=None):
        """The canonical (params, optimizer state) a checkpoint stores
        (``checkpoint.canonical_checkpoint_state``): on a mesh every rank
        takes part in the gathers and holds the whole trees."""
        return ckpt_lib.canonical_checkpoint_state(self, params, opt_state)

    def gather_params(self, params: dict, specs=None) -> dict:
        """The canonical tree (every leaf whole) from this rank's shards of a
        tree laid out by ``specs`` (``param_specs`` by default; pass
        ``grad_specs`` for grads)."""
        if self.mesh is None:
            return params
        specs = self.param_specs if specs is None else specs
        return self.ungroup(shd.gather_params(params, specs, self.mesh))

    def init_opt_state(self, params) -> opt_lib.AdamWState:
        if self.mesh is None:
            return opt_lib.adamw_init(params, self.opt_cfg)
        return opt_lib.adamw_init(self._reshard(params, self.param_specs, self.opt_specs),
                                  self.opt_cfg)

    def _reshard(self, tree: dict, src: dict, dst: dict) -> dict:
        return tree_map(lambda x, a, b: shd.reshard(x, a, b, self.mesh), tree, src, dst)

    # ------------------------------------------------------------ steps
    def _gather_layer(self, i: int, layer_params: dict, dtype) -> dict:
        """ZeRO-3: one layer of block group i whole over its dp axes (dims
        shift by the stacked layer dim)."""
        blocks, casts = self._param_zero["blocks"], self._cast["blocks"]
        if shd.is_grouped(blocks):
            blocks, casts = blocks[f"g{i:03d}"], casts[f"g{i:03d}"]
        return self._gather_sum(layer_params, tree_map(
            lambda ds: [(d - self._stacked_dims, g) for d, g in ds], blocks), casts, dtype)

    @staticmethod
    def _gather_sum(tree: dict, dims: dict, casts: dict, dtype) -> dict:
        """Every leaf of ``tree`` whole along its ZeRO dim (``dims``: the
        leaf's (dim, group), or none), one message per group and dtype.
        A leaf whose ``ParamDef`` is ``cast`` (``casts``) is cast to the
        forward's ``dtype`` before the gather: the layers read it once,
        through ``.to(dtype)``, so the values and its grad are the same and
        the gather moves half the bytes of the fp32 master (FSDP's mixed
        precision).  Any other leaf is gathered as it is: one the layers
        read in fp32 (a norm scale, the MoE router, Mamba2's A_log, D,
        dt_bias), or one whose grad sums several reads in fp32 (the token
        table, zamba2's shared block)."""
        triples: list = []
        tree_map(lambda x, ds, c: triples.append((x, ds, c)), tree, dims, casts)
        leaves = [x.to(dtype) if ds and c else x for x, ds, c in triples]
        out = list(leaves)
        batches: dict = {}
        for k, (x, (_, ds, _)) in enumerate(zip(leaves, triples)):
            for d, group in ds:       # one ZeRO dim a leaf at most
                batches.setdefault((id(group), x.dtype), (group, []))[1].append((k, d))
        for group, items in batches.values():
            gathered = collectives.gather_sum_many([leaves[k] for k, _ in items],
                                                   [d for _, d in items], group)
            for (k, _), x in zip(items, gathered):
                out[k] = x
        flat = iter(out)
        return tree_map(lambda _: next(flat), tree)

    def loss_fn(self, params, batch, dtype=torch.bfloat16):
        """(loss, metrics) of one batch (this rank's rows on a mesh), the
        forward computed in ``dtype`` over the fp32 master weights (bf16 in
        ``train_step``; the parity checks also run fp32)."""
        side = {k: batch[k] for k in ("vis_embeds", "frames") if k in batch}
        if self.mesh is None:
            logits, extra = self.model.forward_train(
                params, batch["tokens"], layer_runner=make_layer_runner(self.plan),
                dtype=dtype, **side)
            off = self.model.text_offset()
            if off:
                logits = logits[:, off:, :]
            loss, metrics = softmax_xent(logits, batch["labels"])
            metrics["aux"] = extra
            return loss + AUX_LOSS_WEIGHT * extra, metrics
        with axis_rules(self._rules_for(batch)):
            # the blocks are gathered a layer at a time by the runner, or
            # here, whole, for a model that runs its layers itself (zamba2)
            live = {k: (v if k == "blocks" and not self._whole_model_gather else
                        self._gather_sum(v, self._param_zero[k], self._cast[k], dtype))
                    for k, v in params.items()}
            runner = make_layer_runner(self.plan, self.mesh,
                                       functools.partial(self._gather_layer, dtype=dtype))
            logits, extra = self.model.forward_train(live, batch["tokens"],
                                                     layer_runner=runner, dtype=dtype, **side)
            off = self.model.text_offset()
            if off:
                logits = logits[:, off:, :]
            vocab = None
            tp = collectives.tp_state()
            if tp is not None and logits.shape[-1] < self.model.cfg.vocab_size:
                vocab = (tp.group, tp.group.index * logits.shape[-1])
            loss, metrics = softmax_xent(logits, batch["labels"], vocab=vocab,
                                         dp=self._loss_group)
        metrics["aux"] = extra
        # the ranks' losses are summed: the aux value counts once over them,
        # its grad whole on each rank (that rank's share; see the module note)
        once = extra + extra.detach() * (1.0 / self._loss_group.size - 1.0)
        return loss + AUX_LOSS_WEIGHT * once, metrics

    def _rules_for(self, rows: dict):
        """The default strategy's activation rules for this rank's rows of a
        microbatch: under cp they carry the microbatch's global length (the
        rank holds 1 / cp of each sequence), which the ring reads."""
        if self._cp == 1:
            return self._default_rules
        return dataclasses.replace(self._default_rules,
                                   seq_len=rows["tokens"].shape[1] * self._cp)

    def _local_value_and_grad(self, params, batch, dtype):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        flat = tree_leaves(live)
        with torch.enable_grad():
            loss, metrics = self.loss_fn(live, batch, dtype)
            grads = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_map(lambda p: grads[id(p)], live)

    def _local_rows(self, batch: dict) -> dict:
        """This rank's rows of a (micro)batch: its shard over the default
        strategy's dp axes, and under cp its zig-zag shard of the sequence."""
        rows = {k: collectives.take_shard(v, 0, self._batch_group) for k, v in batch.items()}
        if self._cp > 1:
            rows = {k: context.zigzag_shard(v, 1, self._cp_group.index, self._cp)
                    for k, v in rows.items()}
        return rows

    def _reduce_grads(self, grads):
        """Local grads -> the ``grad_specs`` layout, summed over the state
        axes each leaf is not sharded on (``_grad_reduction``): reduce-
        scattered where its grad layout adds one dim over exactly those
        axes (ZeRO-2), else all-reduced and moved to its grad layout.  A
        ZeRO-3 leaf arrives reduce-scattered by its gather's backward, and
        an expert leaf under EP summed over the data axis by the
        exchange's."""
        def reduce(g, how, param, grad):
            group, scatter = how
            if scatter is not None:
                return collectives.reduce_scatter(g, scatter, group)
            return shd.reshard(collectives.all_reduce(g, group), param, grad, self.mesh)

        return tree_map(reduce, grads, self._grad_reduce, self.param_specs, self.grad_specs)

    def value_and_grad(self, params, batch, dtype=torch.bfloat16):
        """(loss, metrics, grads) of one batch; grads in the params' tree and
        dtype.  ``batch`` arrays (numpy or torch) move to the model's device.
        On a mesh ``batch`` is the global batch: the loss is the global one
        and the grads are summed over the ranks, laid out by ``grad_specs``
        (``gather_params(grads, hp.grad_specs)`` gives the canonical tree)."""
        batch = {k: _to_device(v, self.device) for k, v in batch.items()}
        if self.mesh is None:
            return self._local_value_and_grad(params, batch, dtype)
        loss, metrics, grads = self._local_value_and_grad(params, self._local_rows(batch),
                                                          dtype)
        metrics = self._sum_metrics(metrics)
        return (collectives.all_reduce(loss, self._loss_group), metrics,
                self._reduce_grads(tree_map(lambda g: g.float(), grads)))

    def _sum_metrics(self, metrics: dict) -> dict:
        out = dict(metrics)
        for k in ("nll", "zloss"):
            out[k] = collectives.all_reduce(out[k], self._loss_group)
        return out

    def train_step(self, params, opt_state: opt_lib.AdamWState, batch: dict,
                   dtype=torch.bfloat16, *, donate: bool = False):
        """One optimizer step over the global batch: the mean loss and grads
        of ``plan.grad_accum`` microbatches (grads summed in fp32), then
        AdamW inside the profiler span ``optimizer``, as the JAX step's named
        scope marks it.  ``dtype`` is the forward's compute dtype (bf16, as
        in the JAX step; the parity checks also run fp32).  On a mesh every
        rank passes the same global batch and takes its rows of each
        microbatch.

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
            mb = {n: v[i] for n, v in micro.items()}
            if self.mesh is not None:
                mb = self._local_rows(mb)
            l, metrics, g = self._local_value_and_grad(params, mb, dtype)
            loss = loss + l
            if grads is None:       # fp32; a private copy to sum into when k > 1
                grads = tree_map(lambda x: x.float().clone() if k > 1 else x.float(), g)
            else:
                tree_map(lambda acc, x: acc.add_(x), grads, g)
            del g
        if k > 1:
            grads = tree_map(lambda g: g.div_(k), grads)
        loss = loss / k
        if self.mesh is not None:
            loss = collectives.all_reduce(loss, self._loss_group)
            metrics = self._sum_metrics(metrics)
            grads = self._reduce_grads(grads)
        new_params, new_opt, stats = self.apply_grads(params, grads, opt_state, donate=donate)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics.update(stats)
        return new_params, new_opt, metrics

    def apply_grads(self, params, grads, opt_state: opt_lib.AdamWState, *,
                    donate: bool = False):
        """AdamW on ``grads`` laid out as ``value_and_grad`` returns them
        (summed over the ranks, ``grad_specs`` on a mesh), inside the
        profiler span ``optimizer``: (new params, new state, stats).
        ``train_step`` is ``value_and_grad`` over its microbatches, then
        this."""
        with record_function("optimizer"):
            if self.mesh is None:
                update = opt_lib.adamw_update_ if donate else opt_lib.adamw_update
                return update(params, grads, opt_state, self.opt_cfg)
            return self._sharded_update(params, grads, opt_state, donate)

    def _sharded_update(self, params, grads, opt_state, donate: bool):
        """AdamW on this rank's optimizer shards: params and grads cut to
        the ``opt_specs`` layout, updated beside their m / v shards under
        the global grad norm, then the params all-gathered back to
        ``param_specs``."""
        gnorm = opt_lib.global_norm(grads, self.grad_specs, self.mesh)
        p_opt = self._reshard(params, self.param_specs, self.opt_specs)
        g_opt = self._reshard(grads, self.grad_specs, self.opt_specs)
        update = opt_lib.adamw_update_ if donate else opt_lib.adamw_update
        new_opt_p, new_opt, stats = update(p_opt, g_opt, opt_state, self.opt_cfg, gnorm=gnorm)
        new_params = self._reshard(new_opt_p, self.opt_specs, self.param_specs)
        if donate:
            for p, new in zip(tree_leaves(params), tree_leaves(new_params)):
                if new is not p:
                    p.copy_(new)
            new_params = params
        return new_params, new_opt, stats

    def jit_train_step(self, donate: bool = True):
        """The eager ``train_step``: nothing is compiled in the port."""
        return self.train_step


def construct_hybrid_parallel_model(
    model,
    plan: ExecutionPlan,
    mesh=None,
    opt_cfg: Optional[opt_lib.AdamWConfig] = None,
) -> HybridParallelModel:
    """The paper's runtime entry point (Fig. 2 line 13).  Without a mesh,
    one device: the model's (``"cuda"`` unless it was built with
    ``device="cpu"``); it trains every family: the decoders (dense, MoE,
    and the VLM, whose batches carry ``vis_embeds``), Mamba2 and the
    hybrid, and the encoder-decoder (whose batches carry ``frames``);
    ``loss_fn`` adds the MoE router's aux loss at ``AUX_LOSS_WEIGHT``.  On
    a ``launch.mesh.ProcessMesh``: DP, ZeRO 1-3, TP and SP per layer group
    for every family, with expert parallelism (ep > 1) for the moe family
    and context parallelism (cp > 1, on the mesh's ``cp`` axis) for the
    dense family; the rest is refused (``check_supported``)."""
    check_supported(model, plan, mesh)
    hp = HybridParallelModel(model=model, plan=plan, opt_cfg=opt_cfg or opt_lib.AdamWConfig(),
                             mesh=mesh)
    if mesh is not None:
        hp._layout()
    return hp
