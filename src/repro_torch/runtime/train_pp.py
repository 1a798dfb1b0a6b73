"""Pipeline-parallel training, plan.pp > 1 (the port of
``repro.runtime.train_pp``).

``PipelineTrainer(model, plan, mesh, opt_cfg)`` stages the block stack over
the mesh's "pod" axis (``parallel/pipeline.py``): each stage holds its
layers (``stage_stack``: (S, L/S, ...), or (S, v, L/(S·v), ...)
interleaved), and within a stage the data and model axes keep DP, ZeRO
1-3, TP and SP under the plan's one uniform strategy, through the layout,
collectives, runner and update of ``runtime/train.py``'s
``HybridParallelModel`` on the staged spec trees (``param_specs`` /
``grad_specs`` / ``opt_specs``: the pod axis on every block leaf's stage
dim; every other leaf replicated over it).  The dense, vlm and ssm
families run; MoE, hybrid and audio are refused as JAX refuses them.

Context parallelism (cp > 1, the dense family, GALV031) runs inside every
stage, as JAX's ``pipeline_forward(seq_axis="cp")``: each rank's rows of a
microbatch are its zig-zag shard of the sequence (``_local_rows``), so the
boundary block is (b, S/cp, d), or (b, S/(cp·tp), d) under SP, and every
attention layer of the stage runs the ring of ``parallel/context.py`` over
the stage's ``cp`` group, in the forward, the remat recompute and the
explicit backward alike, under rules carrying the microbatch's global length
(``_rules_for``).  The ring's hop (``mesh.hop("cp")``) and the stage hop
(``mesh.hop("pod")``) post on disjoint pairs of ranks, and every rank of a
stage walks the same tick table, so the two cp peers of a stage reach
each ring call together.  The valid-token count and the loss totals sum
over the batch and cp axes (``_loss_group``), and cp is a state axis: the
grads sum over it and ZeRO shards states over dp·cp, as at pp 1.  Refused:
cp on a family other than dense (GALV031), a plan whose layers' cp is
not its default strategy's (the pipeline applies its default strategy to
every layer), and a mesh without a ``cp`` axis of that width (GALV032).

A step (``value_and_grad``) cuts the global batch into M = max(grad_accum,
S) microbatches, each into this rank's rows, and runs the schedule window
by window (``pipeline.run_window``):

* stage 0 embeds in the compute dtype and prepends ``vis_embeds``; every
  stage casts what it receives to the compute dtype, runs its chunk's
  layers through ``make_layer_runner`` (the remat policy, the activation
  rules and ZeRO-3's per-layer gather) and sends its output as fp32
  (``BOUNDARY_DTYPE``);
* the last stage applies ``final_norm``, the head, ``text_offset`` and
  ``softmax_xent`` to the fp32 boundary output, as JAX does (so the head's
  product is fp32 in a bf16 step too), one microbatch at a time inside
  that microbatch's backward: only one microbatch's logits are ever live;
* every microbatch's loss is normalised by the step's global valid-token
  count, read from the labels before the forward and all-reduced over the
  batch (and cp) group: the token mean over the whole batch that JAX's
  windows give by re-weighting each window's mean by its tokens (the same
  function);
* the backward is driven explicitly, ``torch.autograd.backward(out, grad)``
  with the cotangent received from the next stage, and the grads of every
  microbatch accumulate in fp32 in the master leaves.

Then every non-block leaf's grad (the token table read by stage 0's
embedding and the last stage's head, the final norm, an untied head) is
summed over the pod group, a stage that does not read it adding zeros,
and every grad is reduced within the stage as ``HybridParallelModel``
reduces it.  The loss and metrics are the last stage's, the same on every
rank.  ``apply_grads`` is AdamW in the ``optimizer`` span on the staged
trees (the grad norm summed over every stage's blocks).  Nothing is
compiled: ``jit_train_step`` returns the eager step.  The checkpoint hooks
are ``HybridParallelModel``'s on the staged spec trees: ``checkpoint_state``
gathers every leaf whole over the stage axis too and unstages the blocks
(``ungroup``: ``unstage_stack``), and ``place_params`` / ``place_opt_state``
stage a canonical tree and cut this rank's shards of it.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.dynamic_programming import interleave_realizable
from repro_torch.core.strategy import ExecutionPlan
from repro_torch.models import embedding
from repro_torch.models.common import tree_map
from repro_torch.models.norms import rmsnorm
from repro_torch.parallel import collectives
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.axes import P, axis_rules, lc
from repro_torch.parallel.collectives import PIPE_AXIS
from repro_torch.parallel.pipeline import (BOUNDARY_DTYPE, build_schedule, num_windows,
                                           run_window, stage_stack, unstage_stack)
from repro_torch.runtime import optimizer as opt_lib
from repro_torch.runtime.train import (HybridParallelModel, _to_device, check_layout,
                                       make_layer_runner, softmax_xent)


def check_pipeline(model, plan: ExecutionPlan, mesh) -> None:
    """JAX's refusals with its exception types (a ``ValueError`` where JAX
    asserts), a plan whose layers' cp is not its default strategy's (the
    pipeline applies the default to every layer), then the mesh against
    the plan (``check_layout``: cp on a non-dense family, GALV032)."""
    cfg = model.cfg
    if plan.pp <= 1:
        raise ValueError(f"PipelineTrainer needs pp > 1, got pp {plan.pp} "
                         "(construct_hybrid_parallel_model runs it)")
    if not getattr(model, "supports_layer_grouping", True):
        raise ValueError(f"the pipeline needs a stacked-block model family: {cfg.name} "
                         f"({cfg.family}) has supports_layer_grouping False")
    if cfg.num_experts:
        raise NotImplementedError("pipeline runtime does not support MoE; use "
                                  "construct_hybrid_parallel_model (the pod axis folds "
                                  "into DP)")
    S = plan.pp
    v = plan.pp_interleave if plan.pp_schedule == "interleaved" else 1
    L = cfg.num_layers
    if v > 1 and not interleave_realizable(L, S, v):
        raise ValueError(f"{L} layers do not split into {S} stages x {v} virtual chunks")
    if L % S:
        raise ValueError(f"{L} layers do not split into {S} stages")
    cps = sorted({s.cp for s in plan.layer_strategies} | {plan.default_strategy.cp})
    if len(cps) > 1 and cfg.family == "dense":
        raise NotImplementedError(
            f"pipeline over layers with cp {cps}: the pipeline applies its default "
            f"strategy (cp {plan.default_strategy.cp}) to every layer, as JAX's does; a plan "
            "that mixes cp degrees waits for Queue 1 item 4's mixed-cp entry")
    check_layout(model, plan, mesh)         # GALV031; a plan over pp > 1 devices needs a mesh
    if mesh.shape.get(PIPE_AXIS) != S:
        raise ValueError(f"pp {S} needs a {PIPE_AXIS!r} axis of {S} ranks, mesh {mesh.shape}")


def _uniform(plan: ExecutionPlan) -> ExecutionPlan:
    """The plan with one strategy for every layer (JAX's: the pipeline
    applies one strategy per stage)."""
    return dataclasses.replace(
        plan, layer_strategies=[plan.default_strategy] * len(plan.layer_strategies))


def _stage_specs(spec_tree: dict, interleave: int = 1) -> dict:
    """JAX's: the pipe axis on every block spec's staged dim 0 (the layer
    dim, never sharded, is replaced); an interleaved stack carries an
    extra unsharded chunk dim."""
    lead = (None, None) if interleave > 1 else (None,)
    out = dict(spec_tree)
    out["blocks"] = tree_map(lambda s: P(PIPE_AXIS, *(lead + tuple(s)[1:])),
                             spec_tree["blocks"])
    return out


class PipelineTrainer(HybridParallelModel):
    """See the module note.  ``stage`` is this rank's stage, ``schedule``
    and ``interleave`` the plan's, ``max_in_flight`` the most microbatches
    this stage held at once in the last step."""

    def __init__(self, model, plan: ExecutionPlan, mesh, opt_cfg=None):
        check_pipeline(model, plan, mesh)
        super().__init__(model=model, plan=_uniform(plan),
                         opt_cfg=opt_cfg or opt_lib.AdamWConfig(), mesh=mesh)
        self.num_stages = plan.pp
        self.schedule = plan.pp_schedule
        self.interleave = plan.pp_interleave if self.schedule == "interleaved" else 1
        self.strategy = plan.default_strategy
        self._layout()
        self.hop = mesh.hop(PIPE_AXIS)      # the stage hop; a ring has mesh.hop("cp")
        self.stage = self.hop.stage
        self._pod = mesh.group(PIPE_AXIS)
        M = self.num_micro
        self.windows = num_windows(self.schedule, self.num_stages, M)
        self.window_schedule = build_schedule(self.schedule, self.num_stages,
                                              M // self.windows, self.interleave)
        self.max_in_flight = 0

    # ------------------------------------------------------------ layout
    def _spec_tree(self, **kw) -> dict:
        return _stage_specs(super()._spec_tree(**kw), self.interleave)

    @property
    def _stacked_dims(self) -> int:
        return 2 if self.interleave == 1 else 3

    @property
    def num_micro(self) -> int:
        return max(self.plan.grad_accum, self.num_stages)

    def stage_params(self, params: dict) -> dict:
        out = dict(params)
        out["blocks"] = stage_stack(params["blocks"], self.num_stages, self.interleave)
        return out

    def group(self, params: dict) -> dict:
        return self.stage_params(params)

    def ungroup(self, params: dict) -> dict:
        out = dict(params)
        out["blocks"] = unstage_stack(params["blocks"], self.interleave)
        return out

    def loss_fn(self, params, batch, dtype=torch.bfloat16):
        raise NotImplementedError("the pipeline takes its loss inside value_and_grad, "
                                  "a microbatch at a time on the last stage")

    # ------------------------------------------------------------ stages
    def _chunk(self, blocks: dict, j: int) -> dict:
        """This stage's j-th chunk of layers, (L/(S·v), ...) views."""
        return tree_map(lambda a: a[0] if self.interleave == 1 else a[0, j], blocks)

    def _gathered(self, live: dict, key: str, dtype) -> dict:
        return self._gather_sum(live[key], self._param_zero[key], self._cast[key], dtype)

    def _embed(self, live: dict, rows: dict, dtype) -> torch.Tensor:
        """Stage 0: the microbatch's embeddings (``vis_embeds`` first) in the
        boundary layout."""
        x = embedding.embed_tokens(self._gathered(live, "embed", dtype), rows["tokens"], dtype,
                                   self.model.cfg.vocab_size)
        if "vis_embeds" in rows:
            x = torch.cat([rows["vis_embeds"].to(dtype), x], dim=1)
        return lc(x, "batch", "seq", "embed")

    def _head(self, live: dict, out: torch.Tensor, labels, count, dtype):
        """The last stage: the loss of one microbatch from its fp32 boundary
        output, its backward through the head taken here.  Returns the
        cotangent of ``out`` and the detached (loss, nll, zloss)."""
        cfg = self.model.cfg
        h = out.detach().requires_grad_()
        norm = self._gathered(live, "final_norm", dtype)
        x = rmsnorm(collectives.seq_partial(norm), h, cfg.norm_eps, self.model.impl)
        logits = embedding.lm_head(self._gathered(live, "embed", dtype), x, cfg)
        off = self.model.text_offset()
        if off:
            logits = logits[:, off:, :]
        vocab = None
        tp = collectives.tp_state()
        if tp is not None and logits.shape[-1] < cfg.vocab_size:
            vocab = (tp.group, tp.group.index * logits.shape[-1])
        loss, metrics = softmax_xent(logits, labels, vocab=vocab, count=count)
        torch.autograd.backward(loss)
        parts = torch.stack([loss.detach(), metrics["nll"].detach(), metrics["zloss"].detach()])
        return h.grad, parts

    def _boundary_shape(self, rows: dict) -> tuple:
        """This rank's local boundary tensor of a microbatch: its rows, its
        sequence (its zig-zag shard under cp, cut again over the model axis
        under SP), d_model."""
        b, seq = rows["tokens"].shape
        if "vis_embeds" in rows:
            seq += rows["vis_embeds"].shape[1]
        if shd.residual_layout(self.plan, self.strategy, self.mesh) == "seq":
            seq //= self.mesh.shape["model"]
        return (b, seq, self.model.cfg.d_model)

    # ------------------------------------------------------------ steps
    def value_and_grad(self, params, batch, dtype=torch.bfloat16):
        """(loss, metrics, grads) of the global ``batch`` under the plan's
        schedule; grads summed over every rank, laid out by ``grad_specs``
        (``gather_params(grads, grad_specs)`` gives the canonical tree)."""
        batch = {k: _to_device(v, self.device) for k, v in batch.items()}
        M, S = self.num_micro, self.num_stages
        B = batch["tokens"].shape[0]
        if B % M:
            raise ValueError(f"global batch {B} is not a multiple of the pipeline's "
                             f"{M} microbatches (max(grad_accum, pp))")
        rows = [self._local_rows({k: v.reshape((M, B // M) + tuple(v.shape[1:]))[m]
                                  for k, v in batch.items()}) for m in range(M)]
        count = self._valid_tokens(rows)
        rules = self._rules_for(rows[0])   # the ring's global length under cp
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        runner = make_layer_runner(self.plan, self.mesh,
                                   functools.partial(self._gather_layer, dtype=dtype))
        model = self.model

        def apply_block(bp, h):            # (x, cache, extra) -> x; PP drops the aux
            return model.block_apply(bp, h, mode="train")[0], 0.0

        saved: dict = {}                   # (micro, chunk) -> the forward's (input, output)
        in_flight = [0]                    # the most microbatches with a saved forward
        totals = torch.zeros(3, dtype=torch.float32, device=self.device)  # loss, nll, zloss

        def forward(a, m, got):
            inp = None
            with axis_rules(rules):
                if got is None:
                    x = self._embed(live, rows[m], dtype)
                else:
                    inp = got.requires_grad_()
                    x = inp.to(dtype)
                h, _ = runner(self._chunk(live["blocks"], a.chunk // S), x, apply_block)
                out = h.to(BOUNDARY_DTYPE)
            saved[(m, a.chunk)] = (inp, out)
            in_flight[0] = max(in_flight[0], len({k[0] for k in saved}))
            return out.detach() if a.send is not None else None

        def backward(a, m, got):
            inp, out = saved.pop((m, a.chunk))
            if a.recv is None:                    # the last chunk: the head first
                with axis_rules(rules):
                    got, parts = self._head(live, out, rows[m]["labels"], count, dtype)
                totals.add_(parts)
            torch.autograd.backward(out, got)
            return inp.grad if inp is not None else None

        shape = self._boundary_shape(rows[0])
        Mw = M // self.windows
        with torch.enable_grad():
            for w in range(self.windows):
                run_window(self.window_schedule, self.hop, forward, backward, shape,
                           offset=w * Mw)
        if saved:
            raise RuntimeError(f"the schedule left {len(saved)} forwards without a backward")
        self.max_in_flight = in_flight[0]
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), live)
        for key in grads:                 # read on some stages: summed over them
            if key != "blocks":
                grads[key] = tree_map(lambda g: collectives.all_reduce(g, self._pod),
                                      grads[key])
        grads = self._reduce_grads(grads)
        loss, nll, zloss = self._step_totals(totals).unbind(0)
        metrics = {"nll": nll, "zloss": zloss, "tokens": count, "aux": torch.zeros_like(nll)}
        return loss, metrics, grads

    def _valid_tokens(self, rows: list) -> torch.Tensor:
        """The step's valid-token count: this rank's rows of every
        microbatch, summed over the batch and cp axes (``_loss_group``)."""
        return collectives.all_reduce(
            sum((r["labels"] >= 0).sum() for r in rows).float(), self._loss_group)

    def _step_totals(self, totals: torch.Tensor) -> torch.Tensor:
        """The step's (loss, nll, zloss): the last stage's sums over its
        microbatches (the other stages add zeros) summed over the pod axis,
        then over the batch and cp axes."""
        return collectives.all_reduce(collectives.all_reduce(totals, self._pod),
                                      self._loss_group)

    def train_step(self, params, opt_state: opt_lib.AdamWState, batch: dict,
                   dtype=torch.bfloat16, *, donate: bool = False):
        """One optimizer step over the global batch: ``value_and_grad``
        under the schedule, then ``apply_grads`` (AdamW in the ``optimizer``
        span; ``donate=True`` updates in place)."""
        loss, metrics, grads = self.value_and_grad(params, batch, dtype)
        new_params, new_opt, stats = self.apply_grads(params, grads, opt_state, donate=donate)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics.update(stats)
        return new_params, new_opt, metrics
