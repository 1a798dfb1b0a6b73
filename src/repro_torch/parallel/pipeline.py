"""Schedule-aware pipeline parallelism on ``torch.distributed`` (the port of
``repro.parallel.pipeline``).

The pipeline ("pod") axis holds the stages: stage s is the set of ranks at
pod coordinate s, and within a stage the data and model axes keep DP, ZeRO,
TP and SP (``runtime/train_pp.py``).  Activations move stage to stage, and
their cotangents back, by point-to-point (``collectives.StageHop``) at the
fp32 boundary (``BOUNDARY_DTYPE``).

JAX lowers a step to one SPMD tick loop in which idle stages compute on
garbage, and lets autodiff reverse it.  Here a step is a schedule held as
plain data: for each stage, its ordered actions, each the forward or the
backward of one (microbatch, chunk), with the stage its input comes from
and the stage its output goes to.  Only real work is launched.  A
simulation lays every stage's actions out on global ticks (an action runs
once its input was sent on an earlier tick), and every rank runs the tick
table: its own action, then one ``exchange`` posting the sends of that
tick and the receives addressed to it, so every send meets its receive in
the same call, the wrap from the last stage to the first included.  The
backward of an action is driven explicitly,
``torch.autograd.backward(out, grad)`` with the cotangent received.

Schedules (``ExecutionPlan.pp_schedule``), all the same function:

* **gpipe** — every forward, then every backward: all M microbatches in
  flight on every stage;
* **1f1b** — JAX's windows of S microbatches (when the step's M windows
  evenly: ``schedule_windowable``), each window's forwards and backwards
  before the next window's; within a window, stage s runs S - 1 - s
  forwards, then one forward and one backward in turn, then the rest of
  the backwards: at most S microbatches in flight;
* **interleaved** — stage s holds v chunks, chunk j·S + s at ``[s, j]``
  (``stage_stack(..., interleave=v)``); in JAX's windows, S microbatches
  at a time go round the ring v times forward (chunk 0 to v·S - 1), then
  v times backward, as JAX's pass-sequential lowering: at most S in
  flight (a step whose M does not window takes its microbatches S at a
  time too).

``Schedule.max_in_flight`` counts the most microbatches whose activations
one stage's order holds at once; ``PipelineTrainer.max_in_flight`` counts
those it held in its last step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.models.common import tree_map

#: The stage-boundary activation dtype, as JAX's: its cost model charges
#: ``PIPELINE_BOUNDARY_BYTES_PER_ELEM`` per element of a hop, and the plan
#: verifier (GALV040) asserts the two agree.
BOUNDARY_DTYPE = torch.float32

SCHEDULES = ("gpipe", "1f1b", "interleaved")


# --------------------------------------------------------------------------
# the layout
# --------------------------------------------------------------------------

def stage_stack(blocks: dict, num_stages: int, interleave: int = 1) -> dict:
    """Stacked layer leaves (L, ...) -> (S, L/S, ...), or with
    ``interleave=v`` -> (S, v, L/(S·v), ...) where layer chunk ``c = j·S +
    s`` lands at ``[s, j]`` (stage s holds chunks s, S + s, 2S + s, ...).
    Views where the layout allows."""
    def r(a):
        L = a.shape[0]
        if L % (num_stages * interleave):
            raise ValueError(f"{L} layers do not split into {num_stages} stages x "
                             f"{interleave} chunks")
        if interleave == 1:
            return a.reshape((num_stages, L // num_stages) + tuple(a.shape[1:]))
        chunk = L // (num_stages * interleave)
        b = a.reshape((interleave, num_stages, chunk) + tuple(a.shape[1:]))
        return b.transpose(0, 1)

    return tree_map(r, blocks)


def unstage_stack(blocks: dict, interleave: int = 1) -> dict:
    """The inverse of ``stage_stack``: (L, ...) leaves in layer order."""
    def u(a):
        if interleave == 1:
            return a.reshape((-1,) + tuple(a.shape[2:]))
        b = a.transpose(0, 1)                 # (v, S, Lc, ...): chunk-major
        return b.reshape((-1,) + tuple(b.shape[3:]))

    return tree_map(u, blocks)


# --------------------------------------------------------------------------
# the schedule as data
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Action:
    """The forward (``"F"``) or backward (``"B"``) of microbatch ``micro``
    through chunk ``chunk`` (0 .. S·v - 1; it lives on stage ``chunk %
    S``).  ``recv``: the stage its input comes from (a forward's
    activation, a backward's cotangent), or None (the first chunk's
    forward embeds, the last chunk's backward starts from the loss);
    ``send``: the stage its output goes to, or None."""

    kind: str
    micro: int
    chunk: int
    recv: Optional[int]
    send: Optional[int]


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One window of ``micro`` microbatches on ``stages`` stages of
    ``interleave`` chunks each: ``order[s]`` is stage s's actions in order,
    ``ticks[t][s]`` the action stage s runs at tick t (or None)."""

    kind: str
    stages: int
    micro: int
    interleave: int
    order: tuple
    ticks: tuple

    def arrivals(self, t: int, stage: int) -> list:
        """The actions of tick t whose output comes to ``stage``."""
        return [a for a in self.ticks[t] if a is not None and a.send == stage]

    def max_in_flight(self, stage: int) -> int:
        """The most microbatches whose activations ``stage`` holds at once:
        a microbatch is in flight from its first forward there until its
        last backward there."""
        held: dict = {}
        most = 0
        for a in self.order[stage]:
            held[a.micro] = held.get(a.micro, 0) + (1 if a.kind == "F" else -1)
            if held[a.micro] == 0:
                del held[a.micro]
            most = max(most, len(held))
        return most


def _stage_order(kind: str, S: int, M: int, v: int, s: int) -> list:
    """(kind, micro, chunk) of stage s's actions in order."""
    if kind == "gpipe":
        return [("F", m, s) for m in range(M)] + [("B", m, s) for m in range(M)]
    if kind == "1f1b":
        warm = min(S - 1 - s, M)
        out = [("F", m, s) for m in range(warm)]
        for i in range(M - warm):
            out += [("F", warm + i, s), ("B", i, s)]
        return out + [("B", m, s) for m in range(M - warm, M)]
    chunks = [j * S + s for j in range(v)]
    out = []
    for first in range(0, M, S):          # S microbatches at a time round the ring
        group = range(first, min(first + S, M))
        out += ([("F", m, c) for c in chunks for m in group]
                + [("B", m, c) for c in reversed(chunks) for m in group])
    return out


def build_schedule(kind: str, stages: int, micro: int, interleave: int = 1) -> Schedule:
    """The schedule of one window (see the module note); raises where the
    stages' orders cannot all run (a deadlock is a bug of the orders)."""
    if kind not in SCHEDULES:
        raise ValueError(f"unknown schedule {kind!r}")
    if stages < 2:
        raise ValueError(f"a pipeline needs at least 2 stages, got {stages}")
    v = interleave if kind == "interleaved" else 1
    if kind == "interleaved" and v < 2:
        raise ValueError("interleaved needs at least 2 chunks a stage")
    S, C = stages, stages * v

    def action(k, m, c):
        if k == "F":
            return Action(k, m, c, (c - 1) % S if c > 0 else None,
                          (c + 1) % S if c < C - 1 else None)
        return Action(k, m, c, (c + 1) % S if c < C - 1 else None,
                      (c - 1) % S if c > 0 else None)

    order = tuple(tuple(action(*x) for x in _stage_order(kind, S, micro, v, s))
                  for s in range(S))
    done: set = set()
    ptr = [0] * S
    ticks = []
    while any(p < len(o) for p, o in zip(ptr, order)):
        row = []
        for s in range(S):
            a = order[s][ptr[s]] if ptr[s] < len(order[s]) else None
            if a is not None:
                needs = ([("F", a.micro, a.chunk - 1)] if a.kind == "F" and a.chunk > 0 else
                         [("F", a.micro, a.chunk)] + ([("B", a.micro, a.chunk + 1)]
                                                     if a.chunk < C - 1 else [])
                         if a.kind == "B" else [])
                if not all(n in done for n in needs):
                    a = None
            row.append(a)
        if all(a is None for a in row):
            raise RuntimeError(f"{kind} schedule on {S} stages, {micro} microbatches, "
                               f"{v} chunks a stage deadlocks at tick {len(ticks)}")
        for s, a in enumerate(row):
            if a is not None:
                done.add((a.kind, a.micro, a.chunk))
                ptr[s] += 1
        ticks.append(tuple(row))
    return Schedule(kind, S, micro, v, order, tuple(ticks))


def num_windows(kind: str, stages: int, micro: int) -> int:
    """Windows a step of ``micro`` microbatches runs in, as JAX's
    ``PipelineTrainer._num_windows``: 1f1b and interleaved window M into
    rounds of S when S divides it (``schedule_windowable``), gpipe never."""
    if kind in ("1f1b", "interleaved") and micro > stages and micro % stages == 0:
        return micro // stages
    return 1


# --------------------------------------------------------------------------
# execution of one window
# --------------------------------------------------------------------------

def run_window(schedule: Schedule, hop, forward: Callable, backward: Callable,
               shape: tuple, offset: int = 0) -> None:
    """Run this rank's part of one window: for each tick, its action —
    ``forward(action, micro, inbox)`` returns the fp32 boundary tensor to
    send (or None on the last chunk), ``backward(action, micro, inbox)``
    the input's cotangent to send (or None on the first chunk); ``inbox``
    is the tensor received for the action (or None), ``micro`` the
    microbatch's index in the step (``offset`` + its index in the window)
    — then one ``hop.exchange`` of the tick's sends and of the receives
    addressed to this stage, each a ``BOUNDARY_DTYPE`` tensor of
    ``shape``."""
    stage = hop.stage
    inbox: dict = {}
    for t, row in enumerate(schedule.ticks):
        a = row[stage]
        sends = []
        if a is not None:
            got = inbox.pop((a.kind, a.micro, a.chunk)) if a.recv is not None else None
            run = forward if a.kind == "F" else backward
            out = run(a, offset + a.micro, got)
            if a.send is not None:
                sends.append((a.send, out))
        arrivals = schedule.arrivals(t, stage)
        got = hop.exchange(sends, [(b.chunk % schedule.stages, shape, BOUNDARY_DTYPE)
                                   for b in arrivals])
        for b, x in zip(arrivals, got):
            nxt = b.chunk + 1 if b.kind == "F" else b.chunk - 1
            inbox[(b.kind, b.micro, nxt)] = x
    if inbox:
        raise RuntimeError(f"window left {len(inbox)} tensors unread")
