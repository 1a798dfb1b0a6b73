"""Spawned gloo ranks for the port's parallel-runtime tests.

``run_ranks(world, target, payload, tmp)`` starts ``world`` fresh Python
processes (``subprocess``, so it works under any pytest worker), each
running this file as a script, joined by gloo over a ``FileStore`` in
``tmp`` (never a TCP port: test files run in parallel); each calls this
module's function ``target`` on ``payload`` and the call returns every
rank's result.  A rank that raises fails the call with its traceback.  The
ranks import torch and ``repro_torch`` only, never JAX, and need no
``tests`` package on their path.

The rank-side functions below train one case on a mesh: ``place_params``
from the canonical weights, ``value_and_grad`` and one ``train_step`` on
the global batch, and the results gathered back to the canonical trees;
they also collect the runtime's refusals and an all-reduce fit, and
compare a one-rank mesh's steps with ``mesh=None``'s; ``pipeline_cases``
does the same for ``PipelineTrainer`` under each schedule, on a (pod,
data, model) or a (pod, cp, data, model) mesh.  A case may run on a (cp,
data, model) mesh, and with a context-parallel fault brought in
(``inject_fault``); ``ring_ops`` runs the cp ring alone; ``checkpoint_cases``
saves a checkpoint under one plan and restores it under others;
``elastic_cases`` checks a mesh over a prefix of the ranks and migrates a
training state through a shrink, a grow and a pipeline restage;
``serve_cases`` serves through the step engine on a mesh.
``references`` builds a case and its two single-device references in the
test process (the only function here that imports JAX).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import pathlib
import subprocess
import sys
import traceback

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def run_ranks(world: int, target: str, payload, tmp, timeout: float = 300.0) -> list:
    """``target`` names a function of this module; see the module note."""
    tmp = pathlib.Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(payload, tmp / "payload.pt")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()),
         str(rank), str(world), str(tmp), target],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        path = tmp / f"result{rank}.pt"
        if p.returncode != 0 or not path.is_file():
            raise RuntimeError(f"rank {rank} exited {p.returncode}:\n{out}")
        res = torch.load(path, weights_only=False)
        if "error" in res:
            raise RuntimeError(f"rank {rank} raised:\n{res['error']}")
        results.append(res["result"])
    return results


def _child() -> None:
    import torch.distributed as dist

    rank, world, tmp, target = (int(sys.argv[1]), int(sys.argv[2]), pathlib.Path(sys.argv[3]),
                                sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), world),
                            rank=rank, world_size=world)
    try:
        out = {"result": globals()[target](torch.load(tmp / "payload.pt", weights_only=False))}
    except Exception:
        out = {"error": traceback.format_exc()}
    torch.save(out, tmp / f"result{rank}.pt")
    dist.destroy_process_group()


# --------------------------------------------------------------------------
# rank side
# --------------------------------------------------------------------------

def plan_of(arch: str, num_layers: int, mesh_shape, strategies, grad_accum: int = 1,
            axes=("data", "model")):
    """An ExecutionPlan over ``axes`` with one strategy per layer (the first
    is the default, as a uniform plan's)."""
    from repro_torch.core.strategy import ExecutionPlan

    strategies = list(strategies)
    if len(strategies) == 1:
        strategies = strategies * num_layers
    return ExecutionPlan(arch=arch, shape="train", mesh_axes=tuple(axes),
                         mesh_shape=tuple(mesh_shape), grad_accum=grad_accum,
                         layer_strategies=strategies, default_strategy=strategies[0])


def train_cases(payload: dict) -> dict:
    """Every case of ``payload["cases"]`` on a ``payload["mesh"]`` mesh of
    ranks: (loss, grads) of ``value_and_grad`` and (loss, grad norm, new
    params) of one ``train_step``, in the case's ``dtype`` (fp32 unless
    given), gathered to canonical trees; at one microbatch, whether
    ``apply_grads`` on those grads gives the step's params bitwise.
    Rank 0 returns them; the others return None.  A case may name its own
    ``mesh`` and ``axes`` (default ``payload["mesh"]`` over ("data",
    "model")), and a ``fault`` (``inject_fault``)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime.train import construct_hybrid_parallel_model

    from repro_torch.models.common import tree_map

    device = torch.device(payload.get("device", "cpu"))
    if device.type == "cuda":                       # every rank on the one card
        device = torch.device("cuda", device.index or 0)
        torch.cuda.set_device(device)
    meshes: dict = {}

    def mesh_of(shape, axes):
        if (shape, axes) not in meshes:
            meshes[shape, axes] = make_mesh(shape, axes, device=device,
                                            backend=payload.get("backend"))
        return meshes[shape, axes]

    out = {}
    for case in payload["cases"]:
        cfg = case["cfg"]
        shape = tuple(case.get("mesh", payload.get("mesh")))
        axes = tuple(case.get("axes", ("data", "model")))
        mesh = mesh_of(shape, axes)
        plan = plan_of(cfg.name, cfg.num_layers, shape, case["strategies"],
                       case.get("grad_accum", 1), axes)
        hp = construct_hybrid_parallel_model(build_model(cfg, device=device), plan, mesh,
                                             payload.get("opt"))
        params = hp.place_params(tree_map(lambda x: x.to(device), case["params"]))
        batch = case["batch"]
        dtype = case.get("dtype", torch.float32)
        with (inject_fault(hp, case["fault"]) if case.get("fault") else contextlib.nullcontext()):
            loss, _, grads = hp.value_and_grad(params, batch, dtype)
            applied, _, _ = hp.apply_grads(params, grads, hp.init_opt_state(params))
            grads = hp.gather_params(grads, hp.grad_specs)
            new, _, metrics = hp.train_step(params, hp.init_opt_state(params), batch, dtype)
        # at one microbatch the step is value_and_grad, then apply_grads
        applied_is_step = (all(torch.equal(a, b) for a, b in zip(_flat(applied).values(),
                                                                 _flat(new).values()))
                           if case.get("grad_accum", 1) == 1 else None)
        back = hp.gather_params(params)
        roundtrip = all(torch.equal(a.cpu(), b) for a, b in zip(_flat(back).values(),
                                                                _flat(case["params"]).values()))
        cpu = lambda tree: tree_map(lambda x: x.cpu(), tree)
        res = {"vg_loss": float(loss), "grads": cpu(grads), "step_loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]), "new": cpu(hp.gather_params(new)),
               "roundtrip": roundtrip and _flat(back).keys() == _flat(case["params"]).keys(),
               "applied_is_step": applied_is_step,
               "local_shapes": {k: tuple(v.shape) for k, v in _flat(params).items()}}
        if case.get("aux_weights"):
            res["aux"] = aux_runs(hp, params, batch, dtype, case["aux_weights"])
        if case.get("naive_groups"):
            res["naive_loss"] = naive_groups_loss(hp, params, batch, dtype)
        out[case["name"]] = res if dist.get_rank() == 0 else None
    return out


@contextlib.contextmanager
def inject_fault(hp, fault: str):
    """A context-parallel fault, for the tests that must see it: ``"count"``
    normalises the loss by the valid tokens of the batch axes alone (cp
    dropped from the count; a ``PipelineTrainer`` reads its count before
    the forward, in ``_valid_tokens``); ``"rope"`` gives RoPE (and the
    ring's step 0) the shard's local ``arange`` in place of its global
    positions; ``"contiguous"`` hands each rank a contiguous S/cp block of
    the tokens and labels, at that block's positions, to the zig-zag ring;
    ``"seq_len"`` gives the ring's rules the shard's local length in place
    of the microbatch's global one (``_rules_for``); ``"totals"`` sums a
    ``PipelineTrainer``'s (loss, nll, zloss) over the pod and batch axes
    alone (cp dropped; ``_step_totals``)."""
    import numpy as np

    from repro_torch.parallel import collectives, context
    from repro_torch.runtime import train as rt

    kept = (rt.softmax_xent, context.zigzag_positions, context.zigzag_shard)
    if fault == "count":
        rt.softmax_xent = lambda *a, dp=None, **kw: kept[0](*a, dp=hp._batch_group, **kw)
        if hasattr(hp, "_valid_tokens"):
            hp._valid_tokens = lambda rows: collectives.all_reduce(
                sum((r["labels"] >= 0).sum() for r in rows).float(), hp._batch_group)
    elif fault == "seq_len":
        hp._rules_for = lambda rows: dataclasses.replace(hp._default_rules,
                                                         seq_len=rows["tokens"].shape[1])
    elif fault == "totals":
        hp._step_totals = lambda t: collectives.all_reduce(collectives.all_reduce(t, hp._pod),
                                                           hp._batch_group)
    elif fault == "rope":
        context.zigzag_positions = lambda S, cp, index, device=None: torch.arange(
            S // cp, dtype=torch.int32, device=device)
    elif fault == "contiguous":
        def positions(S, cp, index, device=None):
            n = S // cp
            return torch.from_numpy(np.arange(index * n, (index + 1) * n, dtype=np.int32)
                                    ).to(device)

        def shard(x, dim, index, cp):
            n = x.shape[dim] // cp
            return x.narrow(dim, index * n, n).contiguous()

        context.zigzag_positions, context.zigzag_shard = positions, shard
    else:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        rt.softmax_xent, context.zigzag_positions, context.zigzag_shard = kept
        for name in ("_valid_tokens", "_rules_for", "_step_totals"):
            hp.__dict__.pop(name, None)


def ring_ops(payload: dict) -> dict:
    """On a (cp, 1, 1) mesh of every rank: this rank's zig-zag shard of
    seeded (B, S, H, hd) q and compact k / v (``payload``: shape, KV,
    causal) through ``context.ring_attention_local`` (``impl="ref"``) and
    ``context.positional_ring_local`` (JAX's positional form over
    ``collectives.ring_shift``): each one's output and its grads at a
    seeded cotangent, and the hop's bytes."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import context

    cp = dist.get_world_size()
    mesh = make_mesh((cp, 1, 1), ("cp", "data", "model"), device="cpu")
    hop = mesh.hop("cp")
    B, S, H, hd = payload["shape"]
    gen = torch.Generator().manual_seed(payload.get("seed", 0))
    q = torch.randn(B, S, H, hd, generator=gen)
    k, v = (torch.randn(B, S, payload["kv"], hd, generator=gen) for _ in range(2))
    g = torch.randn(B, S, H, hd, generator=gen)
    mine = lambda a: context.zigzag_shard(a, 1, hop.stage, cp)
    pos = context.zigzag_positions(S, cp, hop.stage)
    out = {}
    for name, fn in (("half", lambda *a: context.ring_attention_local(
            *a, pos, causal=payload["causal"], hop=hop, impl="ref")),
                     ("positional", lambda *a: context.positional_ring_local(
                         *a, pos, causal=payload["causal"], hop=hop))):
        qs, ks, vs = (mine(a).requires_grad_() for a in (q, k, v))
        hop.bytes.update(sent=0, received=0, host_copies=0)
        y = fn(qs, ks, vs)
        grads = torch.autograd.grad((y * mine(g)).sum(), (qs, ks, vs))
        out[name] = {"out": y.detach(), "grads": grads, "bytes": dict(hop.bytes)}
    return out


def pipeline_cases(payload: dict) -> dict:
    """Every case of ``payload["cases"]`` under each of its schedules on a
    mesh of ``case["mesh"]`` over ``case["axes"]`` ((pod, data, model) by
    default; (pod, cp, data, model) for pp x cp): ``PipelineTrainer``'s
    (loss, grads) of ``value_and_grad`` and (loss, grad norm, new params) of
    one ``train_step``, in fp32, gathered to canonical trees (rank 0), the
    stage hop's bytes over both and the local boundary shape, and on every
    rank its stage's ``max_in_flight`` and its (cp index, valid tokens of
    its rows of the batch); a case may name a ``fault``
    (``inject_fault``).  Then the message each plan of
    ``payload["refused"]`` raises (its strategy, or one a layer), and with ``payload["ring"]`` a ring
    shift of the stage hop on (2, 1, 2) (``shift`` and ``exchange``, the
    wrap included).  ``payload["device"]`` and ``["backend"]`` as
    ``train_cases``'."""
    import torch.distributed as dist

    from repro_torch.core.strategy import ExecutionPlan
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.parallel.collectives import StageHop
    from repro_torch.runtime.train_pp import PipelineTrainer

    pp_axes = ("pod", "data", "model")
    meshes: dict = {}
    device = torch.device(payload.get("device", "cpu"))
    if device.type == "cuda":                       # every rank on the one card
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)

    def mesh_of(shape, axes=pp_axes):
        if (shape, axes) not in meshes:
            meshes[shape, axes] = make_mesh(shape, axes, device=device,
                                            backend=payload.get("backend"))
        return meshes[shape, axes]

    def plan_of(cfg, shape, strategy, schedule, v, ga, axes=pp_axes):
        layers = strategy if isinstance(strategy, list) else [strategy] * cfg.num_layers
        return ExecutionPlan(arch=cfg.name, shape="train", mesh_axes=axes,
                             mesh_shape=tuple(shape), pp=shape[0], pp_schedule=schedule,
                             pp_interleave=v, grad_accum=ga, layer_strategies=layers,
                             default_strategy=layers[0])

    cpu = lambda tree: tree_map(lambda x: x.detach().cpu(), tree)
    out = {"runs": {}, "in_flight": {}, "counts": {}, "refused": {}}
    for case in payload["cases"]:
        cfg, shape = case["cfg"], tuple(case["mesh"])
        axes = tuple(case.get("axes", pp_axes))
        for schedule, v in case["schedules"]:
            key = f"{case['name']}/{schedule}"
            plan = plan_of(cfg, shape, case["strategies"][0], schedule, v, case["grad_accum"],
                           axes)
            tr = PipelineTrainer(build_model(cfg, device=device), plan, mesh_of(shape, axes),
                                 payload.get("opt"))
            params = tr.place_params(tree_map(lambda x: x.to(device), case["params"]))
            tr.hop.bytes.update(sent=0, received=0, host_copies=0)
            with (inject_fault(tr, case["fault"]) if case.get("fault")
                  else contextlib.nullcontext()):
                loss, _, grads = tr.value_and_grad(params, case["batch"], torch.float32)
                applied, _, _ = tr.apply_grads(params, grads, tr.init_opt_state(params))
                grads = tr.gather_params(grads, tr.grad_specs)
                new, _, metrics = tr.train_step(params, tr.init_opt_state(params),
                                                case["batch"], torch.float32)
            applied_is_step = all(torch.equal(a, b) for a, b in zip(_flat(applied).values(),
                                                                    _flat(new).values()))
            back, new = cpu(tr.gather_params(params)), tr.gather_params(new)
            roundtrip = (_flat(back).keys() == _flat(case["params"]).keys() and all(
                torch.equal(a, b) for a, b in zip(_flat(back).values(),
                                                  _flat(case["params"]).values())))
            out["in_flight"][key] = (tr.stage, tr.max_in_flight,
                                     tr.window_schedule.max_in_flight(tr.stage), tr.windows)
            local = tr._local_rows({k: torch.as_tensor(x).to(device)
                                    for k, x in case["batch"].items()})
            out["counts"][key] = (tr._cp_group.index if tr._cp_group else 0,
                                  int((local["labels"] >= 0).sum()))
            M = tr.num_micro
            first = tr._local_rows({k: torch.as_tensor(x).to(device)[:x.shape[0] // M]
                                    for k, x in case["batch"].items()})
            if dist.get_rank() == 0:
                out["runs"][key] = {
                    "vg_loss": float(loss), "grads": cpu(grads),
                    "step_loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]), "new": cpu(new),
                    "roundtrip": roundtrip, "applied_is_step": applied_is_step,
                    "local_shapes": {k: tuple(x.shape) for k, x in _flat(params).items()},
                    "hop_bytes": dict(tr.hop.bytes),
                    "boundary_shape": tr._boundary_shape(first)}
    for name, (cfg, shape, strategy, schedule, v, *axes) in payload.get("refused", {}).items():
        axes = tuple(axes[0]) if axes else pp_axes
        try:
            PipelineTrainer(build_model(cfg, device="cpu"),
                            plan_of(cfg, shape, strategy, schedule, v, 1, axes),
                            mesh_of(shape, axes))
            out["refused"][name] = None
        except Exception as e:          # the test reads each refusal's type and text
            out["refused"][name] = (type(e).__name__, str(e))
    if not payload.get("ring"):
        return out
    hop = StageHop(mesh_of((2, 1, 2)))
    mine = torch.full((3,), float(dist.get_rank()))
    got = hop.shift(mine)
    both = hop.exchange([((hop.stage + 1) % 2, mine + 10)], [((hop.stage - 1) % 2, (3,),
                                                              torch.float32)])[0]
    out["ring"] = (hop.stage, float(got[0]), float(both[0]))
    return out


def checkpoint_cases(payload: dict) -> dict:
    """A checkpoint saved under one plan and restored under others, on 2
    ranks in fp32: (a) one ``train_step`` under tp 2 + sp, ZeRO-1 on (data
    1, model 2) from ``payload["params"]`` on ``payload["batches"][0]``,
    its ``checkpoint_state`` saved by rank 0 into ``payload["dir"]`` at
    step 1 while rank 1 waits at a barrier; (b) that step restored under
    ZeRO-3 on (data 2, model 1), ``checkpoint_state`` of the placed state
    against the restored trees, then one ``train_step`` on
    ``batches[1]``; (c) the restored state placed on a ``PipelineTrainer``
    at pp 2 / 1f1b on (pod 2, data 1, model 1) and given back by its
    ``checkpoint_state``.  Rank 0 returns the saved canonical state, (b)'s
    loss, grad norm and canonical state after its step, and whether (b)
    and (c) gave the restored state back bitwise."""
    import torch.distributed as dist

    from repro_torch.core.strategy import ExecutionPlan, LayerStrategy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.runtime.train import construct_hybrid_parallel_model
    from repro_torch.runtime.train_pp import PipelineTrainer

    cfg, opt_cfg, directory = payload["cfg"], payload["opt"], payload["dir"]
    b0, b1 = payload["batches"]
    L = cfg.num_layers
    host = lambda *trees: {k: v.detach().clone() for k, v in ckpt._flatten(trees).items()}
    same = lambda a, b: a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)

    def trainer(shape, strategy):
        plan = plan_of(cfg.name, L, shape, [strategy])
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        return construct_hybrid_parallel_model(build_model(cfg, device="cpu"), plan, mesh,
                                               opt_cfg), plan

    hp, plan = trainer((1, 2), LayerStrategy(tp=2, sp=True, zero=1))
    params = hp.place_params(payload["params"])
    params, opt, _ = hp.train_step(params, hp.init_opt_state(params), b0, torch.float32)
    saved = hp.checkpoint_state(params, opt)
    if dist.get_rank() == 0:
        ckpt.save(directory, 1, *saved, plan)
    dist.barrier()

    hp, _ = trainer((2, 1), LayerStrategy(zero=3))
    restored = ckpt.restore(directory, params_like=saved[0], opt_like=saved[1])
    want = host(restored["params"], restored["opt"])
    params, opt = hp.place_params(restored["params"]), hp.place_opt_state(restored["opt"])
    zero3_back = same(host(*hp.checkpoint_state(params, opt)), want)
    new, new_opt, metrics = hp.train_step(params, opt, b1, torch.float32)
    after = host(*hp.checkpoint_state(new, new_opt))

    pp_plan = ExecutionPlan(arch=cfg.name, shape="train", mesh_axes=("pod", "data", "model"),
                            mesh_shape=(2, 1, 1), pp=2, pp_schedule="1f1b", grad_accum=2,
                            layer_strategies=[LayerStrategy()] * L,
                            default_strategy=LayerStrategy())
    tr = PipelineTrainer(build_model(cfg, device="cpu"), pp_plan,
                         make_mesh((2, 1, 1), ("pod", "data", "model"), device="cpu"), opt_cfg)
    staged = tr.place_params(restored["params"]), tr.place_opt_state(restored["opt"])
    pp_back = same(host(*tr.checkpoint_state(*staged)), want)
    if dist.get_rank() != 0:
        return None
    return {"saved": host(*saved), "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]), "after": after,
            "zero3_back": zero3_back, "pp_back": pp_back}


def _prefix_mesh() -> dict:
    """A (data 1, model 2) mesh over the first 2 ranks: this rank's
    membership, its groups' (size, index), the sum of ``rank + 1`` over the
    model group (members), the error a non-member's ``group`` raises and
    its repr, and the refusals of a prefix that is not the mesh's size."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 2), ("data", "model"), device="cpu", ranks=2)
    out = {"member": mesh.member, "coords": mesh.coords, "repr": repr(mesh)}
    if mesh.member:
        out["groups"] = {k: (g.size, g.index) for k, g in mesh._groups.items()}
        x = torch.tensor([float(dist.get_rank() + 1)])
        dist.all_reduce(x, group=mesh.group("model").pg)
        out["model_sum"] = float(x)
    else:
        try:
            mesh.group("model")
        except ValueError as e:
            out["group_error"] = str(e)
    refused = []
    for shape, ranks in (((1, 2), 3), ((1, 4), 5)):
        try:
            make_mesh(shape, ("data", "model"), device="cpu", ranks=ranks)
        except ValueError as e:
            refused.append(str(e))
    out["refused"] = refused
    return out


def _digests(tree_pair) -> dict:
    """{leaf key: SHA-256 of its bytes} of a (params, opt) pair."""
    import hashlib

    from repro_torch.runtime import checkpoint as ckpt

    out = {}
    for k, x in ckpt._flatten(tree_pair).items():
        x = x.detach().cpu().contiguous()
        out[k] = hashlib.sha256(x.reshape(-1).view(torch.uint8).numpy().tobytes()).hexdigest()
    return out


def elastic_cases(payload: dict) -> dict:
    """On 4 ranks in fp32: ``_prefix_mesh``; then one ``train_step`` under
    ``payload["plans"][0]`` from ``payload["params"]``, and for each later
    (name, plan) of ``payload["plans"]`` a migration onto it (every plan's
    mesh over the first ranks it needs): ``migrate`` and
    ``migrate_via_checkpoint`` (async and sync in turn) from the same
    state, whether they agree bitwise on this rank, the canonical state's
    digests before (old mesh) and after (new mesh), then on the new mesh
    ``value_and_grad`` and a donated ``train_step`` of the in-memory state
    on the next batch against an undonated step of the checkpoint state
    (bitwise), training going on from the former.  Rank 0 also returns the
    canonical state before each migration (CPU) and, after it, the loss,
    the canonical grads, the step's loss and the canonical params after
    it.  Last, the launcher's ``_apply_resize`` onto a plan mixing cp 1 and
    cp 2 (``payload["mixed"]``): the exception each rank raises, and
    whether its running trainer is unchanged."""
    import types

    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.core.cluster import H100_NODE8
    from repro_torch.core.strategy import ExecutionPlan
    from repro_torch.launch import train as launcher
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.runtime import resize
    from repro_torch.runtime.elastic import ElasticEvent

    rank = dist.get_rank()
    cfg, opt_cfg, batches = payload["cfg"], payload["opt"], payload["batches"]
    model = build_model(cfg, device="cpu")
    cpu = lambda tree: tree_map(lambda x: x.detach().clone(), tree)

    def trainer(spec):
        shape, axes, strategy, pp, schedule, ga = spec
        plan = ExecutionPlan(arch=cfg.name, shape="train", mesh_axes=axes, mesh_shape=shape,
                             pp=pp, pp_schedule=schedule, grad_accum=ga,
                             layer_strategies=[strategy] * cfg.num_layers,
                             default_strategy=strategy)
        n = 1
        for s in shape:
            n *= s
        return resize.make_trainer(model, plan, make_mesh(shape, axes, device="cpu", ranks=n),
                                   opt_cfg)

    out = {"mesh": _prefix_mesh(), "events": {}}
    (_, first), *later = payload["plans"]
    hp = trainer(first)
    params = hp.place_params(payload["params"])
    params, opt, _ = hp.train_step(params, hp.init_opt_state(params), batches[0], torch.float32)
    gen = torch.Generator().manual_seed(5)
    for i, (name, spec) in enumerate(later):
        new = trainer(spec)
        rec = {"old_member": resize.holds_state(hp), "new_member": resize.holds_state(new)}
        if resize.holds_state(hp):
            before = hp.checkpoint_state(params, opt)
            rec["before"] = _digests(before)
            if rank == 0:
                rec["state"] = cpu(before[0]), type(before[1])(
                    step=before[1].step.clone(), m=cpu(before[1].m), v=cpu(before[1].v))
            del before
        carry = resize.CarryState(step=i + 1, samples_seen=8 * (i + 1), rng=gen)
        p_mem, o_mem, carried, rep = resize.migrate(hp, new, params, opt, carry)
        p_ck, o_ck, _, rep_ck = resize.migrate_via_checkpoint(hp, new, params, opt, carry,
                                                              step=i + 1,
                                                              async_write=i % 2 == 0)
        rec.update(spec=rep.spec.summary(), restage=rep.spec.restage,
                   paths=(rep.path, rep_ck.path), moved=(rep.bytes_moved, rep_ck.bytes_moved),
                   carried=(carried.step, carried.samples_seen, carried.rng is not gen))
        if resize.holds_state(new):
            rec["bitwise"] = _digests((p_mem, o_mem)) == _digests((p_ck, o_ck))
            rec["after"] = _digests(new.checkpoint_state(p_mem, o_mem))
            batch = batches[i + 1]
            loss, _, grads = new.value_and_grad(p_mem, batch, torch.float32)
            grads = new.gather_params(grads, new.grad_specs)
            p_mem, o_mem, m_mem = new.train_step(p_mem, o_mem, batch, torch.float32,
                                                 donate=True)
            p_ck, o_ck, m_ck = new.train_step(p_ck, o_ck, batch, torch.float32)
            rec["step_bitwise"] = (torch.equal(m_mem["loss"], m_ck["loss"])
                                   and _digests((p_mem, o_mem)) == _digests((p_ck, o_ck)))
            stepped = new.gather_params(p_mem)
            if rank == 0:
                rec.update(vg_loss=float(loss), grads=cpu(grads),
                           step_loss=float(m_mem["loss"]), new=cpu(stepped))
        params, opt, hp = p_mem, o_mem, new
        del p_ck, o_ck
        out["events"][name] = rec

    mixed = payload["mixed"]
    run = launcher._Run(hp, params, opt)
    kept = launcher.replan_and_diff
    launcher.replan_and_diff = lambda *a, **k: (mixed, resize.diff_plans(run.plan, mixed))
    args = types.SimpleNamespace(seq=32, batch=8, elastic_mode="live", ckpt_async="on")
    try:
        launcher._apply_resize(cfg, args, ElasticEvent(run.plan.num_devices, 4, "simulated"),
                               run, resize.CarryState(step=len(later) + 1), obs.NullSink(),
                               H100_NODE8, None, torch.device("cpu"), say=lambda *a: None)
        out["mixed"] = None
    except Exception as e:          # the test reads the refusal's type and text
        out["mixed"] = (type(e).__name__, str(e))
    finally:
        launcher.replan_and_diff = kept
    out["mixed_kept"] = run.hp is hp and run.params is params
    return out


def aux_runs(hp, params, batch, dtype, weights) -> dict:
    """weight -> (loss, canonical grads) of ``value_and_grad`` with the
    runtime's ``AUX_LOSS_WEIGHT`` set to each weight in turn."""
    from repro_torch.models.common import tree_map
    from repro_torch.runtime import train as rt

    out, kept = {}, rt.AUX_LOSS_WEIGHT
    try:
        for w in weights:
            rt.AUX_LOSS_WEIGHT = w
            loss, _, grads = hp.value_and_grad(params, batch, dtype)
            out[w] = (float(loss), tree_map(lambda x: x.cpu(), hp.gather_params(
                grads, hp.grad_specs if hp.mesh is not None else None)))
    finally:
        rt.AUX_LOSS_WEIGHT = kept
    return out


def naive_groups_loss(hp, params, batch, dtype) -> float:
    """The loss of ``value_and_grad`` with every rank handed all of a Mamba2
    layer's B/C groups (``mamba2.local_groups`` returning them all), as a
    naive port would: K3 then maps local head j to group j // (H_local / G)
    rather than to the group its global head reads."""
    from repro_torch.models import mamba2

    kept = mamba2.local_groups
    mamba2.local_groups = lambda H, G, tp, rank: (0, G)
    try:
        loss, _, _ = hp.value_and_grad(params, batch, dtype)
    finally:
        mamba2.local_groups = kept
    return float(loss)


def exchange_rows(payload: dict) -> dict:
    """On every rank of a (world, 1) mesh: ``collectives.exchange`` of
    seeded rows by uneven split sizes over the data axis, forward and
    backward (the grad of a seeded weighted sum of the rows received),
    against the same rows moved by a plain gather and its backward, from
    every rank's rows and weights (each rank draws them all from the seed).
    ``payload["silent"]`` names ranks that send and receive nothing.
    Returns whether each is bitwise, and the padded rows' sum."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import collectives

    device = torch.device(payload.get("device", "cpu"))
    if device.type == "cuda":
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    group = make_mesh((world, 1), ("data", "model"), device=device,
                      backend=payload.get("backend")).group("data")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator().manual_seed(payload.get("seed", 0))
        splits = torch.randint(0, 4, (world, world), generator=gen)           # s -> d
        for r in payload.get("silent", ()):     # ranks that send and receive nothing
            splits[r, :] = splits[:, r] = 0
        splits = splits.tolist()
        rows = [torch.randn(sum(splits[s]), 8, generator=gen).to(dtype) for s in range(world)]
        weights = [torch.randn(sum(splits[s][d] for s in range(world)), 8,
                               generator=gen).to(dtype) for d in range(world)]
        first = lambda s, d: sum(splits[s][:d])
        plain = torch.cat([rows[s][first(s, rank):first(s, rank) + splits[s][rank]]
                           for s in range(world)])
        # the grad of my rows: each destination's weights at the rows I sent it
        plain_grad = torch.cat([weights[d][sum(splits[s][d] for s in range(rank)):][
            :splits[rank][d]] for d in range(world)])
        x = rows[rank].to(device).requires_grad_()
        recv = [splits[s][rank] for s in range(world)]
        got = collectives.exchange(x, splits[rank], recv, group)
        n = sum(recv)
        (got[:n] * weights[rank].to(device)).sum().backward()
        name = str(dtype).split(".")[-1]
        out[name] = {"rows": torch.equal(got[:n].cpu(), plain),
                     "grad": torch.equal(x.grad.cpu(), plain_grad),
                     "padding": float(got[n:].float().abs().sum()),
                     "shape": tuple(got.shape), "received": n}
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def one_rank_steps(payload: dict) -> dict:
    """On one rank, for each ``payload["cases"]`` entry (name -> (arch,
    strategy)): two bf16 ``train_step``s of the reduced config on a (1, 1)
    mesh and with ``mesh=None``, from the same seed-0 weights and batches.
    Returns name -> (losses on the mesh, losses without, the paths of the
    params that are not bitwise equal after the steps)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.strategy import uniform_plan
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_paths
    from repro_torch.runtime.data import SyntheticDataset
    from repro_torch.runtime.train import construct_hybrid_parallel_model

    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    out = {}
    for name, (arch, strategy) in payload["cases"].items():
        cfg = get_config(arch).reduced()
        ds = SyntheticDataset(cfg, 32, 4, seed=2)
        runs = []
        for m in (mesh, None):
            shape, axes = ((1,), ("data",)) if m is None else ((1, 1), ("data", "model"))
            plan = uniform_plan(cfg.name, "t", shape, axes, cfg.num_layers, strategy)
            hp = construct_hybrid_parallel_model(build_model(cfg, device="cpu"), plan, m)
            params = hp.init_params(torch.Generator().manual_seed(0))
            opt = hp.init_opt_state(params)
            losses = []
            for step in range(2):
                params, opt, metrics = hp.train_step(params, opt, ds.batch(step))
                losses.append(float(metrics["loss"]))
            runs.append((losses, dict(tree_paths(hp.gather_params(params)))))
        (l_mesh, p_mesh), (l_one, p_one) = runs
        out[name] = (l_mesh, l_one,
                     sorted(".".join(k) for k in p_one if not torch.equal(p_mesh[k], p_one[k])))
    return out


def refusals_and_fit(payload: dict) -> dict:
    """On 2 ranks: the message each refused plan raises (``payload["refused"]``:
    name -> (arch, mesh shape, strategy or one strategy a layer, pp[,
    overrides of the reduced config]); a 3-d mesh is (cp, data, model), a
    2-d one (data, model)), and ``measure_allreduce``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import profiler_hw
    from repro_torch.core.strategy import ExecutionPlan
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime.train import construct_hybrid_parallel_model

    out = {}
    meshes = {}
    for name, (arch, shape, strategy, pp, *more) in payload["refused"].items():
        cfg = dataclasses.replace(get_config(arch).reduced(), **(more[0] if more else {}))
        axes = ("cp", "data", "model") if len(shape) == 3 else ("data", "model")
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, axes, device="cpu")
        layers = strategy if isinstance(strategy, list) else [strategy] * cfg.num_layers
        plan = ExecutionPlan(arch=arch, shape="train", mesh_axes=axes,
                             mesh_shape=shape, pp=pp, layer_strategies=layers,
                             default_strategy=layers[0])
        try:
            construct_hybrid_parallel_model(build_model(cfg, device="cpu"), plan,
                                            meshes[shape])
            out[name] = None
        except Exception as e:          # the test reads each refusal's type and text
            out[name] = (type(e).__name__, str(e))
    fit = profiler_hw.measure_allreduce(iters=3)
    out["fit"] = (fit.alpha, fit.beta, fit.r2)
    return out


def serve_cases(payload: dict) -> dict:
    """Every case of ``payload["cases"]`` through the serving engine on a
    mesh of ranks (a case names its ``mesh`` over ("data", "model") and its
    ``tp``, ZeRO 0), fp32 on the CPU: the prefill's global logits and the
    gathered cache, each teacher-forced decode step's logits (the case's
    ``steps``: tokens, ``cache_index``, ``kv_len``), the gathered cache after
    them, ``greedy_generate``'s tokens, ``cache_specs``, this rank's local
    cache shapes and the ones ``init_cache`` gives under the engine's rules
    ({leaf path: shape}, a flat or nested cache alike), and this rank's own
    ``conv_B`` / ``conv_C`` after the prefill and after the steps (an SSM
    state's, which every rank of the model axis holds whole).  A case with
    ``naive_groups`` also prefills with every rank handed all of a Mamba2
    layer's B/C groups (``naive_groups``' logits).  ``payload["device"]``
    (default the CPU) is where the ranks compute (the kernels on a card,
    their plain versions on the CPU), ``payload["backend"]`` the mesh's
    (default ``make_mesh``'s: gloo on the CPU, NCCL on a card, which
    refuses ranks that share one).  Every rank returns its results, on the
    CPU."""
    from repro_torch import serving
    from repro_torch.core.strategy import LayerStrategy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model, mamba2
    from repro_torch.models.common import tree_paths
    from repro_torch.parallel.axes import axis_rules

    def shapes(tree):
        return {"/".join(path): tuple(x.shape) for path, x in tree_paths(tree)}

    def own_conv(tree):
        return {"/".join(path): x.clone() for path, x in tree_paths(tree)
                if path[-1] in ("conv_B", "conv_C")}

    def cpu(x):
        if isinstance(x, dict):
            return {k: cpu(v) for k, v in x.items()}
        if isinstance(x, list):
            return [cpu(v) for v in x]
        return x.cpu() if isinstance(x, torch.Tensor) else x

    device = payload.get("device", "cpu")
    meshes: dict = {}
    out = {}
    for case in payload["cases"]:
        cfg, shape = case["cfg"], tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("data", "model"), device=device,
                                      backend=payload.get("backend"))
        plan = plan_of(cfg.name, cfg.num_layers, shape, [LayerStrategy(tp=case["tp"], zero=0)])
        B = case["tokens"].shape[0]
        eng = serving.step_engine(build_model(cfg, device=device), plan,
                                  meshes[shape], batch=B, max_len=case["max_len"],
                                  dtype=torch.float32, device=device)
        params = eng.place_params(case["params"])
        logits, cache = eng.prefill_step(params, case["tokens"], case.get("extras"))
        with axis_rules(eng._rules):             # the local cache init_cache sizes
            sized = shapes(eng.model.init_cache(B, case["max_len"]))
        res = {"prefill": logits, "prefill_cache": eng.gather_cache(cache),
               "specs": eng.cache_specs, "local": shapes(cache), "sized": sized,
               "prefill_conv": own_conv(cache), "steps": []}
        for tokens, cache_index, kv_len in case["steps"]:
            logits, cache = eng.decode_step(params, tokens, cache, cache_index, kv_len)
            res["steps"].append(logits)
        res["cache"] = eng.gather_cache(cache)
        res["conv"] = own_conv(cache)
        res["greedy"] = eng.greedy_generate(params, case["tokens"], case["max_new"],
                                            case["max_len"])
        if case.get("naive_groups"):
            kept = mamba2.local_groups
            mamba2.local_groups = lambda H, G, tp, rank: (0, G)
            try:
                res["naive_groups"] = eng.prefill_step(params, case["tokens"])[0]
            finally:
                mamba2.local_groups = kept
        out[case["name"]] = cpu(res)
    return out


def _shapes_of(tree) -> dict:
    """{path: (shape, dtype)} of a nested dict / NamedTuple of tensors."""
    out = {}

    def walk(x, prefix):
        if isinstance(x, torch.Tensor):
            out["/".join(prefix)] = (tuple(x.shape), str(x.dtype))
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, prefix + (str(k),))
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for k, v in zip(x._fields, x):
                walk(v, prefix + (k,))
    walk(tree, ())
    return out


def audit_cases(payload: dict) -> dict:
    """Each case of ``payload["cases"]`` ((name, mesh shape, axes, plan
    fields)) on this gloo rank: the trainer's abstract trees' shapes against
    ``init_params`` / ``init_opt_state``'s, and for the cases named in
    ``payload["census"]`` the collective census of one real ``train_step``
    (``donate=True``) on the global batch; then, with the gloo group torn
    down, the same rank of a fake world traces the same step on fake tensors
    and records its census.  Every rank returns its own."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.comm_census import CommCensus
    from repro_torch.analysis.step_trace import materialize, trace_step
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core.strategy import ExecutionPlan, LayerStrategy
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime.data import SyntheticDataset, input_specs
    from repro_torch.runtime.resize import make_trainer

    cfg = get_config("llama3.2-1b").reduced()
    seq, batch_size = payload["seq"], payload["batch"]
    batch = SyntheticDataset(cfg, seq, batch_size).batch(0)
    rank, world = dist.get_rank(), dist.get_world_size()

    def trainer(case, backend=None):
        _, shape, axes, fields = case
        strategy = LayerStrategy(**fields["strategy"])
        plan = ExecutionPlan(arch=cfg.name, shape="train", mesh_axes=tuple(axes),
                             mesh_shape=tuple(shape), layer_strategies=[strategy] * cfg.num_layers,
                             default_strategy=strategy,
                             **{k: v for k, v in fields.items() if k != "strategy"})
        mesh = make_mesh(shape, axes, device="cpu", backend=backend)
        return make_trainer(build_model(cfg, device="cpu"), plan, mesh)

    out = {"abstract": {}, "real": {}, "fake": {}}
    for case in payload["cases"]:
        hp = trainer(case)
        params = hp.init_params(torch.Generator().manual_seed(0))
        opt = hp.init_opt_state(params)
        out["abstract"][case[0]] = (_shapes_of(hp.abstract_params()) == _shapes_of(params),
                                    _shapes_of(hp.abstract_opt_state()) == _shapes_of(opt))
        if case[0] not in payload["census"]:
            continue
        with CommCensus(hp.mesh) as census:
            hp.train_step(params, opt, batch, donate=True)
        out["real"][case[0]] = census.axis_census().rows()
    dist.destroy_process_group()
    dryrun.fake_world(world, rank)
    spec = ShapeSpec("audit", "train", seq, batch_size)
    for case in (c for c in payload["cases"] if c[0] in payload["census"]):
        hp = trainer(case, backend=dryrun.FAKE_BACKEND)
        with FakeTensorMode(allow_non_fake_inputs=True):
            params = materialize(hp.abstract_params(), "cpu")
            opt = materialize(hp.abstract_opt_state(), "cpu")
            fake_batch = materialize(input_specs(cfg, spec, hp.model), "cpu")
            tr = trace_step(lambda: hp.train_step(params, opt, fake_batch, donate=True),
                            (params, opt, fake_batch), hp.mesh)
        out["fake"][case[0]] = tr.census.axis_census().rows()
    return out


def references(name: str, arch: str, strategies, grad_accum: int = 1, batch: int = 8,
               seq: int = 32, eps: float = 1e-4,
               overrides: dict | None = None, masked: int = 3) -> tuple[dict, dict]:
    """(case, refs): the case for ``train_cases`` on JAX-initialised
    (perturbed) weights and a seeded batch whose row 1 has its first
    ``masked`` labels masked, and its references: JAX's fp32
    ``value_and_grad`` of its ``loss_fn`` formula and the port's
    single-device ``value_and_grad`` and ``train_step``.  ``overrides``
    replace fields of the reduced config in both packages."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs.registry import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro.runtime import train as jtrain
    from repro_torch.configs.registry import get_config
    from repro_torch.core.strategy import uniform_plan
    from repro_torch.models import build_model
    from repro_torch.models.common import params_from_jax
    from repro_torch.runtime.optimizer import AdamWConfig
    from repro_torch.runtime.train import construct_hybrid_parallel_model
    from tests._torch_params import perturbed

    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
        jcfg = dataclasses.replace(jcfg, **overrides)
    jm = jax_build_model(jcfg)
    np_params = perturbed(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                          np.random.default_rng(0))
    rng = np.random.default_rng(7)
    text = seq - (cfg.vis_tokens if cfg.family == "vlm" else 0)
    toks = rng.integers(0, cfg.vocab_size, (batch, text + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[1, :masked] = -1
    side = {}
    if cfg.family == "vlm":
        side["vis_embeds"] = rng.standard_normal((batch, cfg.vis_tokens, cfg.d_model)
                                                 ).astype(np.float32)
    if cfg.family == "audio":
        side["frames"] = rng.standard_normal((batch, cfg.enc_frames, cfg.d_model)
                                             ).astype(np.float32)
    off = jm.text_offset()

    def jloss(p, tokens, labels, side):
        logits, extra = jm.forward_train(p, tokens, dtype=jnp.float32, **side)
        loss, _ = jtrain.softmax_xent(logits[:, off:, :], labels)
        return loss + jtrain.AUX_LOSS_WEIGHT * extra

    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(toks[:, :-1]), jnp.asarray(labels),
        {k: jnp.asarray(v) for k, v in side.items()})
    params = params_from_jax(np_params, "cpu", torch.float32)
    tbatch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(labels),
              **{k: torch.from_numpy(v) for k, v in side.items()}}
    opt = AdamWConfig(eps=eps)
    plan = uniform_plan(cfg.name, "train", (1,), ("data",), cfg.num_layers,
                        dataclasses.replace(strategies[0], tp=1, sp=False, zero=0, ep=1,
                                            cp=1),
                        grad_accum=grad_accum)
    hp = construct_hybrid_parallel_model(build_model(cfg, device="cpu"), plan, None, opt)
    loss, _, grads = hp.value_and_grad(params, tbatch, torch.float32)
    new, _, metrics = hp.train_step(params, hp.init_opt_state(params), tbatch, torch.float32)
    case = dict(name=name, cfg=cfg, strategies=list(strategies), grad_accum=grad_accum,
                params=params, batch=tbatch)
    refs = dict(jax_loss=float(jl), jax_grads=jax.tree.map(np.asarray, jg),
                loss=float(loss), grads=grads, step_loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]), new=new, opt=opt)
    return case, refs


if __name__ == "__main__":
    _child()
