"""The MoE family on the port's parallel runtime over gloo on the CPU.

Four spawned ranks on a (data 2, model 2) mesh train the reduced moonshot
and grok-1 configs **at capacity factor 1.25** in both packages
(``reduced()`` raises it to 4.0, where no choice drops and routing each
rank's tokens alone gives JAX's slots exactly: a test there cannot tell
global routing from local routing).  Seq 32, a global batch of 8 with
masked labels; each case is held to the port's single-device step and to
JAX's single-device ``value_and_grad`` with the tolerances of
``test_torch_parallel_mp.py``.  The cases: moonshot at dp 4 (tp 1), ZeRO-1,
grad_accum 2; moonshot at tp 1 with ep 2, ZeRO-2 (the exchange within the
data axis, the expert grads summed over the absorbed model axis); moonshot
at tp 2 + sp with ep 2, ZeRO-3, ``selective`` (JAX's own mesh case,
tests/test_parallel_mp.py:32, at half its model axis); grok-1 at tp 2, ep
2, ZeRO-1 (top-2, geglu, no shared expert); moonshot at tp 2 with no EP,
ZeRO-1, its shared expert twice the experts' ff as in the full config (so
a rank's shared-expert columns are as many as one expert's whole ff).
Each case also shows, on the
single-device routing of its microbatches, that the batch drops choices and
that routing each rank's tokens alone would have changed a slot or a keep.

Without processes: the distributed slot function, evaluated rank by rank
from the gathered counts, gives JAX's ``assign_slots`` and
``slot_inverse`` integers on the concatenated choices (a property test),
and at dp 4 the loss and the router's grad count the aux term once.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.strategy import LayerStrategy, uniform_plan
from repro_torch.models import build_model, moe
from repro_torch.models.common import tree_paths
from repro_torch.runtime.train import construct_hybrid_parallel_model
from tests._prop import given, settings, st
from tests._torch_dist import aux_runs, references, run_ranks
from tests.test_torch_parallel_mp import check_jax, check_single_device

CF = 1.25
MOONSHOT, GROK = "moonshot-v1-16b-a3b", "grok-1-314b"

# name -> (arch, strategy, grad_accum[, config overrides besides CF])
CASES = {
    "moonshot_dp4_zero1_ga2": (MOONSHOT, LayerStrategy(zero=1), 2),
    "moonshot_ep2_zero2": (MOONSHOT, LayerStrategy(zero=2, ep=2), 1),
    "moonshot_tp2_sp_ep2_zero3_selective": (
        MOONSHOT, LayerStrategy(tp=2, sp=True, zero=3, ep=2, remat="selective"), 1),
    "grok_tp2_ep2_zero1": (GROK, LayerStrategy(tp=2, ep=2, zero=1), 1),
    "moonshot_tp2_zero1_shared2x": (MOONSHOT, LayerStrategy(tp=2, zero=1), 1,
                                    {"shared_expert_ff": 512}),
}
AUX_CASE = "moonshot_dp4_zero1_ga2"
AUX_WEIGHTS = (1.0, 0.0)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    built = {name: references(name, arch, [s], ga,
                              overrides={"moe_capacity_factor": CF, **(more[0] if more else {})})
             for name, (arch, s, ga, *more) in CASES.items()}
    built[AUX_CASE][0]["aux_weights"] = AUX_WEIGHTS
    opt = next(iter(built.values()))[1]["opt"]
    got = run_ranks(4, "train_cases",
                    {"mesh": (2, 2), "cases": [c for c, _ in built.values()], "opt": opt},
                    tmp_path_factory.mktemp("moe"))[0]
    return {name: (got[name], refs, case) for name, (case, refs) in built.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_moe_step_matches_the_ports_single_device_step(results, name):
    check_single_device(*results[name])


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_moe_grads_match_jax_value_and_grad(results, name):
    got, refs, _ = results[name]
    check_jax(got, refs)


def _routings(case) -> list:
    """(expert_idx, capacity) of every MoE layer of every microbatch of the
    case's single-device fp32 forward."""
    cfg, ga = case["cfg"], case["grad_accum"]
    seen = []
    real = moe.assign_slots

    def record(idx, E, C):
        seen.append((idx.clone(), C))
        return real(idx, E, C)

    plan = uniform_plan(cfg.name, "t", (1,), ("data",), cfg.num_layers, LayerStrategy(),
                        grad_accum=ga)
    hp = construct_hybrid_parallel_model(build_model(cfg, device="cpu"), plan)
    B = case["batch"]["tokens"].shape[0]
    moe.assign_slots = record
    try:
        with torch.no_grad():
            for i in range(ga):
                rows = slice(i * B // ga, (i + 1) * B // ga)
                hp.loss_fn(case["params"], {k: v[rows] for k, v in case["batch"].items()},
                           torch.float32)
    finally:
        moe.assign_slots = real
    return seen


@pytest.mark.parametrize("name", list(CASES))
def test_case_drops_choices_and_local_routing_would_differ(results, name):
    """At capacity factor 1.25 the batch drops choices, and routing each
    rank's rows alone (its own capacity, its own running count) changes at
    least one slot or keep: a runtime that routed per rank would fail the
    parity tests above."""
    _, _, case = results[name]
    cfg = case["cfg"]
    assert cfg.moe_capacity_factor == CF
    ranks = 4 if CASES[name][1].tp == 1 else 2      # the batch group: dp axes
    dropped = differs = 0
    for idx, C in _routings(case):
        slots, keep = moe.assign_slots(idx, cfg.num_experts, C)
        dropped += int((~keep).sum())
        T = idx.shape[0]
        local = [moe.assign_slots(part, cfg.num_experts, moe._capacity(cfg, T // ranks))
                 for part in idx.chunk(ranks)]
        l_slots = torch.cat([s for s, _ in local])
        l_keep = torch.cat([k for _, k in local])
        differs += int(((l_slots != slots) | (l_keep != keep)).sum())
    assert dropped > 0, name
    assert differs > 0, name


def test_local_shards_follow_the_expert_rules(results):
    """ep 2 shards the expert dim over the data axis (2 of 4 experts a
    rank), the router's too; tp 2 halves the expert ff; ZeRO-3 under ep
    takes the router's embed dim for the data axis (``MeshRules.spec``'s
    dedup), leaving its expert dim whole."""
    ep = results["moonshot_ep2_zero2"][0]["local_shapes"]
    assert ep["blocks.mlp.w_in"] == (2, 2, 128, 256)
    assert ep["blocks.mlp.router"] == (2, 128, 2)
    sp = results["moonshot_tp2_sp_ep2_zero3_selective"][0]["local_shapes"]
    assert sp["blocks.mlp.w_in"] == (2, 2, 128, 128)
    assert sp["blocks.mlp.router"] == (2, 64, 4)
    grok = results["grok_tp2_ep2_zero1"][0]["local_shapes"]
    assert grok["blocks.mlp.w_gate"] == (2, 2, 128, 128)


def test_aux_term_counts_once_at_dp4(results):
    """The aux term's share of the loss and of the router's grads (the run
    at aux weight 1 minus the run at 0) on four ranks is one rank's, within
    1e-5: neither is counted once per rank."""
    got, _, case = results[AUX_CASE]
    cfg = case["cfg"]
    plan = uniform_plan(cfg.name, "t", (1,), ("data",), cfg.num_layers, LayerStrategy())
    hp = construct_hybrid_parallel_model(build_model(cfg, device="cpu"), plan)
    one = aux_runs(hp, case["params"], case["batch"], torch.float32, AUX_WEIGHTS)
    mesh = got["aux"]
    d_one = one[1.0][0] - one[0.0][0]
    d_mesh = mesh[1.0][0] - mesh[0.0][0]
    assert d_one > 0
    np.testing.assert_allclose(d_mesh, d_one, rtol=1e-5)
    g_one, g_mesh = (dict(tree_paths(r[1.0][1])) for r in (one, mesh))
    g0_one, g0_mesh = (dict(tree_paths(r[0.0][1])) for r in (one, mesh))
    path = ("blocks", "mlp", "router")
    want = g_one[path] - g0_one[path]
    got_d = g_mesh[path] - g0_mesh[path]
    assert float(want.abs().max()) > 0
    assert float((got_d - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("seed,silent", [(0, ()), (3, (2,))])
def test_exchange_is_a_plain_gather_forward_and_backward(tmp_path, seed, silent):
    """``collectives.exchange`` over three gloo ranks, uneven split sizes
    (some zero; with ``silent``, a rank that sends and receives nothing),
    fp32 and bf16: the rows each rank receives and the grad of the rows it
    sent are bitwise a plain gather's, and a rank that receives nothing
    gets one zero row."""
    got = run_ranks(3, "exchange_rows", {"seed": seed, "silent": silent}, tmp_path)
    if silent:
        assert got[2]["float32"]["received"] == 0
    for rank in got:
        for dtype, res in rank.items():
            assert res["rows"] and res["grad"], (dtype, res)
            assert res["padding"] == 0.0
            assert res["shape"] == (max(res["received"], 1), 8)


# --------------------------------------------------------------------------
# the slot function, rank by rank, against JAX's
# --------------------------------------------------------------------------

@settings(max_examples=40, deadline=None)
@given(tokens=st.integers(1, 24), k=st.integers(1, 4), experts=st.integers(1, 8),
       ranks=st.integers(1, 5), cap=st.integers(1, 40), seed=st.integers(0, 2**16))
def test_distributed_slots_are_jaxs_on_the_concatenated_batch(tokens, k, experts, ranks,
                                                              cap, seed):
    """Each rank's ``distributed_slots`` from its own ``expert_idx`` and the
    gathered ``choice_counts``, concatenated in rank order, are JAX's
    ``assign_slots`` on the concatenated choices bitwise (drops included),
    and the slot-inverse map built from them is JAX's ``slot_inverse``."""
    import jax.numpy as jnp

    from repro.models import moe as jmoe

    k = min(k, experts)
    rng = np.random.default_rng(seed)
    idx = np.stack([np.stack([rng.choice(experts, k, replace=False)
                              for _ in range(tokens)]) for _ in range(ranks)])
    parts = [torch.from_numpy(p).long() for p in idx]
    counts = torch.stack([moe.choice_counts(p, experts) for p in parts])
    got = [moe.distributed_slots(p, counts, r, cap) for r, p in enumerate(parts)]
    slots = torch.cat([g[0] for g in got]).numpy()
    keep = torch.cat([g[1] for g in got]).numpy()
    whole = jnp.asarray(idx.reshape(ranks * tokens, k), jnp.int32)
    j_slots, j_keep = jmoe.assign_slots(whole, experts, cap)
    np.testing.assert_array_equal(slots, np.asarray(j_slots))
    np.testing.assert_array_equal(keep, np.asarray(j_keep))
    inv = moe.slot_inverse(torch.from_numpy(idx.reshape(-1, k)).long(),
                           torch.from_numpy(slots), torch.from_numpy(keep), experts, cap)
    j_inv = jmoe.slot_inverse(whole, j_slots, j_keep, experts, cap)
    np.testing.assert_array_equal(inv.numpy(), np.asarray(j_inv))
    kept = moe.kept_counts(counts, cap)
    for r, g in enumerate(got):
        np.testing.assert_array_equal(
            kept[r].numpy(), np.bincount(parts[r][g[1]].numpy(), minlength=experts))
    if ranks == 1:
        one = moe.assign_slots(parts[0], experts, cap)
        assert torch.equal(one[0], got[0][0]) and torch.equal(one[1], got[0][1])
