"""The port's parallel runtime over gloo on the CPU: four spawned ranks on a
(data 2, model 2) mesh train the dense family's plans in fp32 (reduced
configs, seq 32, a global batch of 8 with masked labels), each held to two
references on the same weights and batch:

* the port's single-device step (``mesh=None``): ``value_and_grad`` and
  ``train_step`` losses within 1e-5 relative, the grad norm too, and every
  param update of the step, gathered to the canonical tree, within 2e-3 of
  its scale (at one microbatch the step's params are also ``apply_grads``
  on ``value_and_grad``'s grads, bitwise);
* JAX's single-device ``value_and_grad`` of its ``loss_fn`` formula: the
  loss within 1e-5, every grad (summed over the ranks, gathered) within
  2e-3 of its scale.

The cases: llama at tp 2, ZeRO-2, grad_accum 2 (JAX's own mesh case);
qwen3 at tp 2 with sequence parallelism, ZeRO-3, ``selective``; llama at
tp 1 (dp 4 through the absorbed model axis), ZeRO-3, ``full``; and a
two-group llama plan, tp 2 + sp with ZeRO-1 then tp 1 with ZeRO-3, which
changes the residual stream's layout between the layers.  The reduced
configs have 4 query heads and 1 KV head, so at tp 2 the K/V projections
stay whole on both ranks.  ``place_params`` then ``gather_params`` gives
the canonical tree back bitwise.

The update check runs AdamW at eps 1e-4: the first step's update of one
element is ``lr · g / (|g| + eps)``, whose slope in g is up to lr / eps, so
at the default eps (1e-8) a grad element near 1e-10 (seen: 8.7e-11 on the
mesh against 5.0e-10 on one device, both fp32 rounding of a sum taken in
another order) moves the update by a whole lr.  At 1e-4 a grad difference
of 1e-7 moves it by 1e-3 lr.  The loss and grad norm do not read eps.
"""
import numpy as np
import pytest

from repro_torch.core.strategy import LayerStrategy
from repro_torch.models.common import tree_paths
from tests._torch_dist import references, run_ranks

CASES = {
    "llama_tp2_zero2_ga2": ("llama3.2-1b", [LayerStrategy(tp=2, zero=2)], 2),
    "qwen3_tp2_sp_zero3_selective": (
        "qwen3-14b", [LayerStrategy(tp=2, sp=True, zero=3, remat="selective")], 1),
    "llama_dp4_zero3_full": ("llama3.2-1b", [LayerStrategy(tp=1, zero=3, remat="full")], 1),
    "llama_two_groups": ("llama3.2-1b", [LayerStrategy(tp=2, sp=True, zero=1),
                                         LayerStrategy(tp=1, zero=3)], 1),
}


def run_cases(cases: dict, tmp) -> dict:
    """Every case on 4 ranks, beside its references: name -> (got, refs)."""
    built = {name: references(name, arch, strategies, ga)
             for name, (arch, strategies, ga) in cases.items()}
    opt = next(iter(built.values()))[1]["opt"]
    got = run_ranks(4, "train_cases",
                    {"mesh": (2, 2), "cases": [c for c, _ in built.values()], "opt": opt},
                    tmp)[0]
    return {name: (got[name], refs, case) for name, (case, refs) in built.items()}


def check_single_device(got, refs, case):
    np.testing.assert_allclose(got["vg_loss"], refs["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["step_loss"], refs["step_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], refs["grad_norm"], rtol=1e-5)
    assert got["roundtrip"]
    assert got["applied_is_step"] in (True, None)
    new = dict(tree_paths(got["new"]))
    ref_new = dict(tree_paths(refs["new"]))
    for path, p0 in tree_paths(case["params"]):
        want = ref_new[path] - p0
        err = float((new[path] - p0 - want).abs().max())
        assert err <= 2e-3 * float(want.abs().max()), (path, err)


def check_jax(got, refs):
    np.testing.assert_allclose(got["vg_loss"], refs["jax_loss"], rtol=1e-5)
    jgrads = dict(tree_paths(refs["jax_grads"]))
    paths = [p for p, _ in tree_paths(got["grads"])]
    assert sorted(paths) == sorted(jgrads)
    for path, g in tree_paths(got["grads"]):
        ref = jgrads[path]
        err = np.abs(g.numpy() - ref).max()
        assert err <= 2e-3 * np.abs(ref).max(), (path, err)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(CASES, tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_the_ports_single_device_step(results, name):
    check_single_device(*results[name])


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_grads_match_jax_value_and_grad(results, name):
    got, refs, _ = results[name]
    check_jax(got, refs)


def test_bf16_zero3_step_stays_within_jaxs_bf16_bound(tmp_path):
    """ZeRO-3 gathers the leaves whose ``ParamDef`` is ``cast`` in the
    forward's dtype: one bf16 ``train_step`` of llama at dp 4 (ZeRO-3, grad_accum 2) against
    the single-device bf16 step, within JAX's bf16 bound on a sharded step
    (5e-2, tests/test_parallel_mp.py:53) for the loss and the grad norm."""
    import torch

    from repro_torch.core.strategy import LayerStrategy as LS
    from repro_torch.core.strategy import uniform_plan
    from repro_torch.models import build_model
    from repro_torch.runtime.train import construct_hybrid_parallel_model

    case, _ = references("llama_bf16", "llama3.2-1b", [LS(tp=1, zero=3)], 2)
    case["dtype"] = torch.bfloat16
    got = run_ranks(4, "train_cases",
                    {"mesh": (2, 2), "cases": [case]}, tmp_path)[0]["llama_bf16"]
    cfg = case["cfg"]
    plan = uniform_plan(cfg.name, "t", (1,), ("data",), cfg.num_layers, LS(), grad_accum=2)
    hp = construct_hybrid_parallel_model(build_model(cfg, device="cpu"), plan)
    _, _, m = hp.train_step(case["params"], hp.init_opt_state(case["params"]), case["batch"])
    assert abs(got["step_loss"] - float(m["loss"])) <= 5e-2
    assert abs(got["grad_norm"] - float(m["grad_norm"])) <= 5e-2 * float(m["grad_norm"])


def test_local_shards_follow_the_specs(results):
    """tp 2: this rank's query heads and ff columns are half of them, the one
    KV head and the vocab rows (512 / 2) as the rules say; ZeRO-3 over dp 4
    cuts the embed dim of every matrix and the norm scales."""
    tp2 = results["llama_tp2_zero2_ga2"][0]["local_shapes"]
    assert tp2["blocks.attn.wq"] == (2, 128, 2, 32)
    assert tp2["blocks.attn.wk"] == (2, 128, 1, 32)
    assert tp2["blocks.mlp.w_in"] == (2, 128, 128)
    assert tp2["embed.tok"] == (256, 128)
    dp4 = results["llama_dp4_zero3_full"][0]["local_shapes"]
    assert dp4["blocks.attn.wq"] == (2, 32, 4, 32)
    assert dp4["blocks.ln1.scale"] == (2, 32)
    assert dp4["final_norm.scale"] == (32,)
    mixed = results["llama_two_groups"][0]["local_shapes"]
    assert mixed["blocks.g000.attn.wq"] == (1, 128, 2, 32)
    assert mixed["blocks.g001.attn.wq"] == (1, 32, 4, 32)
