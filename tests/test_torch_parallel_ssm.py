"""Tensor parallelism in the SSM, hybrid and audio families on the port's
parallel runtime over gloo on the CPU.

Four spawned ranks train the reduced mamba2, zamba2 and whisper configs
(seq 32, a global batch of 8 with masked labels), one spawn for each mesh
shape, each case held to the port's single-device step and to JAX's
single-device ``value_and_grad`` with the tolerances of
``test_torch_parallel_mp.py``.  On (data 1, model 4): mamba2 at tp 4,
ZeRO-1, ``full`` (JAX's own mesh case, tests/test_parallel_mp.py:33) and
zamba2 at tp 4, two ranks a group of B/C.  On (2, 2): mamba2 at tp 2 + sp,
ZeRO-3, ``selective`` (the gate norm's scale gathered over the data axis
and used in part over the model axis); zamba2 at tp 2 + sp, ZeRO-2, one
group a rank; whisper at tp 2 + sp, ZeRO-1 (the encoder and
cross-attention regions), and at tp 2 with an odd vocab (515, as
whisper-tiny's 51 865 is odd), whose head stays whole.  The reduced mamba2 has one group (G 1), which
cannot show a group fault; the reduced zamba2 has 8 heads in 2 groups, and
its tp 2 case also shows that handing each rank all of them (the naive
``_expand_groups`` at the local head count) changes the loss.

Without processes: K2's split-row plain passes over column shards, their
row statistics summed by hand, against the whole-row plain forward and its
backward (a property test); ``local_groups`` against ``_expand_groups`` of
the global heads; ``check_supported``'s refusal of a tp that does not
divide the SSM heads or whose ranks' heads straddle groups.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.strategy import ExecutionPlan, LayerStrategy
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm import ref as rms_ref
from repro_torch.kernels.ssd.ref import _expand_groups
from repro_torch.models.mamba2 import local_groups
from repro_torch.runtime.train import check_supported
from tests._prop import given, settings, st
from tests._torch_dist import references, run_ranks
from tests.test_torch_parallel_mp import check_jax, check_single_device

MAMBA2, ZAMBA2, WHISPER = "mamba2-2.7b", "zamba2-7b", "whisper-tiny"

# mesh shape -> name -> (arch, strategy[, overrides of the reduced config])
CASES = {
    (1, 4): {
        "mamba2_tp4_zero1_full": (MAMBA2, LayerStrategy(tp=4, zero=1, remat="full")),
        "zamba2_tp4": (ZAMBA2, LayerStrategy(tp=4)),
    },
    (2, 2): {
        "mamba2_tp2_sp_zero3_selective": (
            MAMBA2, LayerStrategy(tp=2, sp=True, zero=3, remat="selective")),
        "zamba2_tp2_sp_zero2": (ZAMBA2, LayerStrategy(tp=2, sp=True, zero=2)),
        "whisper_tp2_sp_zero1": (WHISPER, LayerStrategy(tp=2, sp=True, zero=1)),
        # an odd vocab, as whisper-tiny's 51 865: the head and the table stay
        # whole at tp 2, and the loss takes its whole-vocab branch
        "whisper_tp2_odd_vocab": (WHISPER, LayerStrategy(tp=2), {"vocab_size": 515}),
    },
}
NAMES = [name for cases in CASES.values() for name in cases]
NAIVE_CASE = "zamba2_tp2_sp_zero2"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = {}
    for shape, cases in CASES.items():
        built = {name: references(name, arch, [s], 1, overrides=more[0] if more else None)
                 for name, (arch, s, *more) in cases.items()}
        if NAIVE_CASE in built:
            built[NAIVE_CASE][0]["naive_groups"] = True
        opt = next(iter(built.values()))[1]["opt"]
        got = run_ranks(4, "train_cases",
                        {"mesh": shape, "cases": [c for c, _ in built.values()], "opt": opt},
                        tmp_path_factory.mktemp("x".join(map(str, shape))))[0]
        out.update({name: (got[name], refs, case) for name, (case, refs) in built.items()})
    return out


@pytest.mark.parametrize("name", NAMES)
def test_sharded_step_matches_the_ports_single_device_step(results, name):
    check_single_device(*results[name])


@pytest.mark.parametrize("name", NAMES)
def test_sharded_grads_match_jax_value_and_grad(results, name):
    got, refs, _ = results[name]
    check_jax(got, refs)


def test_naive_groups_change_the_zamba2_tp2_loss(results):
    """At tp 2 each rank's 4 heads read one of zamba2's 2 groups; handed
    both, K3 gives local heads 0-1 group 0 and 2-3 group 1, and the loss
    moves well past the tolerance the sliced run is held to."""
    got, refs, _ = results[NAIVE_CASE]
    assert abs(got["vg_loss"] - refs["loss"]) <= 1e-5 * abs(refs["loss"])
    assert abs(got["naive_loss"] - refs["loss"]) > 1e-3 * abs(refs["loss"]), got["naive_loss"]


def test_local_shards_follow_the_ssm_rules(results):
    """``ssm_inner`` and ``ssm_heads`` shard over the model axis; the B/C
    projections and convolutions and the gate norm's scale stay whole
    (``ssm_groups`` and ``norm`` are not TP axes); ZeRO-3 cuts the embed
    dim over the data axis and the gate scale with it."""
    tp4 = results["mamba2_tp4_zero1_full"][0]["local_shapes"]
    assert tp4["blocks.w_x"] == (2, 128, 64) and tp4["blocks.w_out"] == (2, 64, 128)
    assert tp4["blocks.w_dt"] == (2, 128, 2) and tp4["blocks.A_log"] == (2, 2)
    assert tp4["blocks.w_B"] == (2, 128, 16) and tp4["blocks.conv_C"] == (2, 4, 16)
    assert tp4["blocks.gate_norm.scale"] == (2, 256)
    z3 = results["mamba2_tp2_sp_zero3_selective"][0]["local_shapes"]
    assert z3["blocks.w_x"] == (2, 64, 128) and z3["blocks.gate_norm.scale"] == (2, 128)
    whisper = results["whisper_tp2_sp_zero1"][0]["local_shapes"]
    assert whisper["enc_blocks.attn.wq"] == (2, 128, 2, 32)
    assert whisper["dec_blocks.cross_attn.wk"] == (2, 128, 2, 32)
    assert whisper["embed.head"] == (128, 256)
    odd = results["whisper_tp2_odd_vocab"][0]["local_shapes"]
    assert odd["embed.head"] == (128, 515) and odd["embed.tok"] == (515, 128)
    assert odd["dec_blocks.self_attn.wq"] == (2, 128, 2, 32)


@settings(max_examples=25, deadline=None)
@given(width=st.sampled_from([8, 24, 96, 384, 2560]), shards=st.sampled_from([1, 2, 4, 8]),
       rows=st.integers(1, 9), dtype=st.sampled_from(["float32", "bfloat16"]))
def test_split_row_passes_equal_the_whole_row_norm(width, shards, rows, dtype):
    """The split form's four plain passes, each shard's row statistics
    summed by hand, give ``rmsnorm_reference`` and autograd's grads through
    it (fp32 1e-5, bf16 2e-2, as tests/test_torch_rmsnorm.py); and the
    wrappers, on CPU tensors, are those plain passes bitwise."""
    td = getattr(torch, dtype)
    tol = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]
    rng = np.random.default_rng(width * 31 + shards * 7 + rows)
    x = torch.from_numpy(3 * rng.standard_normal((rows, width)).astype(np.float32)).to(td)
    g = torch.from_numpy(rng.standard_normal((rows, width)).astype(np.float32)).to(td)
    scale = torch.from_numpy(1 + 0.3 * rng.standard_normal(width).astype(np.float32))
    xs, gs, ss = x.chunk(shards, -1), g.chunk(shards, -1), scale.chunk(shards)
    stat = sum(rms_ref.rmsnorm_split_sumsq_reference(p) for p in xs)
    out = torch.cat([rms_ref.rmsnorm_split_reference(p, s, stat, width)
                     for p, s in zip(xs, ss)], -1)
    dot = sum(rms_ref.rmsnorm_split_dot_reference(p, s, q, stat, width)
              for p, s, q in zip(xs, ss, gs))
    parts = [rms_ref.rmsnorm_split_backward_reference(p, s, q, stat, dot, width)
             for p, s, q in zip(xs, ss, gs)]
    xa, sa = x.clone().requires_grad_(), scale.clone().requires_grad_()
    want = rms_ref.rmsnorm_reference(xa, sa)
    rdx, rds = torch.autograd.grad(want, (xa, sa), g)
    assert out.dtype == td
    np.testing.assert_allclose(out.float(), want.detach().float(), atol=tol, rtol=tol)
    np.testing.assert_allclose(torch.cat([d for d, _ in parts], -1).float(), rdx.float(),
                               atol=tol * max(1.0, float(rdx.float().abs().max())), rtol=tol)
    np.testing.assert_allclose(torch.cat([s for _, s in parts]), rds,
                               atol=tol * max(1.0, float(rds.abs().max())), rtol=tol)
    p, s, q = xs[0].contiguous(), ss[0], gs[0].contiguous()
    assert torch.equal(rms_ops.rmsnorm_split_sumsq(p), rms_ref.rmsnorm_split_sumsq_reference(p))
    assert torch.equal(rms_ops.rmsnorm_split(p, s, stat, width),
                       rms_ref.rmsnorm_split_reference(p, s, stat, width))
    assert torch.equal(rms_ops.rmsnorm_split_dot(p, s, q, stat, width),
                       rms_ref.rmsnorm_split_dot_reference(p, s, q, stat, width))
    for a, b in zip(rms_ops.rmsnorm_split_backward(p, s, q, stat, dot, width), parts[0]):
        assert torch.equal(a, b)


def test_split_autograd_on_one_rank_group_is_the_whole_row_norm():
    """``rmsnorm_split_autograd`` over a group of one (every collective the
    identity) gives the whole-row ``rmsnorm_autograd``'s output and grads."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32))
    scale = torch.from_numpy(1 + 0.3 * rng.standard_normal(40).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32))
    outs = []
    for fn in (lambda a, s: rms_ops.rmsnorm_split_autograd(a, s, 1e-5, 40, None),
               lambda a, s: rms_ops.rmsnorm_autograd(a, s, 1e-5)):
        a, s = x.clone().requires_grad_(), scale.clone().requires_grad_()
        y = fn(a, s)
        outs.append((y.detach(), *torch.autograd.grad(y, (a, s), g)))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("H,G", [(8, 1), (8, 2), (8, 8), (80, 1), (112, 2), (12, 4), (16, 4)])
def test_local_groups_are_the_groups_expand_groups_gives(H, G):
    """For every tp that divides the heads with tp | G or G | tp: the
    groups rank r's heads read under ``_expand_groups`` of all H heads, and
    ``_expand_groups`` of those groups at the local head count maps each
    local head to the same group."""
    groups = torch.arange(G).reshape(1, 1, G, 1)
    per_head = _expand_groups(groups, H)[0, 0, :, 0].tolist()
    for tp in range(1, H + 1):
        if H % tp or (G % tp and tp % G):
            with pytest.raises(ValueError, match="ssm_heads"):
                local_groups(H, G, tp, 0)
            continue
        n = H // tp
        for r in range(tp):
            g0, g1 = local_groups(H, G, tp, r)
            mine = per_head[r * n:(r + 1) * n]
            assert (g0, g1) == (min(mine), max(mine) + 1)
            local = _expand_groups(groups[:, :, g0:g1], n)[0, 0, :, 0].tolist()
            assert local == mine, (H, G, tp, r)


def _plan(arch: str, mesh_shape, strategy: LayerStrategy, layers: int) -> ExecutionPlan:
    return ExecutionPlan(arch=arch, shape="train", mesh_axes=("data", "model"),
                         mesh_shape=mesh_shape, layer_strategies=[strategy] * layers,
                         default_strategy=strategy)


@pytest.mark.parametrize("arch,overrides,tp,words", [
    (MAMBA2, {}, 3, "tp 3 over 8 SSM heads"),                        # 3 does not divide 8
    (ZAMBA2, {"d_model": 192, "ssm_groups": 3}, 2, "in 3 groups"),   # 6 heads a rank, 4 a group
])
def test_check_supported_refuses_layouts_the_port_cannot_nest(arch, overrides, tp, words):
    """A tp that does not divide the SSM heads, or whose ranks' heads read
    parts of two groups (12 heads in 3 groups at tp 2): a ``ValueError``
    naming the dims, before any process group is touched."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    mesh = types.SimpleNamespace(axis_names=("data", "model"), sizes=(1, tp),
                                 shape={"data": 1, "model": tp}, group=None)
    plan = _plan(cfg.name, (1, tp), LayerStrategy(tp=tp), cfg.num_layers)
    with pytest.raises(ValueError, match=words) as err:
        check_supported(types.SimpleNamespace(cfg=cfg), plan, mesh)
    assert "ssm_groups" in str(err.value) and "ssm_heads" in str(err.value)
