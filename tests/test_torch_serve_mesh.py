"""The serving engine's mesh layout against JAX's, with no process group:

* every model's ``cache_logical_axes()`` and ``abstract_cache`` (shapes and
  dtypes; the port's on the ``meta`` device) equal JAX's, for every arch;
* ``cache_spec_tree`` equals JAX's, as tuples, for every arch on the
  abstract meshes (data 2, model 4) and (16, 16), at a ``max_len`` and a
  batch that divide and that do not, and without shapes;
* a serving mesh refuses the moe and audio families and plans with sp,
  cp > 1, pp > 1, ep > 1, ZeRO-3 or layers of different tp (dense, vlm,
  ssm and hybrid models alike), each naming Queue 1 item 4, before it
  looks at the mesh;
* the ssm and hybrid caches on the abstract meshes (data 2, model 4) and
  (16, 16): ``cache_layout``'s batch split and ``cache_seq`` read off the
  flat SSM state and the nested ``{"mamba", "attn"}`` cache, each the
  entry of JAX's ``cache_spec_tree`` at that leaf's batch or seq dim;
  mamba2's vocab of 50 280 left whole over 16 ranks;
  ``check_state_layout`` passes the engine's own layouts and raises
  ``ValueError`` naming the leaf where an SSM state's heads or channels
  are split otherwise than the layer's params (either way round);
* the pieces of flash-decode, in one process on the plain version: a
  sequence-sharded cache written slice by slice (an int and a per-slot
  tensor ``cache_index``) is the whole cache's write, and K1's partials
  over the slices at ``flash_positions(..., k_offset=...)``, folded by
  ``context.merge_partials`` as flash-decode folds them, are the whole
  call's output (o 1e-6, m and l 1e-5), a slice with no visible
  key included.
"""
import numpy as np
import pytest
import torch

from repro.compat import abstract_mesh as jax_abstract_mesh
from repro.configs.registry import get_config as jax_get_config
from repro.core.strategy import ExecutionPlan as JaxPlan
from repro.core.strategy import LayerStrategy as JaxStrategy
from repro.models import build_model as jax_build_model
from repro.parallel import sharding as jshd
from repro_torch import serving
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.strategy import ExecutionPlan, LayerStrategy
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models.common import tree_paths
from repro_torch.parallel import context
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.axes import abstract_mesh
from repro_torch.runtime import serve

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _jax_paths(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _jax_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _models(arch):
    return jax_build_model(jax_get_config(arch)), build_model(get_config(arch), device="cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_axes_and_abstract_cache_equal_jax(arch):
    jm, tm = _models(arch)
    assert tm.cache_logical_axes() == jm.cache_logical_axes()
    for batch, max_len in ((4, 36), (3, 4100)):
        want = dict(_jax_paths(jm.abstract_cache(batch, max_len)))
        got = dict(tree_paths(tm.abstract_cache(batch, max_len)))
        assert got.keys() == want.keys()
        for path, leaf in got.items():
            assert leaf.device.type == "meta", path
            assert tuple(leaf.shape) == tuple(want[path].shape), (path, batch, max_len)
            assert leaf.dtype == _DTYPES[str(want[path].dtype)], path


# (mesh, model axis size, the batches and max_lens: dividing and not)
_MESHES = [((2, 4), (4, 3), (36, 34)), ((16, 16), (32, 512, 3), (4096, 4100))]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_spec_trees_equal_jax(arch):
    jm, tm = _models(arch)
    axes = ("data", "model")
    for shape, batches, lens in _MESHES:
        jmesh, tmesh = jax_abstract_mesh(shape, axes), abstract_mesh(shape, axes)
        for tp in (shape[1], 1):
            kw = dict(arch="t", shape="t", mesh_axes=axes, mesh_shape=shape)
            js, ts = JaxStrategy(tp=tp, zero=0), LayerStrategy(tp=tp, zero=0)
            jplan = JaxPlan(**kw, layer_strategies=[js] * 2, default_strategy=js)
            tplan = ExecutionPlan(**kw, layer_strategies=[ts] * 2, default_strategy=ts)
            for batch, max_len in [(0, 0)] + [(b, n) for b in batches for n in lens]:
                want = dict(_jax_paths(jshd.cache_spec_tree(jm, jplan, jmesh, batch, max_len)))
                got = dict(tree_paths(shd.cache_spec_tree(tm, tplan, tmesh, batch, max_len)))
                assert got.keys() == want.keys()
                for path, spec in got.items():
                    assert spec == tuple(want[path]), (shape, tp, batch, max_len, path)


def test_cache_spec_layouts_the_engine_reads():
    """The dense cache on (data 2, model 4) at batch 4: positions over the
    model axis at max_len 36, whole at 34 (every KV head on every rank)."""
    tm = build_model(get_config("qwen2.5-3b"), device="cpu")
    mesh = abstract_mesh((2, 4), ("data", "model"))
    s = LayerStrategy(tp=4, zero=0)
    plan = ExecutionPlan(arch="t", shape="t", mesh_axes=("data", "model"), mesh_shape=(2, 4),
                         layer_strategies=[s] * 2, default_strategy=s)
    assert shd.cache_spec_tree(tm, plan, mesh, 4, 36)["k"] == (None, "data", "model")
    assert shd.cache_spec_tree(tm, plan, mesh, 4, 34)["k"] == (None, "data")


def _plan(strategy: LayerStrategy, layers: int = 2, pp: int = 1, axes=("data", "model"),
          shape=(2, 2), second=None):
    strategies = [strategy] * (layers - 1) + [second or strategy]
    return ExecutionPlan(arch="t", shape="t", mesh_axes=axes, mesh_shape=shape, pp=pp,
                         layer_strategies=strategies, default_strategy=strategy)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "whisper-tiny"])
def test_a_serving_mesh_refuses_the_other_families(arch):
    cfg = get_config(arch).reduced()
    mesh = abstract_mesh((2, 2), ("data", "model"))
    with pytest.raises(NotImplementedError, match="Queue 1 item 4") as info:
        serving.step_engine(build_model(cfg, device="cpu"), _plan(LayerStrategy(tp=2)), mesh,
                            batch=4, max_len=36, device="cpu")
    assert cfg.family in str(info.value) and "mesh" in str(info.value)


@pytest.mark.parametrize("plan", [
    _plan(LayerStrategy(tp=2, sp=True)),
    _plan(LayerStrategy(tp=2, cp=2), axes=("cp", "data", "model"), shape=(2, 1, 2)),
    _plan(LayerStrategy(tp=2), pp=2, axes=("pod", "data", "model"), shape=(2, 1, 2)),
    _plan(LayerStrategy(ep=2)),
    _plan(LayerStrategy(tp=2, zero=3)),
    _plan(LayerStrategy(tp=2), second=LayerStrategy(tp=1)),
], ids=["sp", "cp2", "pp2", "ep2", "zero3", "mixed-tp"])
def test_a_serving_mesh_refuses_the_plans_it_does_not_hold(plan):
    for arch in ("qwen2.5-3b", "internvl2-26b", "mamba2-2.7b", "zamba2-7b"):
        model = build_model(get_config(arch).reduced(), device="cpu")
        mesh = abstract_mesh(plan.mesh_shape, plan.mesh_axes)
        with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
            serving.step_engine(model, plan, mesh, batch=4, max_len=36, device="cpu")


# (mesh, the batches and max_lens: dividing and not)
_STATE_MESHES = [((2, 4), (4, 3), (36, 34)), ((16, 16), (32, 1), (32768, 524290))]


def _serve_plans(shape):
    axes = ("data", "model")
    kw = dict(arch="t", shape="t", mesh_axes=axes, mesh_shape=shape)
    js, ts = JaxStrategy(tp=shape[1], zero=0), LayerStrategy(tp=shape[1], zero=0)
    return (JaxPlan(**kw, layer_strategies=[js] * 2, default_strategy=js),
            ExecutionPlan(**kw, layer_strategies=[ts] * 2, default_strategy=ts),
            jax_abstract_mesh(shape, axes), abstract_mesh(shape, axes))


@pytest.mark.parametrize("shape", [m[0] for m in _STATE_MESHES], ids=["2x4", "16x16"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_ssm_and_hybrid_cache_layouts_equal_jax(arch, shape):
    """The flat SSM state and the hybrid's nested cache: the rows' split is
    JAX's spec at the batch dim of every leaf, ``cache_seq`` JAX's at the
    attention cache's positions (None for mamba2: no positions), and the
    engine's own param and cache layouts pass ``check_state_layout``."""
    jm, tm = _models(arch)
    jplan, tplan, jmesh, tmesh = _serve_plans(shape)
    batches, lens = {m[0]: m[1:] for m in _STATE_MESHES}[shape]
    params = shd.param_spec_tree(tm, tplan, tmesh)
    for batch in batches:
        for max_len in lens:
            want = dict(_jax_paths(jshd.cache_spec_tree(jm, jplan, jmesh, batch, max_len)))
            specs = shd.cache_spec_tree(tm, tplan, tmesh, batch, max_len)
            assert {p: tuple(s) for p, s in tree_paths(specs)} == \
                {p: tuple(s) for p, s in want.items()}
            state = ("mamba", "ssm") if arch == "zamba2-7b" else ("ssm",)
            rows = (tuple(want[state]) + (None,) * 2)[1]
            seq = (tuple(want[("attn", "k")]) + (None,) * 3)[2] if arch == "zamba2-7b" else None
            assert serve.cache_layout(tm, specs) == (rows, seq), (batch, max_len)
            serve.check_state_layout(tm, params, specs)
            assert (rows is None) == (batch % shape[0] != 0)
            if arch == "zamba2-7b":
                assert (seq is None) == (max_len % shape[1] != 0)
    # mamba2's vocab of 50 280 does not split over 16 ranks: its table stays whole
    vocab_split = tuple(params["embed"]["tok"]) != ()
    assert vocab_split == (arch == "zamba2-7b" or shape[1] == 4)


def _with_leaf(tree: dict, path: tuple, spec) -> dict:
    out = dict(tree)
    out[path[0]] = _with_leaf(tree[path[0]], path[1:], spec) if len(path) > 1 else spec
    return out


@pytest.mark.parametrize("arch, leaf, spec", [
    ("mamba2-2.7b", ("ssm",), (None, "data")),
    ("mamba2-2.7b", ("conv_x",), (None, "data")),
    ("mamba2-2.7b", ("conv_B",), (None, "data", None, "model")),
    ("zamba2-7b", ("mamba", "ssm"), (None, "data")),
], ids=["ssm-whole", "conv_x-whole", "conv_B-split", "hybrid-ssm-whole"])
def test_a_mismatched_state_layout_is_refused(arch, leaf, spec):
    """A cache leaf left whole where the params split its heads or
    channels, or split where they are whole, is a ``ValueError`` naming
    the leaf: the layer would write its shard into the wrong layout."""
    _, tm = _models(arch)
    _, tplan, _, tmesh = _serve_plans((2, 4))
    params = shd.param_spec_tree(tm, tplan, tmesh)
    specs = shd.cache_spec_tree(tm, tplan, tmesh, 4, 36)
    serve.check_state_layout(tm, params, specs)
    with pytest.raises(ValueError, match="/".join(leaf)):
        serve.check_state_layout(tm, params, _with_leaf(specs, leaf, spec))


def test_a_serving_mesh_is_a_process_mesh():
    """A plan the mesh engine holds, on a mesh with no processes behind it:
    the trainer's layout check refuses it (a ``ProcessMesh`` is needed)."""
    model = build_model(get_config("qwen2.5-3b").reduced(), device="cpu")
    with pytest.raises(TypeError, match="ProcessMesh"):
        serving.step_engine(model, _plan(LayerStrategy(tp=2)),
                            abstract_mesh((2, 2), ("data", "model")), batch=4, max_len=36,
                            device="cpu")


# ------------------------------------------------------- flash-decode pieces

def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_cache_writes_are_the_whole_write(n):
    rng = np.random.default_rng(0)
    B, S, KV, hd, Sq = 4, 36, 2, 8, 3
    S_l = S // n
    whole = _rand(rng, B, S, KV, hd)
    for cache_index in (5, 16, 33, torch.tensor(8), torch.tensor([0, 7, 17, 33])):
        new = _rand(rng, B, Sq, KV, hd)
        ref = whole.clone()
        attn.write_cache(ref, new, cache_index)
        parts = [whole[:, r * S_l:(r + 1) * S_l].clone() for r in range(n)]
        for r, part in enumerate(parts):
            attn.write_cache_shard(part, new, cache_index, r * S_l)
        assert torch.equal(torch.cat(parts, dim=1), ref), cache_index


def test_flash_decode_partials_merge_to_the_whole_call():
    """K1's plain version over every slice of a 36-key cache on 4 ranks
    (per-slot query positions and kv_len, g = 4), merged, against one call
    over the whole cache: o within 1e-6, the merged (m, l) the whole call's
    within 1e-5 (the residuals' tolerance).  Slot 0 sees keys 0..4 alone,
    so ranks 1-3 hold no visible key for it (the mean of v, m = NEG_INF)
    and weigh nothing."""
    rng = np.random.default_rng(1)
    B, Sq, H, KV, hd, S, n = 3, 1, 8, 2, 16, 36, 4
    S_l = S // n
    q, k, v = _rand(rng, B, Sq, H, hd), _rand(rng, B, S, KV, hd), _rand(rng, B, S, KV, hd)
    pos = torch.tensor([4, 20, 35])
    kv_len = torch.tensor([5, 19, 36])
    q_pos, k_pos = attn.flash_positions(pos, Sq, S, kv_len, B, "cpu")
    out, m, l = flash_ref.flash_attention_fwd(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                              return_residuals=True)
    parts = []
    for r in range(n):
        qp, kp = attn.flash_positions(pos, Sq, S_l, kv_len, B, "cpu", k_offset=r * S_l)
        assert torch.equal(qp, q_pos) and torch.equal(kp, k_pos[:, r * S_l:(r + 1) * S_l])
        parts.append(flash_ref.flash_attention_fwd(
            q, k[:, r * S_l:(r + 1) * S_l], v[:, r * S_l:(r + 1) * S_l], q_pos=qp, k_pos=kp,
            return_residuals=True))
    neg = torch.tensor(attn.NEG_INF, dtype=torch.float32)
    assert all(torch.equal(p[1][0], neg.expand_as(p[1][0])) for p in parts[1:])
    o2, m2, l2 = parts[0][0], parts[0][1].transpose(-1, -2), parts[0][2].transpose(-1, -2)
    for p in parts[1:]:
        o2, m2, l2 = context.merge_partials(o2, m2, l2, p[0], p[1].transpose(-1, -2),
                                            p[2].transpose(-1, -2))
    torch.testing.assert_close(o2, out, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(m2.transpose(-1, -2), m, atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(l2.transpose(-1, -2), l, atol=1e-5, rtol=1e-6)


def test_flash_positions_key_offset():
    q_pos, k_pos = attn.flash_positions(7, 2, 4, torch.tensor([9, 6]), 2, "cpu", k_offset=4)
    assert q_pos.tolist() == [7, 8]
    assert k_pos.tolist() == [[4, 5, 6, 7], [4, 5, attn.INT32_MAX, attn.INT32_MAX]]
    assert attn.flash_positions(0, 3, 4, None, 2, "cpu") is None
    assert attn.flash_positions(0, 3, 4, None, 2, "cpu", k_offset=4)[1].tolist() == [4, 5, 6, 7]

