"""The port's sharding rules (``repro_torch.parallel.{axes,sharding}``,
``launch.mesh.train_mesh_spec``) against JAX's, with no process group: the
rules read only a mesh's axis names and sizes (JAX's ``AbstractMesh``, the
port's ``MeshShape``), and every spec must be equal as a tuple.

* ``param_spec_tree`` (kinds param, grad, opt) for every arch and the
  three strategies of ``tests/test_sharding.py`` on the (16, 16) and
  (2, 16, 16) meshes;
* ``act_rules`` and its specs, ``batch_spec``, ``train_mesh_spec`` for 1 to
  16 devices with pp and cp;
* ``MeshRules.spec_for_shape`` as a property: JAX's spec, and every
  sharded dim divisible;
* ``group_blocks`` / ``ungroup_blocks`` round trip, and the shards every
  rank of a mesh cuts (``shard_leaf``) tile the canonical leaf.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.compat import abstract_mesh as jax_abstract_mesh
from repro.configs.registry import get_config as jax_get_config
from repro.core.strategy import ExecutionPlan as JaxPlan
from repro.core.strategy import LayerStrategy as JaxStrategy
from repro.launch import mesh as jax_mesh
from repro.models import build_model as jax_build_model
from repro.parallel import sharding as jshd
from repro.parallel.axes import MeshRules as JaxRules
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.strategy import ExecutionPlan, LayerStrategy
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import AxisGroup
from repro_torch.models import build_model
from repro_torch.models.common import tree_map, tree_paths
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.axes import MeshRules, abstract_mesh
from tests._prop import given, settings, st

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
STRATEGIES = [dict(tp=16, sp=True, zero=3), dict(tp=1, zero=3), dict(tp=16, zero=1)]


def _plans(strat: dict, shape, axes, layers: int, pp: int = 1):
    kw = dict(arch="t", shape="t", mesh_axes=tuple(axes), mesh_shape=tuple(shape), pp=pp)
    js, ts = JaxStrategy(**strat), LayerStrategy(**strat)
    return (JaxPlan(**kw, layer_strategies=[js] * layers, default_strategy=js),
            ExecutionPlan(**kw, layer_strategies=[ts] * layers, default_strategy=ts))


def _spec(jax_spec) -> tuple:
    return tuple(jax_spec)


def _meshes(shape, axes):
    return jax_abstract_mesh(shape, axes), abstract_mesh(shape, axes)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("strat", STRATEGIES, ids=["tp16-sp-z3", "tp1-z3", "tp16-z1"])
def test_param_spec_trees_equal_jax(arch, strat):
    cfg = get_config(arch)
    if cfg.num_experts and strat["tp"] == 1:        # as tests/test_sharding.py does
        strat = dict(strat, ep=16 if cfg.num_experts % 16 == 0 else 1)
    jm, tm = jax_build_model(jax_get_config(arch)), build_model(cfg, device="cpu")
    for shape, axes in MESHES:
        jmesh, tmesh_ = _meshes(shape, axes)
        jplan, tplan = _plans(strat, shape, axes, cfg.num_layers)
        for kind in ("param", "grad", "opt"):
            want = jshd.param_spec_tree(jm, jplan, jmesh, kind=kind)
            got = shd.param_spec_tree(tm, tplan, tmesh_, kind=kind)
            flat = dict(tree_paths(got))
            jflat = {tuple(p): s for p, s in _jax_paths(want)}
            assert flat.keys() == jflat.keys(), (arch, kind)
            for path, spec in flat.items():
                assert spec == _spec(jflat[path]), (arch, shape, kind, path)


def _jax_paths(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _jax_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_grouped_param_spec_trees_equal_jax():
    """A two-group plan: per-group block specs (``g000``, ``g001``) as JAX's."""
    cfg = get_config("qwen3-14b")
    jm, tm = jax_build_model(jax_get_config("qwen3-14b")), build_model(cfg, device="cpu")
    half = cfg.num_layers // 2
    a, b = dict(tp=16, sp=True, zero=1), dict(tp=1, zero=3)
    for shape, axes in MESHES:
        kw = dict(arch="t", shape="t", mesh_axes=axes, mesh_shape=shape)
        jplan = JaxPlan(**kw, layer_strategies=[JaxStrategy(**a)] * half
                        + [JaxStrategy(**b)] * (cfg.num_layers - half),
                        default_strategy=JaxStrategy(**a))
        tplan = ExecutionPlan(**kw, layer_strategies=[LayerStrategy(**a)] * half
                              + [LayerStrategy(**b)] * (cfg.num_layers - half),
                              default_strategy=LayerStrategy(**a))
        jmesh, tmesh_ = _meshes(shape, axes)
        for kind in ("param", "grad", "opt"):
            got = dict(tree_paths(shd.param_spec_tree(tm, tplan, tmesh_, kind=kind)))
            want = dict(_jax_paths(jshd.param_spec_tree(jm, jplan, jmesh, kind=kind)))
            assert got.keys() == want.keys()
            assert ("blocks", "g001", "attn", "wq") in got
            for path, spec in got.items():
                assert spec == _spec(want[path]), (shape, kind, path)


@pytest.mark.parametrize("strat", STRATEGIES + [dict(tp=16, sp=True, zero=0, cp=2),
                                                dict(tp=1, ep=16)],
                         ids=["tp16-sp-z3", "tp1-z3", "tp16-z1", "tp16-sp-cp2", "ep16"])
def test_act_rules_and_batch_spec_equal_jax(strat):
    logical = [("batch", "seq", "embed"), ("batch", None, "q_heads", None),
               ("batch", "cp_seq", "q_heads", None), ("experts", "moe_capacity", "ff"),
               ("batch", None, "vocab"), ("batch", "seq", "ssm_heads")]
    for shape, axes in MESHES + [((2, 4, 2), ("cp", "data", "model"))]:
        jmesh, tmesh_ = _meshes(shape, axes)
        jplan, tplan = _plans(strat, shape, axes, 4)
        jr = jshd.act_rules(jplan, jplan.default_strategy, jmesh)
        tr = shd.act_rules(tplan, tplan.default_strategy, tmesh_)
        assert tr.rules == jr.rules and tr.ring == jr.ring, (shape, strat)
        for la in logical:
            assert tr.spec(la) == _spec(jr.spec(la)), (shape, la)
            assert tr.axis_size(la[-1] or "embed") == jr.axis_size(la[-1] or "embed")
        for gb in (None, 1, 8, 256, 512):
            for m in ((None, None), (jmesh, tmesh_)):
                want = jshd.batch_spec(jplan, gb, m[0])
                assert shd.batch_spec(tplan, gb, m[1]) == _spec(want), (shape, gb)


def test_train_mesh_spec_equals_jax():
    for n in range(1, 17):
        for pp in (1, 2, 4):
            for cp in (1, 2, 3):
                try:
                    want = jax_mesh.train_mesh_spec(n, pp=pp, cp=cp)
                except ValueError:
                    with pytest.raises(ValueError):
                        tmesh.train_mesh_spec(n, pp=pp, cp=cp)
                    continue
                assert tmesh.train_mesh_spec(n, pp=pp, cp=cp) == want, (n, pp, cp)


_TARGETS = [None, "data", "model", ("data", "model"), ("pod", "data"), ("model", "data")]


@settings(max_examples=60, deadline=None)
@given(q=st.sampled_from(_TARGETS), e=st.sampled_from(_TARGETS), f=st.sampled_from(_TARGETS),
       d0=st.integers(1, 96), d1=st.integers(1, 96), d2=st.integers(1, 96))
def test_spec_for_shape_property(q, e, f, d0, d1, d2):
    """For any rules and shape: JAX's spec, every sharded dim divisible by
    its mesh-axis product, no mesh axis twice."""
    rules = {k: v for k, v in (("q_heads", q), ("embed", e), ("ff", f)) if v is not None}
    shape = (2, 16, 16)
    jmesh, tmesh_ = _meshes(shape, ("pod", "data", "model"))
    logical, dims = ("embed", "q_heads", "ff"), (d0, d1, d2)
    got = MeshRules(rules=rules, mesh=tmesh_).spec_for_shape(logical, dims)
    assert got == _spec(JaxRules(rules=rules, mesh=jmesh).spec_for_shape(logical, dims))
    seen = []
    for dim, axes in shd.spec_dims(got):
        assert dims[dim] % int(np.prod([tmesh_.shape[a] for a in axes])) == 0
        seen += list(axes)
    assert len(seen) == len(set(seen))


def _llama_tree(layers: int = 4):
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(), num_layers=layers)
    m = build_model(cfg, device="cpu")
    return cfg, m, m.init(torch.Generator().manual_seed(0))


def test_group_then_ungroup_is_the_identity():
    cfg, _, params = _llama_tree()
    s1, s2 = LayerStrategy(tp=2, sp=True), LayerStrategy(tp=1, zero=3)
    plan = ExecutionPlan(arch=cfg.name, shape="t", mesh_axes=("data", "model"),
                         mesh_shape=(2, 2), layer_strategies=[s1, s1, s2, s2],
                         default_strategy=s1)
    grouped = shd.group_blocks(params, plan)
    assert sorted(grouped["blocks"]) == ["g000", "g001"]
    assert grouped["blocks"]["g001"]["attn"]["wq"].shape[0] == 2
    back = shd.ungroup_blocks(grouped, plan)
    for (p1, a), (p2, b) in zip(tree_paths(back), tree_paths(params)):
        assert p1 == p2 and torch.equal(a, b)
    uniform = ExecutionPlan(arch=cfg.name, shape="t", mesh_axes=("data",), mesh_shape=(1,),
                            layer_strategies=[s2] * 4, default_strategy=s2)
    assert shd.group_blocks(params, uniform) is params


class _RankView:
    """The shard arithmetic of one rank of a mesh, with no process group:
    ``group(axes)`` gives the rank's index over those axes."""

    def __init__(self, shape, axes, rank):
        self.axis_names, self.sizes = tuple(axes), tuple(shape)
        self.shape = dict(zip(axes, shape))
        coords, r = [], rank
        for s in reversed(shape):
            coords.append(r % s)
            r //= s
        self.coords = dict(zip(axes, reversed(coords)))

    def group(self, axes):
        axes = axes if isinstance(axes, tuple) else (axes,)
        size, index = 1, 0
        for a in axes:
            size *= self.shape[a]
            index = index * self.shape[a] + self.coords[a]
        return AxisGroup(axes, size, index)


@pytest.mark.parametrize("strat", [dict(tp=2, zero=3), dict(tp=1, zero=3),
                                   dict(tp=2, sp=True, zero=1)])
def test_every_ranks_shards_tile_the_canonical_tree(strat):
    """``place_params`` on each of a (2, 2) mesh's ranks: the shards, laid
    back at their spec's offsets, cover every leaf exactly once."""
    cfg, model, params = _llama_tree(2)
    shape, axes = (2, 2), ("data", "model")
    _, plan = _plans(strat, shape, axes, cfg.num_layers)
    specs = shd.param_spec_tree(model, plan, abstract_mesh(shape, axes), kind="param")
    covered = tree_map(lambda x: torch.zeros_like(x), params)
    for rank in range(4):
        view = _RankView(shape, axes, rank)
        local = shd.place_params(params, specs, view)

        def lay(full, cover, piece, spec):
            index = [slice(None)] * full.dim()
            for dim, dim_axes in shd.spec_dims(spec):
                g = view.group(dim_axes)
                n = full.shape[dim] // g.size
                index[dim] = slice(g.index * n, (g.index + 1) * n)
            assert torch.equal(full[tuple(index)], piece)
            cover[tuple(index)] += 1
            return piece

        tree_map(lay, params, covered, local, specs)
    flat_specs = dict(tree_paths(specs))
    for path, c in tree_paths(covered):
        shards = int(np.prod([view.shape[a] for _, dim_axes in shd.spec_dims(flat_specs[path])
                              for a in dim_axes]))
        assert torch.all(c == 4 // shards), path


@pytest.mark.parametrize("heads,kv,tp,want", [
    (4, 1, 2, [[0], [0]]),                      # the reduced configs: one KV head kept
    (32, 8, 2, [[0, 1, 2, 3], [4, 5, 6, 7]]),   # compact, as a sharded KV dim gives
    (16, 2, 16, [[0]] * 8 + [[1]] * 8),          # qwen2.5-3b at tp 16
    (6, 3, 2, [[0, 0, 1], [1, 2, 2]]),          # uneven: one KV head per query head
])
def test_local_kv_heads_follow_global_query_heads(heads, kv, tp, want):
    from repro_torch.models.attention import local_kv_heads

    local = heads // tp
    assert [local_kv_heads(heads, kv, r * local, local) for r in range(tp)] == want
