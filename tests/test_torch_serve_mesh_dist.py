"""The serving engine on a mesh (``serving.step_engine(model, plan, mesh)``)
against JAX's single-device ``ServingEngine`` and the port's own, on gloo
ranks (``tests/_torch_dist.py::serve_cases``): one spawn of 4 CPU ranks
serves every case, in fp32, on JAX-initialised weights (zero biases and
unit norms perturbed; in the ssm and hybrid cases each SSM head's
``A_log``, ``D`` and ``dt_bias`` drawn apart too, ``perturbed_heads``).

Cases (B 4): qwen2.5-3b ``reduced()`` (one KV head) under tp 2 on (data 2,
model 2) and tp 4 on (data 1, model 4), each at a ``max_len`` whose
positions split over the model axis (36: flash-decode over a
sequence-sharded cache) and one where they do not (35 on tp 2, 34 on tp
4: the whole cache on every rank); the same with two KV heads on tp 2 (the
K/V projections sharded, the cache gathered to every KV head); a prompt of
8 in 36 positions on tp 4, whose first decode step finds no visible key on
ranks 1-3; internvl2-26b ``reduced()`` under tp 2 with seeded patch
embeddings (``cache_index = Sv + S + i``); mamba2-2.7b ``reduced()`` (8
SSM heads in 1 group, ``d_inner`` 256) under tp 2 and tp 4 (the SSD state
by heads, ``conv_x`` by channels, ``conv_B`` / ``conv_C`` whole); zamba2-7b
``reduced()`` at 6 layers (3 shared-block sites, 8 SSM heads in 2 groups,
4 KV heads at hd 32) under tp 2 and tp 4, each at a split (36) and a whole
(35 / 34) attention cache.

Each case prefills, then takes teacher-forced decode steps with per-slot
``kv_len`` that differ (a last step at a per-slot or 0-d tensor
``cache_index`` where named).  Held: the logits of every step within 1e-4
of their scale of JAX's single-device engine (the int steps) and within
1e-5 of the port's single-device engine; the gathered cache, leaf by leaf,
after the prefill and after the last step, within 1e-5 of the
single-device cache; ``conv_B`` / ``conv_C`` bitwise the same on every
rank of the model axis; ``greedy_generate``'s tokens (up to 4) the same on
every rank and equal to the port's single-device engine's (held to JAX's
by ``tests/test_torch_compiled.py``); the engine's ``cache_specs``, leaf by
leaf, and each rank's local cache shapes (the prefill's, and
``init_cache``'s under the engine's rules) as ``cache_spec_tree`` lays them
out.  The decode steps under tp also hold the vocab-sharded lookup of
``forward_decode``.  zamba2's 2 groups make a group fault visible: on tp 2
and tp 4, handing every rank all of a layer's B/C groups changes the
prefill's logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs.registry import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch import serving
from repro_torch.configs.registry import get_config
from repro_torch.models import build_model
from repro_torch.models.common import params_from_jax
from repro_torch.models.common import tree_map, tree_paths
from tests._torch_dist import run_ranks
from tests._torch_params import perturbed, perturbed_heads

B = 4
TOL_JAX, TOL_PORT = 1e-4, 1e-5


class _Float32:
    """A JAX model whose serving passes compute in fp32: JAX's engine calls
    them without a dtype (bf16 by default)."""

    def __init__(self, model):
        self._model = model

    def __getattr__(self, name):
        return getattr(self._model, name)

    def forward_prefill(self, *args, **kw):
        return self._model.forward_prefill(*args, dtype=jnp.float32, **kw)

    def forward_decode(self, *args, **kw):
        return self._model.forward_decode(*args, dtype=jnp.float32, **kw)


# name, arch, mesh, tp, prompt, max_len, config overrides, last step's index form, local k
CASES = [
    ("tp2_seq", "qwen2.5-3b", (2, 2), 2, 32, 36, None, "per_slot", (2, 2, 18, 1, 32)),
    ("tp2_whole", "qwen2.5-3b", (2, 2), 2, 32, 35, None, None, (2, 2, 35, 1, 32)),
    ("tp2_kv2", "qwen2.5-3b", (2, 2), 2, 32, 36, {"num_kv_heads": 2}, None,
     (2, 2, 18, 2, 32)),
    ("vlm_tp2", "internvl2-26b", (2, 2), 2, 16, 36, None, None, (2, 2, 18, 1, 32)),
    ("tp4_seq", "qwen2.5-3b", (1, 4), 4, 32, 36, None, None, (2, 4, 9, 1, 32)),
    ("tp4_whole", "qwen2.5-3b", (1, 4), 4, 32, 34, None, "scalar", (2, 4, 34, 1, 32)),
    ("tp4_short", "qwen2.5-3b", (1, 4), 4, 8, 36, None, None, (2, 4, 9, 1, 32)),
    ("ssm_tp2", "mamba2-2.7b", (2, 2), 2, 32, 36, None, None, None),
    ("ssm_tp4", "mamba2-2.7b", (1, 4), 4, 32, 36, None, "scalar", None),
    ("hybrid_tp2_seq", "zamba2-7b", (2, 2), 2, 32, 36, {"num_layers": 6}, "per_slot", None),
    ("hybrid_tp2_whole", "zamba2-7b", (2, 2), 2, 32, 35, {"num_layers": 6}, None, None),
    ("hybrid_tp4_seq", "zamba2-7b", (1, 4), 4, 32, 36, {"num_layers": 6}, None, None),
    ("hybrid_tp4_whole", "zamba2-7b", (1, 4), 4, 32, 34, {"num_layers": 6}, None, None),
]
_SEQ, _WHOLE = (None, "data", "model"), (None, "data")
_SSM = {"conv_x": (None, "data", None, "model"), "conv_B": _WHOLE, "conv_C": _WHOLE,
        "ssm": (None, "data", "model")}
#: each case's cache_specs, leaf by leaf
SPECS = {"tp2_seq": {"k": _SEQ, "v": _SEQ}, "tp2_whole": {"k": _WHOLE, "v": _WHOLE},
         "tp2_kv2": {"k": _SEQ, "v": _SEQ}, "vlm_tp2": {"k": _SEQ, "v": _SEQ},
         "tp4_seq": {"k": _SEQ, "v": _SEQ}, "tp4_whole": {"k": _WHOLE, "v": _WHOLE},
         "tp4_short": {"k": _SEQ, "v": _SEQ}, "ssm_tp2": _SSM, "ssm_tp4": _SSM,
         "hybrid_tp2_seq": {"mamba": _SSM, "attn": {"k": _SEQ, "v": _SEQ}},
         "hybrid_tp2_whole": {"mamba": _SSM, "attn": {"k": _WHOLE, "v": _WHOLE}},
         "hybrid_tp4_seq": {"mamba": _SSM, "attn": {"k": _SEQ, "v": _SEQ}},
         "hybrid_tp4_whole": {"mamba": _SSM, "attn": {"k": _WHOLE, "v": _WHOLE}}}
KV_SHORT = (0, 1, 0, 2)       # each step's kv_len: its position + 1, less these
#: the cases that also prefill with every rank handed all of the B/C groups
NAIVE_GROUPS = ("hybrid_tp2_seq", "hybrid_tp4_seq")


def _local_shapes(cfg, specs: dict, mesh: tuple, max_len: int) -> dict:
    """{leaf path: shape} of a rank's shard of the whole cache (the model's
    ``abstract_cache`` at B and ``max_len``) as ``specs`` lays it out."""
    sizes = dict(zip(("data", "model"), mesh))
    whole = build_model(cfg, device="cpu").abstract_cache(B, max_len)
    specs = dict(tree_paths(specs))
    out = {}
    for path, leaf in tree_paths(whole):
        spec = tuple(specs[path]) + (None,) * (leaf.dim() - len(specs[path]))
        out["/".join(path)] = tuple(n // (sizes[ax] if ax else 1)
                                    for n, ax in zip(leaf.shape, spec))
    return out


def _build(name, arch, mesh, tp, S, max_len, overrides, last):
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    if overrides:
        cfg, jcfg = dataclasses.replace(cfg, **overrides), dataclasses.replace(jcfg, **overrides)
    jm = jax_build_model(jcfg)
    perturb = perturbed_heads if cfg.family in ("ssm", "hybrid") else perturbed
    np_params = perturb(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                        np.random.default_rng(0))
    rng = np.random.default_rng(len(name))
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
    Sv = cfg.vis_tokens if cfg.family == "vlm" else 0
    extras = None
    if Sv:
        extras = {"vis_embeds": rng.standard_normal((B, Sv, cfg.d_model)).astype(np.float32)}
    steps = []
    for i in range(min(3, max_len - Sv - S)):
        pos = Sv + S + i
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int64)
        steps.append((tok, pos, np.array([pos + 1 - d for d in KV_SHORT], np.int64)))
    case = dict(name=name, cfg=cfg, mesh=mesh, tp=tp, max_len=max_len,
                max_new=min(4, max_len - Sv - S),
                params=params_from_jax(np_params, "cpu", torch.float32),
                tokens=torch.from_numpy(tokens),
                extras=None if extras is None else {k: torch.from_numpy(v)
                                                    for k, v in extras.items()},
                steps=[], naive_groups=name in NAIVE_GROUPS)
    for j, (tok, pos, kv) in enumerate(steps):
        index = pos
        if j == len(steps) - 1 and last == "per_slot":     # two slots rewrite pos - 1
            index = torch.tensor([pos, pos - 1, pos, pos - 1])
        elif j == len(steps) - 1 and last == "scalar":
            index = torch.tensor(pos)
        case["steps"].append((torch.from_numpy(tok), index, torch.from_numpy(kv)))
    return case, jm, jcfg, np_params, extras


def _single_device(case):
    """The port's single-device engine on the case: (prefill logits and
    cache, each step's logits, the last cache, greedy tokens)."""
    cfg = case["cfg"]
    eng = serving.step_engine(build_model(cfg, device="cpu"), serving.single_device_plan(cfg),
                              batch=B, max_len=case["max_len"], dtype=torch.float32,
                              device="cpu")
    logits, cache = eng.prefill_step(case["params"], case["tokens"], case["extras"])
    out = {"prefill": logits, "prefill_cache": tree_map(torch.clone, cache), "steps": []}
    for tokens, index, kv_len in case["steps"]:
        logits, cache = eng.decode_step(case["params"], tokens, cache, index, kv_len)
        out["steps"].append(logits)
    out["cache"] = cache
    out["greedy"] = eng.greedy_generate(case["params"], case["tokens"], case["max_new"],
                                        case["max_len"])
    return out


def _jax_single_device(case, jm, jcfg, np_params, extras):
    """JAX's single-device engine (fp32 passes) on the case's int steps:
    (prefill logits, each int step's logits or None)."""
    jp = jax.tree.map(jnp.asarray, np_params)
    eng = jserving.step_engine(_Float32(jm), jserving.single_device_plan(jcfg), batch=B,
                               max_len=case["max_len"])
    jextras = None if extras is None else {k: jnp.asarray(v) for k, v in extras.items()}
    logits, cache = eng.prefill_step(jp, jnp.asarray(case["tokens"].numpy(), jnp.int32),
                                     jextras)
    out = {"prefill": np.asarray(logits), "steps": []}
    for tokens, index, kv_len in case["steps"]:
        if isinstance(index, torch.Tensor):
            out["steps"].append(None)
            continue
        logits, cache = eng.decode_step(jp, jnp.asarray(tokens.numpy(), jnp.int32), cache,
                                        jnp.int32(index), kv_len=jnp.asarray(kv_len.numpy(),
                                                                             jnp.int32))
        out["steps"].append(np.asarray(logits))
    return out


def _close(got, want, tol, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale, f"{what}: max |delta| {err:.3e} > {tol} x {scale:.3f}"


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    built = {c[0]: _build(*c[:8]) for c in CASES}
    ranks = run_ranks(4, "serve_cases", {"cases": [b[0] for b in built.values()]},
                      tmp_path_factory.mktemp("serve_mesh"), timeout=400)
    return built, ranks


def _leaves(tree) -> dict:
    return {"/".join(path): x for path, x in tree_paths(tree)}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_mesh_engine_matches_single_device_engines(served, case):
    name, mesh, max_len, local_k = case[0], case[2], case[5], case[8]
    built, ranks = served
    spec, jm, jcfg, np_params, extras = built[name]
    one = _single_device(spec)
    jax_one = _jax_single_device(spec, jm, jcfg, np_params, extras)
    local = _local_shapes(spec["cfg"], SPECS[name], mesh, max_len)
    if local_k is not None:
        assert local == {"k": local_k, "v": local_k}
    for rank, res in enumerate(r[name] for r in ranks):
        who = f"{name} rank {rank}"
        assert _leaves(res["specs"]) == _leaves(SPECS[name]), who
        assert res["local"] == res["sized"] == local, who
        _close(res["prefill"], one["prefill"], TOL_PORT, f"{who} prefill vs the port")
        _close(res["prefill"], jax_one["prefill"], TOL_JAX, f"{who} prefill vs JAX")
        for when, got, want in (("prefill", res["prefill_cache"], one["prefill_cache"]),
                                ("last", res["cache"], one["cache"])):
            want = _leaves(want)
            assert _leaves(got).keys() == want.keys(), who
            for key, leaf in _leaves(got).items():
                _close(leaf, want[key], TOL_PORT, f"{who} {when} cache {key}")
        assert len(res["steps"]) == len(spec["steps"]) > 0
        for i, (got, want, jwant) in enumerate(zip(res["steps"], one["steps"],
                                                   jax_one["steps"])):
            _close(got, want, TOL_PORT, f"{who} step {i} vs the port")
            if jwant is not None:
                _close(got, jwant, TOL_JAX, f"{who} step {i} vs JAX")
        assert torch.equal(res["greedy"], ranks[0][name]["greedy"]), who
        np.testing.assert_array_equal(res["greedy"].numpy(), one["greedy"].numpy(), who)
        # the whole B/C conv buffers: the same on every rank of the model axis
        first = ranks[rank - rank % mesh[1]][name]
        for when in ("prefill_conv", "conv"):
            assert res[when].keys() == first[when].keys(), who
            for key, leaf in res[when].items():
                assert torch.equal(leaf, first[when][key]), f"{who} {when} {key}"
        assert bool(res["conv"]) == (spec["cfg"].family in ("ssm", "hybrid")), who


@pytest.mark.parametrize("name", NAIVE_GROUPS)
def test_every_group_on_every_rank_changes_the_zamba2_logits(served, name):
    """zamba2's 2 B/C groups: a rank handed all of them maps its local heads
    to the wrong groups (as a naive port would), and the prefill's logits
    move well past the tolerance the engine is held to."""
    built, ranks = served
    one = _single_device(built[name][0])
    for rank, res in enumerate(r[name] for r in ranks):
        want = np.asarray(one["prefill"])
        scale = max(1.0, float(np.abs(want).max()))
        moved = float(np.abs(np.asarray(res["naive_groups"]) - want).max())
        assert moved > 1e2 * TOL_PORT * scale, (name, rank, moved)
