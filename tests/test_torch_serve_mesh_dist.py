"""The serving engine on a mesh (``serving.step_engine(model, plan, mesh)``)
against JAX's single-device ``ServingEngine`` and the port's own, on gloo
ranks (``tests/_torch_dist.py::serve_cases``): one spawn of 4 CPU ranks
serves every case, in fp32, on JAX-initialised weights (zero biases and
unit norms perturbed).

Cases (B 4): qwen2.5-3b ``reduced()`` (one KV head) under tp 2 on (data 2,
model 2) and tp 4 on (data 1, model 4), each at a ``max_len`` whose
positions split over the model axis (36: flash-decode over a
sequence-sharded cache) and one where they do not (35 on tp 2, 34 on tp
4: the whole cache on every rank); the same with two KV heads on tp 2 (the
K/V projections sharded, the cache gathered to every KV head); a prompt of
8 in 36 positions on tp 4, whose first decode step finds no visible key on
ranks 1-3; internvl2-26b ``reduced()`` under tp 2 with seeded patch
embeddings (``cache_index = Sv + S + i``).

Each case prefills, then takes teacher-forced decode steps with per-slot
``kv_len`` that differ (a last step at a per-slot or 0-d tensor
``cache_index`` where named).  Held: the logits of every step within 1e-4
of their scale of JAX's single-device engine (the int steps) and within
1e-5 of the port's single-device engine; the gathered cache, after the
prefill and after the last step, within 1e-5 of the single-device cache;
``greedy_generate``'s tokens (up to 4) the same on every rank and equal
to the port's single-device engine's (held to JAX's by
``tests/test_torch_compiled.py``); the engine's ``cache_specs`` and each
rank's local cache shape (the prefill's, and ``init_cache``'s under the
engine's rules) as ``cache_spec_tree`` lays them out.  The decode steps
under tp also hold the vocab-sharded lookup of ``forward_decode``.
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
from tests._torch_dist import run_ranks
from tests._torch_params import perturbed

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
]
SPECS = {"tp2_seq": (None, "data", "model"), "tp2_whole": (None, "data"),
         "tp2_kv2": (None, "data", "model"), "vlm_tp2": (None, "data", "model"),
         "tp4_seq": (None, "data", "model"), "tp4_whole": (None, "data"),
         "tp4_short": (None, "data", "model")}
KV_SHORT = (0, 1, 0, 2)       # each step's kv_len: its position + 1, less these


def _build(name, arch, mesh, tp, S, max_len, overrides, last):
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    if overrides:
        cfg, jcfg = dataclasses.replace(cfg, **overrides), dataclasses.replace(jcfg, **overrides)
    jm = jax_build_model(jcfg)
    np_params = perturbed(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
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
                steps=[])
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
    out = {"prefill": logits, "prefill_cache": {k: v.clone() for k, v in cache.items()},
           "steps": []}
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


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_mesh_engine_matches_single_device_engines(served, case):
    name, local = case[0], case[8]
    built, ranks = served
    spec, jm, jcfg, np_params, extras = built[name]
    one = _single_device(spec)
    jax_one = _jax_single_device(spec, jm, jcfg, np_params, extras)
    for rank, res in enumerate(r[name] for r in ranks):
        who = f"{name} rank {rank}"
        assert res["specs"]["k"] == res["specs"]["v"] == SPECS[name], who
        assert res["local"] == res["sized"] == local, who
        _close(res["prefill"], one["prefill"], TOL_PORT, f"{who} prefill vs the port")
        _close(res["prefill"], jax_one["prefill"], TOL_JAX, f"{who} prefill vs JAX")
        for key in ("k", "v"):
            _close(res["prefill_cache"][key], one["prefill_cache"][key], TOL_PORT,
                   f"{who} prefill cache {key}")
            _close(res["cache"][key], one["cache"][key], TOL_PORT, f"{who} last cache {key}")
        assert len(res["steps"]) == len(spec["steps"]) > 0
        for i, (got, want, jwant) in enumerate(zip(res["steps"], one["steps"],
                                                   jax_one["steps"])):
            _close(got, want, TOL_PORT, f"{who} step {i} vs the port")
            if jwant is not None:
                _close(got, jwant, TOL_JAX, f"{who} step {i} vs JAX")
        assert torch.equal(res["greedy"], ranks[0][name]["greedy"]), who
        np.testing.assert_array_equal(res["greedy"].numpy(), one["greedy"].numpy(), who)
