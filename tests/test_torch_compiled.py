"""The port's compiled serving steps on the CPU (``runtime/compiled.py``:
the static-buffer plumbing of a captured CUDA graph with a direct call in
place of the replay), against the JAX package's jitted steps on the same
weights (JAX ``model.init`` -> numpy, perturbed -> ``params_from_jax``)
and the same numpy inputs:

* the wrapper: fresh inputs give fresh answers, a new shape its own entry,
  a Python scalar is refused, a held argument is keyed by address, a
  donated one is adopted and written in place, ``donate=False`` clones;
* ``forward_decode`` with a 0-d tensor ``cache_index`` is bitwise the int
  form (every family: dense, VLM, mamba2, MoE, hybrid, audio);
* the scheduler's all-lanes decode: idle lanes write nothing outside the
  null page, and the compiled scheduler is bitwise the eager one (the JAX
  scheduler parity stays in ``tests/test_torch_serving.py``);
* ``ServingEngine.jit_prefill_step()`` + 8 ``jit_decode_step`` calls against
  JAX's ``jit_prefill_step()`` / ``jit_decode_step()`` in fp32: tokens
  identical, logits at 1e-4 (llama, internvl2 with seeded ``vis_embeds``,
  mamba2, moonshot, zamba2 with a trailing Mamba layer, whisper with seeded
  ``frames``); a nested cache (zamba2's) donated leaf by leaf, and the
  prefill's ``extras`` fed as frames or None.
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
from repro_torch.runtime.compiled import compile_step
from repro_torch.runtime.kv_cache import NULL_PAGE
from repro_torch.runtime.scheduler import DECODING, ContinuousBatchingScheduler
from tests._torch_params import perturbed

TOL32 = 1e-4
B = 2


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape, dtype=np.int32)


# ------------------------------------------------------------------ the wrapper

def test_wrapper_feeds_fresh_inputs_and_keys_on_shape():
    """A second call with new values of the same shapes gives the new answer
    (the static buffers are refreshed), and a new shape gets its own entry."""
    step = compile_step(lambda x, y: {"sum": x * 2 + y, "y": [y]}, "cpu")
    a, b = torch.arange(4.0), torch.ones(4)
    assert torch.equal(step(a, b)["sum"], a * 2 + b)
    c, d = torch.full((4,), 3.0), torch.arange(4.0)
    out = step(c, d)
    assert torch.equal(out["sum"], c * 2 + d) and torch.equal(out["y"][0], d)
    assert len(step.entries) == 1
    assert torch.equal(step(torch.ones(2, 3), torch.ones(3))["sum"], torch.full((2, 3), 3.0))
    assert len(step.entries) == 2
    step(c.to(torch.float64), d.to(torch.float64))
    assert len(step.entries) == 3                     # a new dtype, a new key


@pytest.mark.parametrize("scalar", [3, 0.5, True, "x"])
def test_wrapper_refuses_python_scalars(scalar):
    """A scalar would be baked into a capture: only tensors (and None) pass."""
    step = compile_step(lambda x, n: x, "cpu")
    with pytest.raises(TypeError, match="baked into the graph"):
        step(torch.ones(2), scalar)
    assert torch.equal(step(torch.ones(2), torch.tensor(3))[0:1], torch.ones(1))
    step(torch.ones(2), None)


def test_wrapper_keys_held_arguments_on_address_and_adopts_donated_ones():
    """A held argument is read in place, keyed by its address; a donated one
    is adopted by the key and written in place; passing another tensor of
    the donated shape copies it in."""
    def fn(w, state, x):
        state.add_(x * w)
        return state.sum()

    step = compile_step(fn, "cpu", held=(0,), donated=(1,))
    w, state = torch.full((3,), 2.0), torch.zeros(3)
    step(w, state, torch.ones(3))
    assert torch.equal(state, torch.full((3,), 2.0))   # written in place
    step(w, state, torch.ones(3))
    assert torch.equal(state, torch.full((3,), 4.0)) and len(step.entries) == 1
    step(w.clone(), state, torch.ones(3))               # new address: a new key
    assert len(step.entries) == 2
    other = torch.full((3,), 10.0)
    assert float(step(w, other, torch.ones(3))) == 36.0  # copied into the adopted buffer
    assert torch.equal(state, torch.full((3,), 12.0)) and torch.equal(other, torch.full((3,), 10.0))
    with pytest.raises(ValueError, match="read in place"):
        compile_step(fn, "cuda", held=(0,))(w, state, torch.ones(3))


# ------------------------------------------------------- device scalar cache_index

#: per arch, the reduced config's overrides: zamba2 with 7 layers (3 sites of
#: the shared block and a trailing Mamba layer), as chip_smoke checks it
REDUCED = {"zamba2-7b": {"num_layers": 7}}


def _reduced(get, arch):
    return dataclasses.replace(get(arch).reduced(), **REDUCED.get(arch, {}))


def _cpu_model(arch, **kw):
    cfg = dataclasses.replace(_reduced(get_config, arch), **kw)
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init(torch.Generator().manual_seed(3), torch.float32)


def _leaves(tree, path=()):
    """(path, tensor) of every leaf of a nested dict of tensors."""
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    return [leaf for k, v in tree.items() for leaf in _leaves(v, path + (k,))]


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return {k: _clone(v) for k, v in tree.items()}


def _side_inputs(cfg, seed=1):
    """The prefill's seeded ``extras`` (numpy): the VLM's patch embeddings,
    the encoder-decoder's frames; None for the other families."""
    rows = {"vlm": ("vis_embeds", cfg.vis_tokens), "audio": ("frames", cfg.enc_frames)}
    if cfg.family not in rows:
        return None
    name, n = rows[cfg.family]
    x = np.random.default_rng(seed).standard_normal((B, n, cfg.d_model)).astype(np.float32)
    return {name: x}


@pytest.mark.parametrize("arch", ["llama3.2-1b", "internvl2-26b", "mamba2-2.7b",
                                  "moonshot-v1-16b-a3b", "zamba2-7b", "whisper-tiny"])
def test_forward_decode_with_a_device_scalar_cache_index_is_the_int_form(arch):
    """``forward_decode`` at a 0-d tensor ``cache_index`` (and the kv_len the
    scheduler passes; none for whisper, as JAX's loop) gives the int form's
    logits and every (nested) cache leaf bitwise, over one token and, where
    the family decodes chunks, over a chunk of four."""
    cfg, model, params = _cpu_model(arch)
    S, max_len = 6, 16
    np_extras = _side_inputs(cfg) or {}
    extras = {k: torch.from_numpy(v) for k, v in np_extras.items()}
    Sv = cfg.vis_tokens if cfg.family == "vlm" else 0
    prompt = torch.from_numpy(_tokens(0, (B, S), cfg.vocab_size)).long()
    _, cache = model.forward_prefill(params, prompt, max_len=max_len + Sv, dtype=torch.float32,
                                     **extras)
    pos = S + Sv
    for sq in (1,) if cfg.family in ("ssm", "hybrid") else (1, 4):
        toks = torch.from_numpy(_tokens(sq, (B, sq), cfg.vocab_size)).long()
        kv_len = None if cfg.family in ("ssm", "audio") else torch.full((B,), pos + sq)
        want, want_cache = model.forward_decode(params, toks, _clone(cache), pos,
                                                kv_len=kv_len, dtype=torch.float32)
        got, got_cache = model.forward_decode(params, toks, _clone(cache), torch.tensor(pos),
                                              kv_len=kv_len, dtype=torch.float32)
        assert torch.equal(got, want)
        want_leaves = _leaves(want_cache)
        assert [p for p, _ in _leaves(got_cache)] == [p for p, _ in want_leaves]
        for (path, g), (_, w) in zip(_leaves(got_cache), want_leaves):
            assert torch.equal(g, w), path


# ------------------------------------------------------------- the scheduler

def _sched(compiled, num_slots=3, dtype=torch.float32):
    config = serving.ServeConfig(
        arch="llama3.2-1b", reduced=True, device="cpu",
        cache=serving.CacheConfig(max_context=32, page_size=4),
        scheduler=serving.SchedulerConfig(num_slots=num_slots, prefill_chunk=8))
    cfg = config.model_config()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(5), dtype)
    return ContinuousBatchingScheduler(model, params, config.cache_config(), prefill_chunk=8,
                                       dtype=dtype, compiled=compiled), cfg


def test_idle_lanes_write_only_the_null_page():
    """One live request among three slots: every decode tick changes pool
    bytes only at the live slot's write position and inside the null page
    (the idle lanes' all-null tables)."""
    sched, cfg = _sched(compiled=True)
    page = sched.cache.config.page_size
    req = sched.submit(serving.Request(prompt=_tokens(2, (11,), cfg.vocab_size),
                                       max_new=6)).request
    while req.state != DECODING:
        sched.tick()
    ticks = 0
    while not req.done:
        pos = int(sched.cache.kv_len[req.slot])
        sched.cache.ensure_capacity(req.slot, pos + 1)      # the tick's page, taken first
        write = int(sched.cache.block_tables[req.slot][pos // page]) * page + pos % page
        before = (sched.cache.k_pages.clone(), sched.cache.v_pages.clone())
        sched.tick()
        for old, new in zip(before, (sched.cache.k_pages, sched.cache.v_pages)):
            L, P = old.shape[:2]
            diff = (old != new).reshape(L, P * page, -1).any(dim=(0, 2))
            changed = set(torch.nonzero(diff).flatten().tolist())
            assert changed - set(range(NULL_PAGE * page, (NULL_PAGE + 1) * page)) == {write}
        ticks += 1
    assert ticks == 4           # the first decode step ran in the last prefill's tick


def test_compiled_scheduler_is_bitwise_the_eager_one():
    """The compiled steps (static buffers, host inputs fed) and the eager
    steps hand the sampler the same logits rows, bitwise, over chunked
    prefills and shared slots."""
    rows = {}
    for compiled in (True, False):
        sched, cfg = _sched(compiled, num_slots=2)
        rec = rows.setdefault(compiled, {})

        def sample(logits, request, rng, rec=rec):
            rec[(request.rid, len(request.tokens))] = logits.copy()
            return int(np.argmax(logits))

        sched._sample = sample
        for i, n in enumerate((5, 13, 9)):
            sched.submit(serving.Request(prompt=_tokens(30 + i, (n,), cfg.vocab_size),
                                         max_new=4))
        sched.run_until_drained()
        if compiled:            # static shapes: one entry per step
            assert len(sched._decode_fn.entries) == len(sched._prefill_fn.entries) == 1
    assert rows[True].keys() == rows[False].keys() and len(rows[True]) == 12
    for key in rows[True]:
        np.testing.assert_array_equal(rows[True][key], rows[False][key], err_msg=str(key))


# ---------------------------------------------------- the engine's jit steps

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


JIT_ARCHS = ["llama3.2-1b", "internvl2-26b", "mamba2-2.7b", "moonshot-v1-16b-a3b",
             "zamba2-7b", "whisper-tiny"]


@pytest.mark.parametrize("arch", JIT_ARCHS)
def test_jit_steps_match_jax_jit_steps(arch):
    """``jit_prefill_step()`` then 8 ``jit_decode_step(donate=True)`` calls,
    each fed the last argmax at ``cache_index = Sv + S + i`` (an int), with
    ``kv_len`` one past it for the decoder-only attention models (none for
    mamba2, and none for whisper, as JAX's loop passes none there), against
    JAX's jitted steps on the same fp32 weights: every step's tokens
    identical, logits within 1e-4.  internvl2 serves seeded patch
    embeddings, whisper seeded frames; zamba2 runs 7 layers (3 sites and a
    trailing Mamba layer) and donates its nested cache."""
    jcfg, tcfg = _reduced(jax_get_config, arch), _reduced(get_config, arch)
    jm = jax_build_model(jcfg)
    np_params = perturbed(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                          np.random.default_rng(0))
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = params_from_jax(np_params, "cpu", torch.float32)
    S, new = 6, 9
    Sv = tcfg.vis_tokens if tcfg.family == "vlm" else 0
    max_len = Sv + S + new
    prompts = _tokens(1, (B, S), tcfg.vocab_size)
    jextras = textras = None
    side = _side_inputs(tcfg, seed=2)
    if side:
        jextras = {k: jnp.asarray(v) for k, v in side.items()}
        textras = {k: torch.from_numpy(v) for k, v in side.items()}
    attn = tcfg.family not in ("ssm", "audio")

    jeng = jserving.step_engine(_Float32(jm), jserving.single_device_plan(jcfg), batch=B,
                                max_len=max_len)
    jl, jc = jeng.jit_prefill_step()(jp, jnp.asarray(prompts), jextras)
    jdecode = jeng.jit_decode_step()
    teng = serving.step_engine(build_model(tcfg, device="cpu"),
                               serving.single_device_plan(tcfg), batch=B, max_len=max_len,
                               dtype=torch.float32, device="cpu")
    tl, tc = teng.jit_prefill_step()(tp, torch.from_numpy(prompts).long(), textras)
    tdecode = teng.jit_decode_step(donate=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL32, rtol=TOL32)
    jt, tt = np.asarray(jnp.argmax(jl[:, -1], -1)), tl[:, -1].argmax(-1)
    for i in range(new - 1):
        np.testing.assert_array_equal(tt.numpy(), jt)
        pos = Sv + S + i
        jl, jc = jdecode(jp, jnp.asarray(jt[:, None], jnp.int32), jc, jnp.int32(pos),
                         jnp.full((B,), pos + 1, jnp.int32) if attn else None)
        tl, tc = tdecode(tp, tt[:, None], tc, pos,
                         torch.full((B,), pos + 1) if attn else None)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL32, rtol=TOL32,
                                   err_msg=f"step {i}")
        jt, tt = np.asarray(jnp.argmax(jl[:, -1], -1)), tl[:, -1].argmax(-1)
    np.testing.assert_array_equal(tt.numpy(), jt)
    assert len(tdecode.compiled.entries) == 1          # one graph for all 8 steps


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-7b"])
def test_jit_decode_step_donation(arch):
    """``donate=True`` writes the caller's cache in place, leaf by leaf (the
    hybrid's nested ``{"mamba", "attn"}`` too), and hands those leaves back;
    ``donate=False`` leaves every leaf as it was and returns clones; both
    give the same logits."""
    cfg, model, params = _cpu_model(arch)
    eng = serving.step_engine(model, serving.single_device_plan(cfg), max_len=12,
                              dtype=torch.float32, device="cpu")
    prompt = torch.from_numpy(_tokens(4, (B, 5), cfg.vocab_size)).long()
    _, cache = eng.jit_prefill_step()(params, prompt)
    tok = prompt[:, -1:]
    kept = _leaves(_clone(cache))
    lk, ck = eng.jit_decode_step(donate=False)(params, tok, cache, 5)
    leaves, cloned = _leaves(cache), _leaves(ck)
    assert len(leaves) == len(kept) == len(cloned) == (6 if cfg.family == "hybrid" else 2)
    assert all(torch.equal(t, k) for (_, t), (_, k) in zip(leaves, kept))
    assert all(c.data_ptr() != t.data_ptr() for (_, c), (_, t) in zip(cloned, leaves))
    ld, cd = eng.jit_decode_step(donate=True)(params, tok, cache, 5)
    donated = _leaves(cd)
    assert [p for p, _ in donated] == [p for p, _ in leaves]
    assert all(d.data_ptr() == t.data_ptr() for (_, d), (_, t) in zip(donated, leaves))
    assert torch.equal(ld, lk)
    assert all(torch.equal(d, c) for (_, d), (_, c) in zip(donated, cloned))
    assert not all(torch.equal(t, k) for (_, t), (_, k) in zip(leaves, kept))


def test_jit_prefill_step_feeds_frames_and_none():
    """whisper's ``jit_prefill_step`` with ``extras=None`` encodes zeros, as
    the eager step does, and with fed frames follows each call's frames (the
    static buffer refreshed); every call returns a fresh nested cache."""
    cfg, model, params = _cpu_model("whisper-tiny")
    eng = serving.step_engine(model, serving.single_device_plan(cfg), max_len=10,
                              dtype=torch.float32, device="cpu")
    prefill = eng.jit_prefill_step()
    prompt = torch.from_numpy(_tokens(5, (B, 4), cfg.vocab_size)).long()
    outs = []
    for extras in (None, *({"frames": torch.from_numpy(_side_inputs(cfg, seed)["frames"])}
                           for seed in (6, 7))):
        got, cache = prefill(params, prompt, extras)
        want, want_cache = eng.prefill_step(params, prompt, extras)
        assert torch.equal(got, want)
        pairs = list(zip(_leaves(cache), _leaves(want_cache)))
        assert [p for (p, _), _ in pairs] == [(kind, k) for kind in ("self", "cross")
                                              for k in ("k", "v")]
        assert all(torch.equal(g, w) for (_, g), (_, w) in pairs)
        outs.append((got, cache))
    assert len(prefill.compiled[10].entries) == 2          # None, then frames
    assert not torch.equal(outs[1][0], outs[2][0])
    assert outs[1][1]["cross"]["k"].data_ptr() != outs[2][1]["cross"]["k"].data_ptr()
