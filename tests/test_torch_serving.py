"""The port's serving slice on the CPU against the JAX package, on the same
weights (JAX ``model.init`` -> numpy -> ``params_from_jax``) and the same
numpy inputs:

* the parameter tree, counts and init distributions;
* ``forward_prefill`` / ``forward_decode`` logits and caches in fp32 at 1e-4
  (reduced llama3.2-1b, qwen2.5-3b with qkv bias, qwen3-14b with qk-norm,
  nemotron-4-15b with the relu2 FFN),
  including a batched decode with a different ``cache_index`` per slot;
* the continuous-batching scheduler against JAX's, teacher-forced in bf16
  (every recorded logits row at 3e-2), and greedy in fp32 against a JAX
  greedy loop, token for token;
* copies of the JAX serving tests: page accounting, FIFO, eviction replay,
  and the GALV08x ``ServeConfig`` rejections.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._prop import given, settings, st
from tests._torch_params import perturbed

from repro import serving as jserving
from repro.configs.registry import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.common import count_params as jax_count_params
from repro_torch import serving
from repro_torch.configs.registry import get_config
from repro_torch.models import build_model
from repro_torch.models.common import count_params, params_from_jax, tree_paths
from repro_torch.runtime.kv_cache import CacheOOM, PagedCacheConfig, PagedKVCache
from repro_torch.runtime.scheduler import ContinuousBatchingScheduler

ARCHS = ["llama3.2-1b", "qwen2.5-3b", "qwen3-14b", "nemotron-4-15b"]
TOL32 = 1e-4
TOL_BF16 = 3e-2


def _pair(arch, seed=0):
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm, tm = jax_build_model(jcfg), build_model(tcfg, device="cpu")
    np_params = perturbed(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed))),
                           np.random.default_rng(seed))
    return dict(cfg=tcfg, jm=jm, tm=tm, np=np_params,
                jp=jax.tree.map(jnp.asarray, np_params),
                tp=params_from_jax(np_params, "cpu", torch.float32))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def _close(a, b, tol):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=tol, rtol=tol)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape, dtype=np.int32)


# ------------------------------------------------------------- parameters

def test_param_tree_matches_jax(pair):
    jdefs = dict(tree_paths(pair["jm"].param_defs()))
    tdefs = dict(tree_paths(pair["tm"].param_defs()))
    assert jdefs.keys() == tdefs.keys()
    for path, d in tdefs.items():
        assert d.shape == jdefs[path].shape and d.init == jdefs[path].init, path
    for path, t in tree_paths(pair["tp"]):
        assert tuple(t.shape) == jdefs[path].shape, path


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-14b"])
def test_full_width_param_count_matches_jax(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert count_params(build_model(tcfg, device="cpu").param_defs()) == \
        jax_count_params(jax_build_model(jcfg).param_defs())


@pytest.mark.parametrize("arch", ["llama3.2-1b", "llama3.2-1b-long", "qwen2.5-3b",
                                  "qwen3-14b", "nemotron-4-15b"])
def test_galv081_weight_count_is_jaxs(arch):
    """GALV081's weight count at full width is ``profile_model(cfg,
    ...).total_params()`` in both packages: the model's parameters less the
    final norm's d_model scale."""
    from repro.core.profiler_model import profile_model
    from repro_torch.core.profiler_model import profile_model as torch_profile_model

    tcfg = get_config(arch)
    n = torch_profile_model(tcfg, 4096).total_params()
    assert n == profile_model(jax_get_config(arch), 4096).total_params()
    assert n == count_params(build_model(tcfg, device="cpu").param_defs()) - tcfg.d_model


def test_init_distributions_match_jax():
    """Same per-path distribution as ``ParamDef.materialize``: zeros/ones
    exact, normal stds within 10% (different generators, same law)."""
    arch = "qwen2.5-3b"
    jm = jax_build_model(jax_get_config(arch).reduced())
    tm = build_model(get_config(arch).reduced(), device="cpu")
    jp = dict(tree_paths(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))))
    tp = dict(tree_paths(tm.init(torch.Generator().manual_seed(1))))
    for path, d in tree_paths(tm.param_defs()):
        a, b = tp[path].numpy(), jp[path]
        assert a.dtype == np.float32 and a.shape == b.shape
        if d.init in ("zeros", "ones"):
            np.testing.assert_array_equal(a, b)
        elif a.size >= 1000:
            assert abs(a.std() / b.std() - 1) < 0.1, path


# ------------------------------------------------------------- forward passes

def test_prefill_logits_and_cache_match_jax(pair):
    cfg = pair["cfg"]
    toks = _tokens(1, (2, 12), cfg.vocab_size)
    jl, jc = pair["jm"].forward_prefill(pair["jp"], jnp.asarray(toks), max_len=20,
                                        dtype=jnp.float32)
    tl, tc = pair["tm"].forward_prefill(pair["tp"], torch.from_numpy(toks).long(),
                                        max_len=20, dtype=torch.float32)
    assert tl.shape == jl.shape and tc["k"].shape == jc["k"].shape
    _close(tl, jl, TOL32)
    _close(tc["k"], jc["k"], TOL32)
    _close(tc["v"], jc["v"], TOL32)


def test_batched_decode_per_slot_cache_index_matches_jax(pair):
    """One decode step for three slots at three different write positions
    (the scheduler's vmap, written out) against JAX per-slot calls."""
    cfg = pair["cfg"]
    B, S, M = 3, 12, 20
    prompts = _tokens(2, (B, S), cfg.vocab_size)
    _, jc = pair["jm"].forward_prefill(pair["jp"], jnp.asarray(prompts), max_len=M,
                                       dtype=jnp.float32)
    cache_np = {k: np.asarray(v) for k, v in jc.items()}
    ci = np.asarray([12, 9, 11], np.int32)
    tok = _tokens(3, (B, 1), cfg.vocab_size)
    t_cache = {k: torch.tensor(v) for k, v in cache_np.items()}     # written in place
    tl, tc = pair["tm"].forward_decode(pair["tp"], torch.from_numpy(tok).long(), t_cache,
                                       torch.from_numpy(ci), kv_len=torch.from_numpy(ci + 1),
                                       dtype=torch.float32)
    for b in range(B):
        jl, jcb = pair["jm"].forward_decode(
            pair["jp"], jnp.asarray(tok[b:b + 1]),
            {k: jnp.asarray(v[:, b:b + 1]) for k, v in cache_np.items()}, int(ci[b]),
            kv_len=jnp.asarray(ci[b:b + 1] + 1), dtype=jnp.float32)
        _close(tl[b:b + 1], jl, TOL32)
        _close(tc["k"][:, b:b + 1], jcb["k"], TOL32)
        _close(tc["v"][:, b:b + 1], jcb["v"], TOL32)


def test_chunk_decode_matches_jax(pair):
    """A multi-token decode step (a prefill chunk) at a scalar cache_index
    with per-slot valid lengths, as the scheduler's prefill runs it."""
    cfg = pair["cfg"]
    B, S, M, C = 2, 10, 24, 4
    prompts = _tokens(4, (B, S), cfg.vocab_size)
    _, jc = pair["jm"].forward_prefill(pair["jp"], jnp.asarray(prompts), max_len=M,
                                       dtype=jnp.float32)
    cache_np = {k: np.asarray(v) for k, v in jc.items()}
    chunk = _tokens(5, (B, C), cfg.vocab_size)
    kv_len = np.asarray([S + C, S + 2], np.int32)
    jl, _ = pair["jm"].forward_decode(pair["jp"], jnp.asarray(chunk),
                                      {k: jnp.asarray(v) for k, v in cache_np.items()}, S,
                                      kv_len=jnp.asarray(kv_len), dtype=jnp.float32)
    tl, _ = pair["tm"].forward_decode(pair["tp"], torch.from_numpy(chunk).long(),
                                      {k: torch.tensor(v) for k, v in cache_np.items()}, S,
                                      kv_len=torch.from_numpy(kv_len), dtype=torch.float32)
    _close(tl, jl, TOL32)


def test_kernel_and_ref_impl_agree_on_cpu():
    """On CPU tensors impl="kernel" takes the kernels' plain versions;
    the result equals the impl="ref" model's."""
    p = _pair("qwen3-14b", seed=3)
    toks = torch.from_numpy(_tokens(6, (2, 9), p["cfg"].vocab_size)).long()
    ref = build_model(p["cfg"], impl="ref", device="cpu")
    a, _ = p["tm"].forward_prefill(p["tp"], toks, dtype=torch.float32)
    b, _ = ref.forward_prefill(p["tp"], toks, dtype=torch.float32)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------- scheduler vs JAX

SCHED_ARCH = "llama3.2-1b"
S_PAGE, S_CTX, S_SLOTS, S_CHUNK, S_PROMPT = 4, 32, 2, 4, 10
MAX_NEW = [2, 6, 3, 5, 4]


def _sched_configs():
    jcfg = jserving.ServeConfig(
        arch=SCHED_ARCH, reduced=True,
        cache=jserving.CacheConfig(max_context=S_CTX, page_size=S_PAGE),
        scheduler=jserving.SchedulerConfig(num_slots=S_SLOTS, prefill_chunk=S_CHUNK))
    tcfg = serving.ServeConfig(
        arch=SCHED_ARCH, reduced=True, device="cpu",
        cache=serving.CacheConfig(max_context=S_CTX, page_size=S_PAGE),
        scheduler=serving.SchedulerConfig(num_slots=S_SLOTS, prefill_chunk=S_CHUNK))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def sched_params():
    jm = jax_build_model(jax_get_config(SCHED_ARCH).reduced())
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(4)))


def _drain(session, request_cls, prompts, max_new):
    streams = [session.submit(request_cls(prompt=p, max_new=n))
               for p, n in zip(prompts, max_new)]
    session.run_until_drained()
    return [s.request for s in streams]


def test_scheduler_teacher_forced_bf16_matches_jax_scheduler(sched_params):
    """Both schedulers on the same bf16 weights follow one forced token
    stream (keyed by (rid, step)); every logits row they hand the sampler
    agrees at the bf16 tolerance.  Chunked prefill (chunk < prompt), five
    requests of mixed length over two slots."""
    vocab = get_config(SCHED_ARCH).reduced().vocab_size
    rng = np.random.default_rng(9)
    forced = {(rid, s): int(rng.integers(0, vocab))
              for rid in range(len(MAX_NEW)) for s in range(max(MAX_NEW))}
    prompts = _tokens(10, (len(MAX_NEW), S_PROMPT), vocab)
    records = {}
    jcfg, tcfg = _sched_configs()

    def forcing(name):
        rec = records.setdefault(name, {})

        def sample(logits, request, rng):
            step = len(request.tokens)
            rec[(request.rid, step)] = np.asarray(logits, np.float32).copy()
            return forced[(request.rid, step)]
        return sample

    jsess = jserving.build(jcfg, params=jax.tree.map(jnp.asarray, sched_params),
                           sample_fn=forcing("jax"))
    tsess = serving.build(tcfg, params=params_from_jax(sched_params, "cpu"),
                          sample_fn=forcing("torch"))
    jreqs = _drain(jsess, jserving.Request, prompts, MAX_NEW)
    treqs = _drain(tsess, serving.Request, prompts, MAX_NEW)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert records["torch"].keys() == records["jax"].keys()
    assert len(records["torch"]) == sum(MAX_NEW)
    for key, row in records["torch"].items():
        np.testing.assert_allclose(row, records["jax"][key], atol=TOL_BF16, rtol=TOL_BF16,
                                   err_msg=str(key))


def test_scheduler_fp32_greedy_matches_jax_greedy_loop(sched_params):
    """The port's scheduler in fp32 (chunked prefill, slots shared by three
    requests) emits, token for token, what a plain JAX fp32 greedy loop
    over forward_prefill / forward_decode emits for each request alone."""
    jm = jax_build_model(jax_get_config(SCHED_ARCH).reduced())
    jp = jax.tree.map(jnp.asarray, sched_params)
    decode = jax.jit(lambda p, t, c, ci, kl: jm.forward_decode(
        p, t, c, ci, kv_len=kl, dtype=jnp.float32))
    vocab = get_config(SCHED_ARCH).reduced().vocab_size
    lengths, max_new = [6, 9, 13], [5, 4, 6]
    prompts = [_tokens(20 + i, (n,), vocab) for i, n in enumerate(lengths)]

    def jax_greedy(prompt, n_new):
        S = len(prompt)
        logits, cache = jm.forward_prefill(jp, jnp.asarray(prompt[None]), max_len=S_CTX,
                                           dtype=jnp.float32)
        out = [int(jnp.argmax(logits[0, -1]))]
        for i in range(n_new - 1):
            logits, cache = decode(jp, jnp.asarray([[out[-1]]], jnp.int32), cache,
                                   jnp.int32(S + i), jnp.asarray([S + i + 1], jnp.int32))
            out.append(int(jnp.argmax(logits[0, -1])))
        return out

    _, tcfg = _sched_configs()
    tsess = serving.build(tcfg, params=params_from_jax(sched_params, "cpu"),
                          dtype=torch.float32)
    treqs = _drain(tsess, serving.Request, prompts, max_new)
    for i, r in enumerate(treqs):
        assert r.tokens == jax_greedy(prompts[i], max_new[i]), f"request {i}"


# ------------------------------------------ ports of tests/test_serving.py

ARCH = "qwen2.5-3b"
PROMPT_LEN = 4
PAGE = 4
MAX_CONTEXT = 16
SLOTS = 2


@pytest.fixture(scope="module")
def session():
    config = serving.ServeConfig(
        arch=ARCH, reduced=True, device="cpu",
        cache=serving.CacheConfig(max_context=MAX_CONTEXT, page_size=PAGE),
        scheduler=serving.SchedulerConfig(num_slots=SLOTS, prefill_chunk=PROMPT_LEN))
    return serving.build(config)


def _prompts(n, session, seed=0):
    vocab = session.config.model_config().vocab_size
    return _tokens(seed, (n, PROMPT_LEN), vocab)


def _tiny_cache_cfg(num_pages=None):
    return PagedCacheConfig(num_slots=4, page_size=4, num_pages=num_pages or 9,
                            max_context=16, layers=1, kv_heads=1, head_dim=4)


@given(seed=st.integers(min_value=0, max_value=2**31 - 1))
@settings(max_examples=8, deadline=None)
def test_page_accounting_random_schedule(seed):
    """Random admit/grow/advance/free schedules never leak or double-book a
    page, and freeing everything returns the whole pool."""
    rng = np.random.default_rng(seed)
    cache = PagedKVCache(_tiny_cache_cfg())
    active: dict[int, int] = {}
    for _ in range(60):
        op = rng.choice(("alloc", "grow", "free"))
        try:
            if op == "alloc":
                n = int(rng.integers(0, cache.config.slot_capacity + 1))
                slot = cache.alloc_slot(n)
                cache.advance(slot, min(n, cache.capacity(slot)))
                active[slot] = min(n, cache.capacity(slot))
            elif op == "grow" and active:
                slot = int(rng.choice(list(active)))
                want = int(rng.integers(active[slot], cache.config.slot_capacity + 1))
                cache.ensure_capacity(slot, want)
                cache.advance(slot, want - active[slot])
                active[slot] = want
            elif op == "free" and active:
                slot = int(rng.choice(list(active)))
                cache.free_slot(slot)
                del active[slot]
        except CacheOOM:
            pass
        cache.check_invariants()
    for slot in list(active):
        cache.free_slot(slot)
    cache.check_invariants()
    assert cache.free_pages == cache.config.num_pages - 1
    assert cache.free_slots == cache.config.num_slots


def test_double_free_raises():
    cache = PagedKVCache(_tiny_cache_cfg())
    slot = cache.alloc_slot(4)
    cache.free_slot(slot)
    with pytest.raises(KeyError):
        cache.free_slot(slot)
    cache.check_invariants()


def test_device_ops_match_jax_kv_cache_ops():
    """gather_pages / flat_positions (with its clamp) / scatter_tokens
    against the JAX package's on one random pool."""
    from repro.runtime import kv_cache as jkv
    from repro_torch.runtime import kv_cache as tkv

    rng = np.random.default_rng(30)
    pages = rng.standard_normal((2, 7, 4, 1, 3)).astype(np.float32)
    tables = np.asarray([[3, 1, 0], [5, 6, 2]], np.int32)
    pos = np.asarray([[0, 5, 11, 13], [3, 4, 8, 30]], np.int32)     # 13, 30 clamp
    np.testing.assert_array_equal(
        tkv.gather_pages(torch.from_numpy(pages), torch.from_numpy(tables)).numpy(),
        np.asarray(jkv.gather_pages(jnp.asarray(pages), jnp.asarray(tables))))
    tflat = tkv.flat_positions(torch.from_numpy(tables), torch.from_numpy(pos), 4)
    jflat = jkv.flat_positions(jnp.asarray(tables), jnp.asarray(pos), 4)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    flat = np.asarray([5, 9, 26], np.int32)
    vals = rng.standard_normal((2, 3, 1, 3)).astype(np.float32)
    out = tkv.scatter_tokens(torch.tensor(pages), torch.from_numpy(flat), torch.from_numpy(vals))
    ref = jkv.scatter_tokens(jnp.asarray(pages), jnp.asarray(flat), jnp.asarray(vals))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_no_starvation_fifo_admission(session):
    n = 6
    prompts = _prompts(n, session, seed=5)
    reqs = [serving.Request(prompt=prompts[i], max_new=3) for i in range(n)]
    for r in reqs:
        session.submit(r)
    session.run_until_drained()
    assert all(r.done for r in reqs)
    assert [len(r.tokens) for r in reqs] == [3] * n
    firsts = [r.t_first for r in reqs]
    assert firsts == sorted(firsts), "a later submission got service first"


def test_scheduler_pages_never_leak_across_ticks(session):
    cache_cfg = PagedCacheConfig.for_model(
        session.config.model_config(), num_slots=SLOTS, page_size=PAGE,
        max_context=MAX_CONTEXT, num_pages=5)      # 4 real pages, 8 wanted
    sched = ContinuousBatchingScheduler(session.model, session.params, cache_cfg,
                                        prefill_chunk=PROMPT_LEN)
    prompts = _prompts(4, session, seed=8)
    reqs = [serving.Request(prompt=prompts[i], max_new=10) for i in range(4)]
    for r in reqs:
        sched.submit(r)
    for _ in range(10_000):
        sched.tick()
        sched.cache.check_invariants()
        if all(r.done for r in reqs):
            break
    assert all(r.done for r in reqs)
    assert sched.stats()["evicted"] > 0, "geometry was meant to force eviction"
    assert sched.cache.free_pages == cache_cfg.num_pages - 1
    assert sched.cache.free_slots == cache_cfg.num_slots


def test_eviction_replay_is_deterministic(session):
    prompts = _prompts(3, session, seed=11)
    max_new = [10, 9, 8]

    def run(num_pages):
        cache_cfg = PagedCacheConfig.for_model(
            session.config.model_config(), num_slots=SLOTS, page_size=PAGE,
            max_context=MAX_CONTEXT, num_pages=num_pages)
        sched = ContinuousBatchingScheduler(session.model, session.params, cache_cfg,
                                            prefill_chunk=PROMPT_LEN)
        reqs = [serving.Request(prompt=prompts[i], max_new=max_new[i]) for i in range(3)]
        for r in reqs:
            sched.submit(r)
        sched.run_until_drained()
        return [list(r.tokens) for r in reqs], sched.stats()["evicted"]

    tight_a, evicted_a = run(5)
    tight_b, evicted_b = run(5)
    roomy, evicted_roomy = run(None)
    assert evicted_a > 0 and evicted_a == evicted_b
    assert evicted_roomy == 0
    assert tight_a == tight_b == roomy


def test_token_stream_drives_ticks(session):
    prompts = _prompts(2, session, seed=12)
    streams = [session.submit(serving.Request(prompt=p, max_new=4)) for p in prompts]
    assert [list(s) for s in streams] == [s.request.tokens for s in streams]
    assert all(len(s.request.tokens) == 4 for s in streams)


def test_serve_config_rejects_indivisible_page():
    with pytest.raises(ValueError, match="GALV080"):
        serving.ServeConfig(arch=ARCH, reduced=True, device="cpu",
                            cache=serving.CacheConfig(max_context=18, page_size=PAGE))


def test_serve_config_rejects_starved_page_pool():
    with pytest.raises(ValueError, match="GALV082"):
        serving.ServeConfig(
            arch=ARCH, reduced=True, device="cpu",
            cache=serving.CacheConfig(max_context=MAX_CONTEXT, page_size=PAGE, num_pages=3),
            scheduler=serving.SchedulerConfig(num_slots=4))


def test_serve_config_rejects_hbm_overcommit():
    """GALV081 against the default one-H100 cluster: full-width qwen3-14b
    weights (~29 GB bf16) plus a 256-slot, 8k-context pool exceed 80 GB."""
    with pytest.raises(ValueError, match="GALV081"):
        serving.ServeConfig(
            arch="qwen3-14b", reduced=False,
            cache=serving.CacheConfig(max_context=8192, page_size=16),
            scheduler=serving.SchedulerConfig(num_slots=256))


def test_serve_config_is_frozen_and_buildable(session):
    cfg = session.config
    with pytest.raises(Exception):
        cfg.arch = "other"
    assert cfg.serve_spec().page_size == PAGE
    assert cfg.check().ok()
    assert cfg.resolved_cluster().name == "h100-1"
