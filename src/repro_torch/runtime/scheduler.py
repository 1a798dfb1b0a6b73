"""In-flight (continuous) batching scheduler over the paged KV cache.

The port's counterpart of ``repro.runtime.scheduler``, with the same
policy, one ``tick()`` at a time:

1. **admit** — strict FIFO: while the head of the queue fits (a free slot
   and enough free pages for its prompt), move it into a slot; a large
   request at the head blocks later ones rather than being starved by them.
2. **prefill** — at most one chunk (``prefill_chunk`` tokens) of the oldest
   prefilling request.  A chunk is one multi-token ``forward_decode`` at
   ``cache_index = tokens already prefilled``.
3. **decode** — every slot in the decode phase takes one step in one
   batched ``forward_decode`` with a per-slot ``(B,)`` ``cache_index`` (the
   written-out form of the JAX scheduler's ``vmap`` over slots).  As in JAX
   the step always runs all ``num_slots`` lanes: an idle lane carries an
   all-null block table, so its write lands in the null page, and the host
   ignores its logits.

Both steps gather each slot's pages into a contiguous view, padded by the
step's token count (``+1`` at decode, ``+chunk`` at prefill) so the write of
the new tokens always fits, run the model, and scatter only the new tokens'
k/v back into the pool; chunk pad lanes write to the null page.  Both keep
static shapes — decode ``(num_slots,)`` lanes, prefill one ``(1,
prefill_chunk)`` chunk whose ``done`` and ``n_valid`` are 0-d tensors — and
read nothing on the host, so each is compiled as JAX compiles its steps:
``compiled=True`` (the default) builds ``_decode_fn`` and ``_prefill_fn``
through ``runtime/compiled.py``, captured CUDA graphs replayed every tick on
a CUDA device (sharing one graph pool), the same static-buffer plumbing
with direct calls on the CPU.  ``compiled=False`` calls the steps eagerly:
the oracle of the graphs.  The logits are copied to the host after the
step, and sampling stays on the host.

Eviction (oversubscribed pools only) preempts the youngest later-submitted
request; generation restarts on re-admission and replays the same tokens
(greedy, or the per-request RNG, which is re-seeded).

Sampling is a per-request hook: ``temperature <= 0`` is greedy argmax;
``temperature > 0`` draws from the softmax with a per-request RNG.  A
scheduler-level ``sample_fn(logits, request, rng)`` overrides both.
Telemetry sinks wait for the port of ``repro.obs``; requests keep their
timestamps (``ttft_s`` / ``tpot_s``).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.runtime.compiled import compile_step
from repro_torch.runtime.kv_cache import (
    CacheOOM,
    PagedCacheConfig,
    PagedKVCache,
    flat_positions,
    gather_pages,
    scatter_tokens,
)

QUEUED, PREFILLING, DECODING, FINISHED = ("queued", "prefilling",
                                          "decoding", "finished")


@dataclasses.dataclass(eq=False)          # identity eq: prompts are arrays
class Request:
    """One generation request.  ``tokens`` fills in as the scheduler runs;
    timing fields are stamped by the scheduler's clock."""

    prompt: np.ndarray                 # (S,) int32 token ids
    max_new: int
    rid: int = -1                      # assigned at submit when < 0
    temperature: float = 0.0           # <= 0: greedy
    seed: int = 0
    tokens: list = dataclasses.field(default_factory=list)
    state: str = QUEUED
    slot: int = -1
    prefilled: int = 0                 # prompt tokens already in the cache
    t_submit: float = 0.0
    t_first: float = 0.0
    t_end: float = 0.0

    @property
    def done(self) -> bool:
        return self.state == FINISHED

    @property
    def ttft_s(self) -> float:
        return self.t_first - self.t_submit

    @property
    def tpot_s(self) -> float:
        """Mean time per output token after the first."""
        return (self.t_end - self.t_first) / max(len(self.tokens) - 1, 1)


class TokenStream:
    """Iterator handed back by ``submit``: yields tokens as they are
    generated, driving ``scheduler.tick()`` while the request is live."""

    def __init__(self, scheduler: "ContinuousBatchingScheduler",
                 request: Request):
        self.request = request
        self._scheduler = scheduler
        self._emitted = 0

    def __iter__(self) -> Iterator[int]:
        while True:
            stalled = 0
            while (self._emitted >= len(self.request.tokens)
                   and not self.request.done):
                before = len(self.request.tokens) + self.request.prefilled
                self._scheduler.tick()
                stalled = (0 if len(self.request.tokens)
                           + self.request.prefilled != before else stalled + 1)
                if stalled > 100_000:
                    raise RuntimeError(
                        f"request {self.request.rid} made no progress")
            if self._emitted >= len(self.request.tokens):
                return
            tok = self.request.tokens[self._emitted]
            self._emitted += 1
            yield tok


def _default_sample(logits: np.ndarray, request: Request,
                    rng: np.random.Generator) -> int:
    """Greedy at temperature <= 0; otherwise softmax sampling."""
    if request.temperature <= 0.0:
        return int(np.argmax(logits))
    x = logits.astype(np.float64) / request.temperature
    x -= x.max()
    p = np.exp(x)
    return int(rng.choice(len(p), p=p / p.sum()))


def _pad_seq(x: torch.Tensor, n: int) -> torch.Tensor:
    """Pad the sequence dim of a gathered (L, B, C, KV, hd) view by n."""
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n))


class ContinuousBatchingScheduler:
    """Continuous batching over ``model`` with paged KV storage.

    ``params`` are already in ``dtype`` (the serving dtype, bf16 by
    default), which is also the page pool's dtype and the dtype the model's
    forward passes compute in.  Use ``repro_torch.serving.build`` rather
    than constructing this directly.
    """

    def __init__(self, model: Any, params: Any, cache_cfg: PagedCacheConfig,
                 *, prefill_chunk: int = 32, dtype=torch.bfloat16,
                 sample_fn: Optional[Callable] = None,
                 clock: Callable[[], float] = time.perf_counter, compiled: bool = True):
        self.model = model
        self.params = params
        self.dtype = dtype
        self.device = model.device
        self.cache = PagedKVCache(cache_cfg, dtype, self.device)
        self.prefill_chunk = int(prefill_chunk)
        self._clock = clock
        self._sample = sample_fn or _default_sample
        self._queue: collections.deque[Request] = collections.deque()
        self._slots: list[Optional[Request]] = [None] * cache_cfg.num_slots
        self._admit_order: collections.deque[Request] = collections.deque()
        self._next_rid = 0
        self._finished = 0
        self._generated = 0
        self._evicted = 0
        self._rngs: dict[int, np.random.Generator] = {}
        self.compiled = compiled
        if compiled:
            pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
            kw = dict(held=(0,), donated=(1, 2), pool=pool)
            self._decode_fn = compile_step(self._decode_step, self.device, name="decode step",
                                           **kw)
            self._prefill_fn = compile_step(self._prefill_step, self.device,
                                            name="prefill step", **kw)
        else:
            self._decode_fn, self._prefill_fn = self._decode_step, self._prefill_step

    def _inputs(self, *arrays) -> list[torch.Tensor]:
        """A step's host inputs as tensors: left on the host for the compiled
        steps (which copy them into their static buffers), on the device for
        the eager ones."""
        out = [torch.as_tensor(a) for a in arrays]
        return out if self.compiled else [t.to(self.device) for t in out]

    # ------------------------------------------------------------ steps
    @torch.no_grad()
    def _decode_step(self, params, k_pages, v_pages, tokens, block_tables, lens):
        """One batched decode step over every slot: tokens (B,), block_tables
        (B, Pmax), lens (B,) -> logits (B, V) fp32 on the device.  The new
        token's k/v are scattered into the pools in place at each slot's
        write position; an idle lane (all-null table, length 0) writes into
        the null page."""
        page = self.cache.config.page_size
        ln = lens.long()
        gk = _pad_seq(gather_pages(k_pages, block_tables), 1)
        gv = _pad_seq(gather_pages(v_pages, block_tables), 1)
        logits, nc = self.model.forward_decode(
            params, tokens.long()[:, None], {"k": gk, "v": gv}, ln, kv_len=ln + 1,
            dtype=self.dtype)
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        nk, nv = nc["k"][:, rows, ln], nc["v"][:, rows, ln]     # (L, B, KV, hd)
        flat = flat_positions(block_tables, ln[:, None], page)[:, 0]
        scatter_tokens(k_pages, flat, nk)
        scatter_tokens(v_pages, flat, nv)
        return logits[:, -1]

    @torch.no_grad()
    def _prefill_step(self, params, k_pages, v_pages, tokens, block_table, done, n_valid):
        """One prompt chunk for one slot: tokens (1, chunk) padded,
        block_table (1, Pmax), done = tokens already in the cache and
        n_valid = real tokens in this chunk, both 0-d tensors.  Pad lanes
        write into the null page; the returned logits row (V,) is the last
        valid position's."""
        page = self.cache.config.page_size
        chunk = tokens.shape[1]
        done, n_valid = done.long(), n_valid.long()
        gk = _pad_seq(gather_pages(k_pages, block_table), chunk)
        gv = _pad_seq(gather_pages(v_pages, block_table), chunk)
        logits, nc = self.model.forward_decode(
            params, tokens.long(), {"k": gk, "v": gv}, done,
            kv_len=(done + n_valid).reshape(1), dtype=self.dtype)
        lanes = torch.arange(chunk, device=tokens.device)
        positions = done + lanes
        ck = nc["k"][:, 0].index_select(1, positions)
        cv = nc["v"][:, 0].index_select(1, positions)
        flat = flat_positions(block_table, positions[None], page)[0]
        flat = torch.where(lanes < n_valid, flat, positions % page)   # pads -> null page
        scatter_tokens(k_pages, flat, ck)
        scatter_tokens(v_pages, flat, cv)
        return logits[0].index_select(0, (n_valid - 1).reshape(1))[0]

    # ------------------------------------------------------------ API
    def submit(self, request: Request) -> TokenStream:
        needed = len(request.prompt) + request.max_new - 1
        if needed > self.cache.config.slot_capacity:
            raise CacheOOM(
                f"request needs {needed} cache positions; per-slot capacity "
                f"is {self.cache.config.slot_capacity} "
                f"(max_context={self.cache.config.max_context})")
        if request.max_new < 1 or len(request.prompt) < 1:
            raise ValueError("need a non-empty prompt and max_new >= 1")
        if request.rid < 0:
            request.rid = self._next_rid
        self._next_rid = max(self._next_rid, request.rid) + 1
        request.prompt = np.asarray(request.prompt, np.int32)
        request.t_submit = self._clock()
        request.state = QUEUED
        self._queue.append(request)
        return TokenStream(self, request)

    def tick(self) -> dict:
        """Advance every in-flight request by one scheduling quantum."""
        self._admit()
        self._prefill_tick()
        self._decode_tick()
        return self.stats()

    def run_until_drained(self, max_ticks: int = 100_000) -> None:
        for _ in range(max_ticks):
            if not self._queue and not any(self._slots):
                return
            before = (len(self._queue), self._finished, self._generated,
                      sum(r.prefilled for r in self._slots if r))
            self.tick()
            after = (len(self._queue), self._finished, self._generated,
                     sum(r.prefilled for r in self._slots if r))
            if before == after:
                raise CacheOOM(
                    "scheduler made no progress — the queued request cannot "
                    "ever fit (pool too small for its prompt)")
        raise RuntimeError(f"not drained after {max_ticks} ticks")

    def stats(self) -> dict:
        active = [r for r in self._slots if r is not None]
        return {
            "queued": len(self._queue),
            "prefilling": sum(r.state == PREFILLING for r in active),
            "decoding": sum(r.state == DECODING for r in active),
            "free_slots": self.cache.free_slots,
            "free_pages": self.cache.free_pages,
            "finished": self._finished,
            "generated_tokens": self._generated,
            "evicted": self._evicted,
        }

    # ------------------------------------------------------------ phases
    def _admit(self) -> None:
        while self._queue and self.cache.free_slots:
            req = self._queue[0]
            try:
                slot = self.cache.alloc_slot(len(req.prompt))
            except CacheOOM:
                return                  # strict FIFO: head waits, no skipping
            self._queue.popleft()
            req.slot = slot
            req.state = PREFILLING
            req.prefilled = 0
            self._slots[slot] = req
            self._admit_order.append(req)

    def _evict(self, req: Request) -> None:
        """Preempt ``req``: release its slot/pages and put it back at the
        head of the queue; it restarts from scratch on re-admission."""
        self.cache.free_slot(req.slot)
        self._slots[req.slot] = None
        self._admit_order.remove(req)
        self._rngs.pop(req.rid, None)
        req.slot = -1
        req.prefilled = 0
        req.tokens = []
        req.state = QUEUED
        self._queue.appendleft(req)
        self._evicted += 1

    def _ensure_with_eviction(self, req: Request, n_tokens: int) -> bool:
        """Grow ``req``'s allocation, preempting the youngest
        *later-submitted* request while the pool is short.  Only strictly
        younger requests are preempted; when every page-holder is older,
        ``req`` yields its own slot and retries after they finish, so the
        eldest request always completes.  Returns False when ``req``
        yielded (callers must not touch its slot this tick)."""
        while True:
            try:
                self.cache.ensure_capacity(req.slot, n_tokens)
                return True
            except CacheOOM:
                victim = next((r for r in reversed(self._admit_order)
                               if r is not req and r.rid > req.rid), None)
                if victim is not None:
                    self._evict(victim)
                    continue
                if any(r is not req for r in self._admit_order):
                    self._evict(req)        # yield to the elders, retry later
                    return False
                raise                       # alone and still short: pool is
                                            # too small for this request

    def _prefill_tick(self) -> None:
        req = next((r for r in self._admit_order if r.state == PREFILLING),
                   None)
        if req is None:
            return
        chunk = self.prefill_chunk
        done = req.prefilled
        n = min(chunk, len(req.prompt) - done)
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :n] = req.prompt[done:done + n]
        if not self._ensure_with_eviction(req, done + n):
            return                          # yielded its slot to an elder
        logits = self._prefill_fn(
            self.params, self.cache.k_pages, self.cache.v_pages,
            *self._inputs(toks, self.cache.block_tables[req.slot][None], np.int64(done),
                          np.int64(n))).cpu().numpy()
        self.cache.advance(req.slot, n)
        req.prefilled = done + n
        if req.prefilled == len(req.prompt):
            self._append_token(req, logits, first=True)

    def _decode_tick(self) -> None:
        live = [r for r in self._admit_order if r.state == DECODING]
        # oldest first: an eviction preempts the youngest, never a request
        # that already reserved its next page this tick
        for r in list(live):
            if r.state != DECODING:
                continue                  # evicted by an earlier iteration
            self._ensure_with_eviction(
                r, int(self.cache.kv_len[r.slot]) + 1)
        live = [r for r in live if r.state == DECODING]
        if not live:
            return
        B = len(self._slots)
        tokens = np.zeros((B,), np.int32)
        tables = np.zeros((B, self.cache.config.max_pages_per_slot), np.int32)  # idle: null page
        lens = np.zeros((B,), np.int32)
        for r in live:
            tokens[r.slot] = r.tokens[-1]
            tables[r.slot] = self.cache.block_tables[r.slot]
            lens[r.slot] = self.cache.kv_len[r.slot]
        logits = self._decode_fn(self.params, self.cache.k_pages, self.cache.v_pages,
                                 *self._inputs(tokens, tables, lens)).cpu().numpy()
        for r in live:
            self.cache.advance(r.slot, 1)
            self._append_token(r, logits[r.slot])

    # ------------------------------------------------------------ helpers
    def _append_token(self, req: Request, logits: np.ndarray,
                      first: bool = False) -> None:
        rng = self._rngs.setdefault(
            req.rid, np.random.default_rng(req.seed + req.rid))
        req.tokens.append(self._sample(logits, req, rng))
        self._generated += 1
        if first:
            req.state = DECODING
            req.t_first = self._clock()
        if len(req.tokens) >= req.max_new:
            self._finish(req)

    def _finish(self, req: Request) -> None:
        req.state = FINISHED
        req.t_end = self._clock()
        self.cache.free_slot(req.slot)
        self._slots[req.slot] = None
        self._admit_order.remove(req)
        self._rngs.pop(req.rid, None)
        self._finished += 1
