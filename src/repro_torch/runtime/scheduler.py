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
   written-out form of the JAX scheduler's ``vmap`` over slots).  Only the
   live slots run.

Both steps gather each slot's pages into a contiguous view, padded by the
step's token count (``+1`` at decode, ``+chunk`` at prefill) so the write of
the new tokens always fits, run the model, and scatter only the new tokens'
k/v back into the pool; chunk pad lanes write to the null page.

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
                 clock: Callable[[], float] = time.perf_counter):
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

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------ steps
    @torch.no_grad()
    def _decode_step(self, tokens: np.ndarray, block_tables: np.ndarray,
                     lens: np.ndarray) -> np.ndarray:
        """One batched decode step over the live slots: tokens (B,),
        block_tables (B, Pmax), lens (B,) -> logits (B, V) fp32 on the host.
        The new token's k/v are scattered into the pool at each slot's
        write position."""
        page = self.cache.config.page_size
        bt, ln = self._tensor(block_tables), self._tensor(lens).long()
        gk = _pad_seq(gather_pages(self.cache.k_pages, bt), 1)
        gv = _pad_seq(gather_pages(self.cache.v_pages, bt), 1)
        logits, nc = self.model.forward_decode(
            self.params, self._tensor(tokens).long()[:, None], {"k": gk, "v": gv}, ln,
            kv_len=ln + 1, dtype=self.dtype)
        rows = torch.arange(len(tokens), device=self.device)
        nk, nv = nc["k"][:, rows, ln], nc["v"][:, rows, ln]     # (L, B, KV, hd)
        flat = flat_positions(bt, ln[:, None], page)[:, 0]
        scatter_tokens(self.cache.k_pages, flat, nk)
        scatter_tokens(self.cache.v_pages, flat, nv)
        return logits[:, -1].cpu().numpy()

    @torch.no_grad()
    def _prefill_step(self, tokens: np.ndarray, block_table: np.ndarray,
                      done: int, n_valid: int) -> np.ndarray:
        """One prompt chunk for one slot: tokens (1, chunk) padded,
        block_table (1, Pmax), done = tokens already in the cache, n_valid =
        real tokens in this chunk.  Pad lanes write into the null page; the
        returned logits row (V,) is the last valid position's."""
        page = self.cache.config.page_size
        chunk = tokens.shape[1]
        bt = self._tensor(block_table)
        gk = _pad_seq(gather_pages(self.cache.k_pages, bt), chunk)
        gv = _pad_seq(gather_pages(self.cache.v_pages, bt), chunk)
        kv_len = torch.full((1,), done + n_valid, dtype=torch.long, device=self.device)
        logits, nc = self.model.forward_decode(
            self.params, self._tensor(tokens).long(), {"k": gk, "v": gv}, done,
            kv_len=kv_len, dtype=self.dtype)
        ck, cv = nc["k"][:, 0, done:done + chunk], nc["v"][:, 0, done:done + chunk]
        positions = done + torch.arange(chunk, device=self.device)
        flat = flat_positions(bt, positions[None], page)[0]
        flat = torch.where(torch.arange(chunk, device=self.device) < n_valid, flat,
                           positions % page)              # pads -> null page
        scatter_tokens(self.cache.k_pages, flat, ck)
        scatter_tokens(self.cache.v_pages, flat, cv)
        return logits[0, n_valid - 1].cpu().numpy()

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
        logits = self._prefill_step(toks, self.cache.block_tables[req.slot][None],
                                    done, n)
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
        slots = [r.slot for r in live]
        tokens = np.asarray([r.tokens[-1] for r in live], np.int32)
        logits = self._decode_step(tokens, self.cache.block_tables[slots],
                                   self.cache.kv_len[slots])
        for i, r in enumerate(live):
            self.cache.advance(r.slot, 1)
            self._append_token(r, logits[i])

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
