"""Paged KV cache: block-table indirection over fixed-size cache pages.

The port's counterpart of ``repro.runtime.kv_cache``.  A pool of fixed-size
pages is shared by every in-flight request::

    page pool      (L, num_pages, page_size, KV, hd)      device
    block table    (num_slots, max_pages_per_slot) int32  host
    kv_len         (num_slots,) int32                     host

Position ``p`` of a slot lives at page ``block_table[p // page_size]``,
offset ``p % page_size``.  Page 0 is the **null page**: empty block-table
entries point at it and discarded writes (chunk padding) land there; it is
never allocated to a request.

Host accounting (`alloc_slot` / `ensure_capacity` / `advance` / `free_slot`)
is plain Python, copied from the JAX package as is.  The device ops
(`gather_pages` / `flat_positions` / `scatter_tokens`) are torch ops.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

NULL_PAGE = 0


class CacheOOM(RuntimeError):
    """No free page / slot for the requested allocation."""


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Geometry of one paged pool (model dims + pool sizing)."""

    num_slots: int               # concurrent decode streams
    page_size: int               # tokens per page
    num_pages: int               # pool size, incl. the reserved null page
    max_context: int             # per-request capacity ceiling, tokens
    layers: int
    kv_heads: int
    head_dim: int

    @property
    def max_pages_per_slot(self) -> int:
        return math.ceil(self.max_context / self.page_size)

    @property
    def slot_capacity(self) -> int:
        """Gathered per-slot view width (tokens)."""
        return self.max_pages_per_slot * self.page_size

    @classmethod
    def for_model(cls, cfg, *, num_slots: int, page_size: int,
                  max_context: int,
                  num_pages: Optional[int] = None) -> "PagedCacheConfig":
        """Pool sized for ``cfg`` (a ModelConfig).  Default ``num_pages``
        fully provisions every slot plus the null page (no oversubscription)."""
        pages_per_slot = math.ceil(max_context / page_size)
        if num_pages is None:
            num_pages = 1 + num_slots * pages_per_slot
        return cls(num_slots=num_slots, page_size=page_size,
                   num_pages=num_pages, max_context=max_context,
                   layers=cfg.num_layers, kv_heads=cfg.num_kv_heads,
                   head_dim=cfg.resolved_head_dim)

    def pool_bytes(self, bytes_per_elem: float = 2.0) -> float:
        """Device bytes of the k+v pools (bf16 by default)."""
        return (2.0 * bytes_per_elem * self.layers * self.num_pages
                * self.page_size * self.kv_heads * self.head_dim)


class PagedKVCache:
    """Page pool + free-list + block-table accounting for one model."""

    def __init__(self, config: PagedCacheConfig, dtype=torch.bfloat16, device="cpu"):
        if config.page_size < 1 or config.num_pages < 2:
            raise ValueError("need page_size >= 1 and num_pages >= 2 "
                             "(page 0 is the reserved null page)")
        self.config = config
        shape = (config.layers, config.num_pages, config.page_size,
                 config.kv_heads, config.head_dim)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=device)
        # pop() hands out ascending page ids — deterministic for tests
        self._free_pages = list(range(config.num_pages - 1, NULL_PAGE, -1))
        self._free_slots = list(range(config.num_slots - 1, -1, -1))
        self._owned: dict[int, list[int]] = {}        # slot -> pages, in order
        self.block_tables = np.full(
            (config.num_slots, config.max_pages_per_slot), NULL_PAGE, np.int32)
        self.kv_len = np.zeros((config.num_slots,), np.int32)

    # ------------------------------------------------------------ queries
    @property
    def free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    def active_slots(self) -> list[int]:
        return sorted(self._owned)

    def capacity(self, slot: int) -> int:
        """Tokens the slot's allocated pages can hold."""
        return len(self._owned[slot]) * self.config.page_size

    # ------------------------------------------------------------ lifecycle
    def alloc_slot(self, n_tokens: int = 0) -> int:
        """Claim a slot and pages for ``n_tokens``; all-or-nothing."""
        if not self._free_slots:
            raise CacheOOM("no free decode slot")
        need = math.ceil(n_tokens / self.config.page_size)
        if need > self.config.max_pages_per_slot:
            raise CacheOOM(f"{n_tokens} tokens exceed the per-slot capacity "
                           f"of {self.config.slot_capacity}")
        if need > len(self._free_pages):
            raise CacheOOM(f"need {need} pages, {len(self._free_pages)} free")
        slot = self._free_slots.pop()
        self._owned[slot] = []
        self.kv_len[slot] = 0
        for _ in range(need):
            self._grow(slot)
        return slot

    def _grow(self, slot: int) -> None:
        if not self._free_pages:
            raise CacheOOM("page pool exhausted")
        page = self._free_pages.pop()
        owned = self._owned[slot]
        self.block_tables[slot, len(owned)] = page
        owned.append(page)

    def ensure_capacity(self, slot: int, n_tokens: int) -> None:
        """Grow the slot's block table until it can hold ``n_tokens``."""
        if n_tokens > self.config.slot_capacity:
            raise CacheOOM(f"{n_tokens} tokens exceed the per-slot capacity "
                           f"of {self.config.slot_capacity}")
        while self.capacity(slot) < n_tokens:
            self._grow(slot)

    def advance(self, slot: int, n: int) -> None:
        """Mark ``n`` more positions as written (after a device scatter)."""
        new_len = int(self.kv_len[slot]) + n
        if new_len > self.capacity(slot):
            raise CacheOOM(f"slot {slot}: kv_len {new_len} exceeds the "
                           f"{self.capacity(slot)}-token page allocation")
        self.kv_len[slot] = new_len

    def free_slot(self, slot: int) -> None:
        pages = self._owned.pop(slot)          # KeyError on double-free
        self._free_pages.extend(reversed(pages))
        self.block_tables[slot, :] = NULL_PAGE
        self.kv_len[slot] = 0
        self._free_slots.append(slot)

    # ------------------------------------------------------------ invariants
    def check_invariants(self) -> None:
        """Raise AssertionError on any leak / double-booking — the property
        tests call this after every admit/complete/evict step."""
        owned = [p for pages in self._owned.values() for p in pages]
        assert len(owned) == len(set(owned)), "page owned by two slots"
        assert NULL_PAGE not in owned, "null page was allocated"
        assert not set(owned) & set(self._free_pages), \
            "page simultaneously owned and free"
        total = len(owned) + len(self._free_pages) + 1      # + null page
        assert total == self.config.num_pages, \
            f"page leak: {total} accounted of {self.config.num_pages}"
        assert len(self._free_slots) + len(self._owned) == self.config.num_slots
        for slot, pages in self._owned.items():
            assert int(self.kv_len[slot]) <= len(pages) * self.config.page_size
            np.testing.assert_array_equal(
                self.block_tables[slot, :len(pages)], pages)
            assert (self.block_tables[slot, len(pages):] == NULL_PAGE).all()
        for slot in self._free_slots:
            assert (self.block_tables[slot] == NULL_PAGE).all()


# ---------------------------------------------------------------------------
# device-side ops
# ---------------------------------------------------------------------------

def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """(L, P, page, KV, hd) gathered through (B, Pmax) -> (L, B, C, KV, hd)
    with C = Pmax * page — each slot's pages as one contiguous view (a copy)."""
    L, _, page, KV, hd = pages.shape
    B, pmax = block_tables.shape
    return pages[:, block_tables].reshape(L, B, pmax * page, KV, hd)


def flat_positions(block_tables: torch.Tensor, positions: torch.Tensor,
                   page_size: int) -> torch.Tensor:
    """Logical positions (..., N) -> flat indices into the page-major
    (P * page_size) axis, routed through block tables (..., Pmax).
    Out-of-capacity positions clamp to the last block-table entry — callers
    mask them to the null page before scattering."""
    page_slot = torch.clamp(positions // page_size, max=block_tables.shape[-1] - 1)
    page_id = torch.gather(block_tables.long(), -1, page_slot.long())
    return page_id * page_size + positions % page_size


def scatter_tokens(pages: torch.Tensor, flat: torch.Tensor,
                   vals: torch.Tensor) -> torch.Tensor:
    """Write vals (L, N, KV, hd) at flat page-major indices (N,).  Unlike the
    JAX version this writes into ``pages`` **in place** (``index_copy_``)
    and returns it: the pool is never copied.  Duplicate indices (several
    pad lanes on the null page) leave an unspecified one of their values."""
    L, P, page, KV, hd = pages.shape
    pages.view(L, P * page, KV, hd).index_copy_(1, flat.long(), vals.to(pages.dtype))
    return pages
