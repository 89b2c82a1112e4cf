"""Paged KV cache for the serving engine.

Counterpart of ``paddle_tpu/inference/llm/kv_cache.py`` (single
device). Sequences of different lengths share ONE preallocated pool of
fixed-size pages ``[L, P, page, H, D]`` on the device, addressed
through a per-slot page table. The host side is pure Python ints: a
free list, reserve-ahead ``allocate`` (every page a sequence can touch
is reserved at admission, so a running sequence never runs out of
pages), and a refcounted prefix cache over FULL prompt pages, keyed by
the same rolling SHA-256 block digests as the JAX cache (salted alike
by the quant config), so both caches agree on what a prefix hit is.

Quantized pages (``CacheConfig.kv_quant`` int8 or fp8): the pools hold
1-byte codes, and float32 scale pools ``k_scale``/``v_scale`` ``[L, P,
page, H]`` hold one scale per page position per head beside them.

Page 0 is the reserved *garbage page*: page-table entries of unmapped
positions point at it, and padding tokens scatter their K/V into it,
which keeps every scatter and gather shape static.

The page table is TWO-LEVEL, as in the JAX cache: a per-slot directory
of index-row ids (``slot_dir [max_slots, dir_entries]``) into a shared
pool of page-index rows (``index_pool [dir_capacity, dir_fanout]``, row
0 reserved all-garbage). The engine uploads those two small arrays when
``page_table_version`` moves and rebuilds the flat ``[max_slots,
pages_per_seq]`` view on the device (:func:`flatten_page_levels`);
``page_table`` is the same flat view on the host. Heavy prefix sharing
can exhaust the index rows before the pages: ``allocate`` then refuses,
exactly as the JAX cache does.

The host swap tier (``swap_pages > 0``): preemption copies a slot's
full resident pages into a host store keyed by the prefix cache's
rolling digests (``swap_out``), and a resumed request's fresh pages are
written back from it (``swap_in``), byte for byte: an int8 or fp8 page
travels as its codes and its scale rows. Cold-prefix demotion
(``demote_cold_prefix``): evicting a parked prefix page spills its
bytes into the same store first, so a later hit on that content swaps
it back in at admission instead of re-prefilling;
``demote_prefix_pages`` demotes parked pages on demand.

Device work the host orders: the engine may have steps in flight on the
cache's stream. Host writes to the pools (``swap_in``, the scale-row
zeroing of freed pages) are enqueued on the same stream from pinned
host memory without waiting for it, so they land after every step
already queued; host reads (``swap_out``, ``_spill_page``) copy on that
stream and wait for it, so they see every queued step's writes.

Observability and robustness, as on the JAX side: the pool gauges
(pages in use, shared and parked prefix pages; the memory observatory's
free / mapped / cached / swapped partition and its peaks), prefix-hit,
eviction, swap and demotion counters, flight-recorder events of the
page churn; ``prefix_admission_paused`` (brownout level >= 3: cached
entries keep serving hits, ``commit_prefix`` registers no new ones);
and ``scrub_slot``, the device-fault quarantine's zeroing of a
poisoned request's private pages.

``truncate`` rolls back the tail of a slot (speculative decoding's
rejected drafts) under the request's reserve floor. The module-level
scatter helpers (``append_kv``, ``write_prefill_kv``,
``write_chunk_kv``) write the pools IN PLACE and return them, where the
JAX helpers return new pools.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ...device import resolve_device
from ...kernels.paged_attention import ragged_rows
from ...observability import ledger_metrics, serving_metrics
from ...observability.recorder import default_recorder
from .policy import COLD_DEMOTE_DEFAULT, SWAP_PAGES_DEFAULT
from .quant import QuantConfig, kv_pool_dtype, kv_scale_shape

__all__ = ["GARBAGE_PAGE", "CacheConfig", "PagedKVCache",
           "ragged_page_indices", "flatten_page_levels", "page_offsets",
           "append_kv", "write_prefill_kv", "chunk_page_indices",
           "block_page_indices", "write_chunk_kv"]

GARBAGE_PAGE = 0


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Geometry and page encoding of the paged pool; the fields and
    defaults of the JAX ``CacheConfig`` that a single-device cache reads.

    ``num_pages`` includes the reserved garbage page, so the usable pool
    is ``num_pages - 1`` pages of ``page_size`` tokens each.
    ``kv_quant`` (off | int8 | fp8) picks the page encoding;
    ``scale_dtype`` and ``weight_quant`` never change the pool layout
    beyond that but enter the content-hash salt, as on the JAX side.
    ``swap_pages`` bounds the host swap store (0 = off) and
    ``demote_cold_prefix`` spills evicted prefix pages there, with the
    JAX cache's defaults. ``coll_quant``, ``coll_block`` and
    ``weight_matmul`` exist so that configs can be written alike on
    both sides; the slices that drive them are not ported, so only
    their defaults are accepted here."""

    num_layers: int
    num_heads: int
    head_dim: int
    num_pages: int = 128
    page_size: int = 16
    max_slots: int = 8
    max_seq_len: int = 512
    prefix_cache: bool = True
    swap_pages: int = SWAP_PAGES_DEFAULT
    demote_cold_prefix: bool = COLD_DEMOTE_DEFAULT
    kv_quant: str = "off"
    scale_dtype: str = "float32"
    weight_quant: str = "off"
    coll_quant: str = "off"
    coll_block: int = 32
    weight_matmul: str = "off"

    def __post_init__(self):
        if self.swap_pages < 0:
            raise ValueError(f"swap_pages must be >= 0, got "
                             f"{self.swap_pages}")
        if (self.coll_quant, self.coll_block) != ("off", 32):
            raise NotImplementedError(
                "quantized collectives come with the tensor-parallel mesh "
                "slice of the port; use coll_quant='off', coll_block=32")
        # the page encoding and the weight mode are validated exactly as
        # QuantConfig validates them (int8-matmul and narrow scales raise
        # NotImplementedError there)
        QuantConfig(kv=self.kv_quant, weights=self.weight_quant,
                    scale_dtype=self.scale_dtype,
                    weight_matmul=self.weight_matmul)

    @property
    def pages_per_seq(self) -> int:
        return -(-self.max_seq_len // self.page_size)

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.page_size)

    # ---- two-level page-table geometry (all derived) ----
    @property
    def dir_fanout(self) -> int:
        """Page indices per index row: the smallest power of two >= 8
        whose square covers ``pages_per_seq``."""
        f = 8
        while f * f < self.pages_per_seq:
            f *= 2
        return f

    @property
    def dir_entries(self) -> int:
        """Index rows a maximally long slot needs (directory width)."""
        return -(-self.pages_per_seq // self.dir_fanout)

    @property
    def dir_capacity(self) -> int:
        """Index-pool rows: the reserved all-garbage row 0, enough full
        rows for every usable page mapped once, and one partial row of
        slack per slot. Heavy page sharing can need more; ``allocate``
        then refuses like page exhaustion."""
        return (1 + -(-(self.num_pages - 1) // self.dir_fanout)
                + self.max_slots)

    @property
    def kv_quant_active(self) -> bool:
        return self.kv_quant != "off"

    @property
    def quant_config_active(self) -> bool:
        """Any quantization in play (KV pages or weights): gates the
        content-hash salt, empty when everything is off."""
        return self.kv_quant_active or self.weight_quant != "off"

    def page_bytes(self) -> int:
        """Bytes ONE page costs across all layers, K+V, scale rows
        included."""
        elems = self.num_layers * self.page_size * self.num_heads
        if self.kv_quant_active:
            kv_item = torch.empty((), dtype=kv_pool_dtype(
                self.kv_quant)).element_size()
            return 2 * elems * (self.head_dim * kv_item + 4)
        return 2 * elems * self.head_dim * 4

    def pages_for_budget(self, pool_bytes: int) -> int:
        """Usable pages a byte budget buys at this config's per-page
        cost (the garbage page excluded)."""
        return max(int(pool_bytes) // max(self.page_bytes(), 1) - 1, 1)


class PagedKVCache:
    """Preallocated K/V pools + page table + a host-side free list.

    Allocation is *reserve-ahead*: ``allocate(slot, n)`` reserves every
    page the sequence can ever touch (prompt + max new tokens), so
    backpressure happens in exactly one place, the scheduler's
    admission check."""

    def __init__(self, config: CacheConfig, device=None):
        c = config
        if c.num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
        self.config = c
        self.device = resolve_device(device)
        # content-hash salt, byte for byte the JAX cache's: with any
        # quantization on, the rolling digests fold in the quant config
        # first, so pages of different encodings never share a key;
        # all-off keeps the salt empty
        self._hash_salt = (hashlib.sha256(
            f"kvq:{c.kv_quant}:{c.scale_dtype}:w:{c.weight_quant}"
            f":coll:{c.coll_quant}:{c.coll_block}:wm:{c.weight_matmul}"
            .encode()).digest() if c.quant_config_active else b"")
        shape = (c.num_layers, c.num_pages, c.page_size, c.num_heads,
                 c.head_dim)
        dtype = (kv_pool_dtype(c.kv_quant) if c.kv_quant_active
                 else torch.float32)
        self.k_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.k_scale = self.v_scale = None
        if c.kv_quant_active:
            self.k_scale = torch.zeros(kv_scale_shape(shape),
                                       dtype=torch.float32,
                                       device=self.device)
            self.v_scale = torch.zeros_like(self.k_scale)
        # two-level table: slot_dir[slot] holds index-row ids, index_pool
        # rows hold page indices (row 0 reserved all-garbage, the
        # directory analogue of page 0)
        self._dir_fanout = c.dir_fanout
        self._dir_entries = c.dir_entries
        self._dir_capacity = c.dir_capacity
        self.index_pool = np.full((self._dir_capacity, self._dir_fanout),
                                  GARBAGE_PAGE, dtype=np.int32)
        self.slot_dir = np.zeros((c.max_slots, self._dir_entries),
                                 dtype=np.int32)
        self._dir_free: List[int] = list(range(self._dir_capacity - 1, 0, -1))
        self._slot_rows: Dict[int, List[int]] = {
            s: [] for s in range(c.max_slots)}
        # every mutation of the table bumps this, so the engine
        # re-uploads the device copy only after allocate/release
        self.page_table_version = 0
        self.seq_lens = np.zeros((c.max_slots,), dtype=np.int32)
        self._free: List[int] = list(range(c.num_pages - 1, GARBAGE_PAGE, -1))
        self._allocated_pages: Dict[int, List[int]] = {
            s: [] for s in range(c.max_slots)}
        # prefix cache: refcount[p] = slots whose page table maps p; a
        # cached page at refcount 0 parks on the _evictable LRU (front =
        # least recently released) instead of returning to the free list
        self._refcount = np.zeros((c.num_pages,), dtype=np.int64)
        self._prefix_map: Dict[bytes, int] = {}    # rolling digest -> page
        self._page_key: Dict[int, bytes] = {}      # page -> rolling digest
        self._evictable: "OrderedDict[int, None]" = OrderedDict()
        self._prefix_lens = {s: 0 for s in range(c.max_slots)}
        self._n_shared = 0           # pages mapped by >= 2 slots
        self.prefix_hits = 0         # pages served from the cache
        self.prefix_evictions = 0
        # host swap tier: rolling digest -> host copies of a page's bytes
        # (k, v[, k_scale, v_scale], each [L, page, ...]), LRU-bounded at
        # config.swap_pages entries
        self._swap: "OrderedDict[bytes, tuple]" = OrderedDict()
        self.swapped_out_pages = 0   # lifetime host copies
        self.swapped_in_pages = 0
        self.swap_evictions = 0
        # parked prefix pages whose bytes spilled to the host store before
        # the page returned to the free list
        self.demoted_pages = 0
        # brownout level >= 3 pauses prefix-cache ADMISSION: existing
        # entries keep serving hits, commit_prefix registers no new pages
        self.prefix_admission_paused = False
        m = serving_metrics()
        self._pages_gauge = m["pages_in_use"]
        self._hits_ctr = m["prefix_hits"]
        self._evict_ctr = m["prefix_evictions"]
        self._shared_gauge = m["prefix_shared_pages"]
        self._cached_gauge = m["prefix_cached_pages"]
        self._swap_out_ctr = m["swap_pages"].labels(dir="out")
        self._swap_in_ctr = m["swap_pages"].labels(dir="in")
        # the memory observatory: free/mapped/cached partition the
        # usable pool exactly; swapped counts host-tier entries
        lm = ledger_metrics()
        self._kv_pages_gauge = lm["kv_pages"]
        self._kv_pool_gauge = lm["kv_pool_pages"]
        self._kv_pool_gauge.set(c.num_pages - 1)
        self._kv_peak_gauge = lm["kv_pages_peak"]
        self._prefix_saved_ctr = lm["prefix_saved"]
        self._demoted_ctr = lm["kv_demoted"]
        self._demoted_ctr.inc(0)       # pre-bind: an export shows it
        self.peak_pages_in_use = 0
        self.peak_swapped_pages = 0
        self._page_cost = c.page_bytes()
        self._rec = default_recorder()
        self._update_gauges()

    # ------------------------------------------------ two-level page table --
    @property
    def page_table(self) -> np.ndarray:
        """Flat ``[max_slots, pages_per_seq]`` view, materialized from
        the two-level table; read-only (a write would mutate a
        temporary)."""
        flat = self.index_pool[self.slot_dir].reshape(
            self.config.max_slots, -1)[:, :self.config.pages_per_seq]
        flat.setflags(write=False)
        return flat

    def device_page_levels(self):
        """``(slot_dir, index_pool)`` as int32 tensors on the cache's
        device: what the engine's mirror uploads
        (:func:`flatten_page_levels` rebuilds the flat view there)."""
        return (torch.from_numpy(self.slot_dir.copy()).to(self.device),
                torch.from_numpy(self.index_pool.copy()).to(self.device))

    @property
    def slot_page_capacity(self) -> int:
        """Pages one slot can ever map through the two-level table,
        capped by the flat view and the usable pool."""
        return min(self.config.pages_per_seq,
                   self._dir_entries * self._dir_fanout,
                   self.config.num_pages - 1)

    def _dir_rows_for(self, n_pages: int) -> int:
        return -(-n_pages // self._dir_fanout) if n_pages > 0 else 0

    def _set_slot_pages(self, slot: int, pages: List[int]) -> None:
        """Point ``slot``'s directory at ``pages``. Index rows come off
        the row free list, where rows are always all-garbage, so only
        the mapped prefix is written."""
        f = self._dir_fanout
        rows = [self._dir_free.pop()
                for _ in range(self._dir_rows_for(len(pages)))]
        for j, r in enumerate(rows):
            chunk = pages[j * f:(j + 1) * f]
            self.index_pool[r, :len(chunk)] = chunk
        self.slot_dir[slot, :] = 0
        self.slot_dir[slot, :len(rows)] = rows
        self._slot_rows[slot] = rows
        self.page_table_version += 1

    def _truncate_slot_pages(self, slot: int, keep: int) -> None:
        """Shrink ``slot``'s directory to its first ``keep`` pages: whole
        tail rows reset to garbage and return to the row free list; the
        kept tail row's now-slack entries reset in place (``keep == 0``
        clears the slot)."""
        f = self._dir_fanout
        rows = self._slot_rows[slot]
        n_keep = self._dir_rows_for(keep)
        for r in rows[n_keep:]:
            self.index_pool[r, :] = GARBAGE_PAGE
            self._dir_free.append(r)
        if n_keep:
            self.index_pool[rows[n_keep - 1], keep - (n_keep - 1) * f:] = \
                GARBAGE_PAGE
        self._slot_rows[slot] = rows[:n_keep]
        self.slot_dir[slot, n_keep:] = 0
        self.page_table_version += 1

    # ---------------------------------------------------------- allocator --
    @property
    def num_free_pages(self) -> int:
        """Pages a fresh allocation can claim: the free list plus cached
        pages no live slot maps (evictable on demand)."""
        return len(self._free) + len(self._evictable)

    @property
    def num_cached_pages(self) -> int:
        return len(self._evictable)

    @property
    def pages_in_use(self) -> int:
        """Distinct pages mapped by at least one live slot."""
        return self.config.num_pages - 1 - self.num_free_pages

    def prefix_len(self, slot: int) -> int:
        """Tokens of ``slot``'s prompt served from the prefix cache by
        its ``allocate`` (KV already resident — prefill starts there)."""
        return self._prefix_lens[slot]

    def _block_hashes(self, prompt: Sequence[int]) -> List[bytes]:
        """Rolling SHA-256 digest per FULL page of ``prompt``: block i's
        key folds in every token of blocks 0..i (as int64 bytes), so
        equal keys mean equal prefixes. The chain starts from the
        quant-config salt, so the digests equal the JAX cache's under
        every quant config."""
        ps = self.config.page_size
        keys: List[bytes] = []
        digest = self._hash_salt
        for i in range(len(prompt) // ps):
            block = np.asarray(prompt[i * ps:(i + 1) * ps],
                               dtype=np.int64).tobytes()
            digest = hashlib.sha256(digest + block).digest()
            keys.append(digest)
        return keys

    def _match_prefix(self, prompt: Optional[Sequence[int]],
                      hashes: Optional[List[bytes]] = None) -> List[int]:
        """Longest run of cached pages covering ``prompt``'s head. Always
        leaves >= 1 prompt token uncovered: prefill must still run the
        tail to produce the last-position logits the sampler needs."""
        if not self.config.prefix_cache or not prompt:
            return []
        pages = []
        for key in (hashes if hashes is not None
                    else self._block_hashes(prompt)):
            page = self._prefix_map.get(key)
            if page is None:
                break
            pages.append(page)
        if pages and len(pages) * self.config.page_size >= len(prompt):
            pages.pop()
        return pages

    def _avail_for(self, matched: List[int]) -> int:
        """Pages a fresh allocation can still claim given that
        ``matched`` cached pages will be mapped (not evicted)."""
        return (len(self._free) + len(self._evictable)
                - sum(1 for p in matched if self._refcount[p] == 0))

    def can_allocate(self, n_tokens: int,
                     prompt: Optional[Sequence[int]] = None,
                     hashes: Optional[List[bytes]] = None) -> bool:
        need = self.config.pages_for(n_tokens)
        if need > self.config.pages_per_seq:
            return False
        if self._dir_rows_for(need) > len(self._dir_free):
            return False                        # index rows exhausted
        matched = self._match_prefix(prompt, hashes)
        return need - len(matched) <= self._avail_for(matched)

    def _page_entry(self, page: int) -> tuple:
        """Host copies of ``page``'s bytes across every layer: K and V,
        and with quantized pools their scale rows. The copies run on the
        cache's stream and wait for it, so they hold every queued
        step's writes."""
        pools = [self.k_pool, self.v_pool]
        if self.k_scale is not None:
            pools += [self.k_scale, self.v_scale]
        return tuple(p[:, page].to("cpu", copy=True) for p in pools)

    def _store(self, key: bytes, entry: tuple) -> None:
        """Put ``entry`` at the MRU end of the swap store, evicting its
        oldest entries beyond ``config.swap_pages``."""
        self._swap[key] = entry
        while len(self._swap) > self.config.swap_pages:
            self._swap.popitem(last=False)
            self.swap_evictions += 1

    def _spill_page(self, key: bytes, page: int) -> bool:
        """Copy ``page``'s bytes (scale rows included) into the host swap
        store under its content digest, in the entry format ``swap_out``
        writes. A key already held only moves to the MRU end. Returns
        True when bytes were copied."""
        if self.config.swap_pages <= 0:
            return False
        if key in self._swap:
            self._swap.move_to_end(key)
            return False
        self._store(key, self._page_entry(page))
        return True

    def _evict_one(self) -> int:
        """Reclaim the least-recently-released cached page (refcount 0
        by construction — a mapped page is never on the LRU). With
        cold-prefix demotion on, its bytes spill to the host store
        first, so a later request with that prefix swaps it back in at
        admission instead of re-prefilling."""
        page, _ = self._evictable.popitem(last=False)
        key = self._page_key.pop(page)
        del self._prefix_map[key]
        if self.config.demote_cold_prefix and self._spill_page(key, page):
            self.demoted_pages += 1
            self._demoted_ctr.inc()
            self.swapped_out_pages += 1
            self._swap_out_ctr.inc()
            self._rec.emit("cache", "page_demoted", page=page,
                           resident=len(self._swap))
        self.prefix_evictions += 1
        self._evict_ctr.inc()
        return page

    def allocate(self, slot: int, n_tokens: int,
                 prompt: Optional[Sequence[int]] = None,
                 hashes: Optional[List[bytes]] = None) -> bool:
        """Reserve pages for a sequence of up to ``n_tokens`` in ``slot``.

        With ``prompt`` given (and prefix caching on), full prompt pages
        already in the cache are mapped read-only into the slot's page
        table (refcount++) and only the remainder takes fresh pages;
        ``prefix_len(slot)`` reports the covered token count. Returns
        False (mutating nothing) when the pool, or the index rows of the
        two-level table, cannot satisfy it."""
        if self._allocated_pages[slot]:
            raise RuntimeError(f"slot {slot} already holds an allocation")
        need = self.config.pages_for(n_tokens)
        if need > self.config.pages_per_seq:
            return False
        if self._dir_rows_for(need) > len(self._dir_free):
            return False                        # index rows exhausted
        matched = self._match_prefix(prompt, hashes)
        if need - len(matched) > self._avail_for(matched):
            return False
        pages: List[int] = []
        for page in matched:
            if self._refcount[page] == 0:      # cached -> mapped again
                del self._evictable[page]
            self._refcount[page] += 1
            if self._refcount[page] == 2:
                self._n_shared += 1
            pages.append(page)
        for _ in range(need - len(matched)):
            page = self._free.pop() if self._free else self._evict_one()
            self._refcount[page] = 1
            pages.append(page)
        self._allocated_pages[slot] = pages
        self._set_slot_pages(slot, pages)
        self.seq_lens[slot] = 0
        self._prefix_lens[slot] = len(matched) * self.config.page_size
        if matched:
            self.prefix_hits += len(matched)
            self._hits_ctr.inc(len(matched))
            # every cache-served page is a page of prefill K/V writes
            # avoided (the cost ledger's saved bytes)
            self._prefix_saved_ctr.inc(len(matched) * self._page_cost)
            self._rec.emit("cache", "prefix_hit", slot=slot,
                           pages=len(matched),
                           tokens=self._prefix_lens[slot])
        self._update_gauges()
        self._rec.emit("cache", "pages_allocated", slot=slot, pages=need,
                       cached=len(matched), free_pages=self.num_free_pages)
        return True

    def truncate(self, slot: int, n_tokens: int,
                 reserve_tokens: int = 0) -> int:
        """Roll back the last ``n_tokens`` KV entries of ``slot`` (the
        speculative-decoding rejection path: draft K/V was written, the
        target disagreed). Decrements ``seq_lens[slot]`` and returns
        now-empty tail pages to the free list, EXCEPT pages within
        ``pages_for(max(new_len, reserve_tokens))``: under the request's
        reserve-ahead floor a rollback is pure ``seq_lens`` accounting.
        Returns the number of pages freed. Refuses (raises, mutating
        nothing) an underflow past zero or past the prefix-cache
        boundary, and freeing a page that another slot maps or that the
        prefix cache holds."""
        pages = self._allocated_pages[slot]
        if not pages:
            raise RuntimeError(
                f"truncate of slot {slot} which holds no allocation")
        if n_tokens < 0:
            raise ValueError(f"n_tokens must be >= 0, got {n_tokens}")
        new_len = int(self.seq_lens[slot]) - n_tokens
        if new_len < 0:
            raise RuntimeError(
                f"truncate underflow: slot {slot} holds "
                f"{int(self.seq_lens[slot])} tokens, asked to drop "
                f"{n_tokens}")
        if new_len < self._prefix_lens[slot]:
            raise RuntimeError(
                f"truncate past the prefix-cache boundary: slot {slot} "
                f"maps {self._prefix_lens[slot]} cached prefix tokens, "
                f"truncate would leave {new_len}")
        keep = self.config.pages_for(max(new_len, reserve_tokens))
        doomed = pages[keep:]
        for page in doomed:
            if self._refcount[page] != 1:
                raise RuntimeError(
                    f"truncate would free page {page} (slot {slot}) "
                    f"with refcount {int(self._refcount[page])} — "
                    "shared pages are never truncated")
            if page in self._page_key:
                raise RuntimeError(
                    f"truncate would free page {page} (slot {slot}) "
                    "which is registered in the prefix cache")
        self.seq_lens[slot] = new_len
        if doomed:
            for page in doomed:
                self._refcount[page] = 0
            self._free.extend(reversed(doomed))
            self._zero_scale_rows(doomed)
            self._allocated_pages[slot] = pages[:keep]
            self._truncate_slot_pages(slot, keep)
            self._update_gauges()
        self._rec.emit("cache", "pages_truncated", slot=slot,
                       tokens=n_tokens, pages=len(doomed),
                       free_pages=self.num_free_pages)
        return len(doomed)

    def commit_prefix(self, slot: int, prompt: Sequence[int],
                      hashes: Optional[List[bytes]] = None) -> int:
        """Register ``slot``'s now-prefilled FULL prompt pages in the
        prefix map (idempotent; pages already cached or keys already
        owned by another page are skipped). Call once the prompt's KV
        is resident, i.e. after prefill. A no-op while
        ``prefix_admission_paused``. Returns pages registered."""
        if (not self.config.prefix_cache or not prompt
                or self.prefix_admission_paused):
            return 0
        pages = self._allocated_pages[slot]
        keys = hashes if hashes is not None else self._block_hashes(prompt)
        n_new = 0
        for i, key in enumerate(keys[:len(pages)]):
            page = pages[i]
            if page in self._page_key or key in self._prefix_map:
                continue
            self._prefix_map[key] = page
            self._page_key[page] = key
            n_new += 1
        return n_new

    # ------------------------------------------------- host swap tier --
    @property
    def num_swapped_pages(self) -> int:
        """Pages resident in the host swap store."""
        return len(self._swap)

    def demote_prefix_pages(self, max_pages: Optional[int] = None) -> int:
        """Demote up to ``max_pages`` (default all) parked prefix pages,
        least recently released first: spill each page's bytes to the
        host store under its digest, unregister it and return it to the
        free list. A later prompt with that content swaps it back in at
        admission. A no-op without the swap tier. Returns pages
        demoted."""
        if self.config.swap_pages <= 0:
            return 0
        budget = len(self._evictable) if max_pages is None \
            else min(max(max_pages, 0), len(self._evictable))
        freed: List[int] = []
        copied = 0
        for _ in range(budget):
            page, _ = self._evictable.popitem(last=False)
            key = self._page_key.pop(page)
            del self._prefix_map[key]
            if self._spill_page(key, page):
                copied += 1
            freed.append(page)
        if freed:
            # spilled before the scale rows zero: the entry carries the
            # live scales, the freed page audits clean
            self._free.extend(freed)
            self._zero_scale_rows(freed)
            self.demoted_pages += len(freed)
            self._demoted_ctr.inc(len(freed))
            if copied:
                self.swapped_out_pages += copied
                self._swap_out_ctr.inc(copied)
            self._update_gauges()
            self._rec.emit("cache", "pages_demoted", pages=len(freed),
                           copied=copied, resident=len(self._swap),
                           free_pages=self.num_free_pages)
        return len(freed)

    def swap_out(self, slot: int, tokens: Sequence[int],
                 hashes: Optional[List[bytes]] = None) -> int:
        """Copy ``slot``'s FULL pages holding ``tokens``' KV into the
        host swap store (preemption; call before ``release``).
        ``tokens`` is the slot's KV-resident prefix (at most
        ``seq_lens[slot]`` long): pages past it hold garbage and are
        never copied. Keys are the prefix cache's rolling digests; a key
        already held only moves to the MRU end. Returns pages copied."""
        if self.config.swap_pages <= 0 or not len(tokens):
            return 0
        pages = self._allocated_pages[slot]
        if not pages:
            raise RuntimeError(
                f"swap_out of slot {slot} which holds no allocation")
        if len(tokens) > int(self.seq_lens[slot]):
            raise RuntimeError(
                f"swap_out of {len(tokens)} tokens but slot {slot} has "
                f"only {int(self.seq_lens[slot])} KV-resident — the tail "
                "pages hold garbage")
        keys = hashes if hashes is not None else self._block_hashes(tokens)
        n = 0
        for i, key in enumerate(keys[:len(pages)]):
            if key in self._swap:
                self._swap.move_to_end(key)
                continue
            self._store(key, self._page_entry(pages[i]))
            n += 1
        if n:
            self.swapped_out_pages += n
            self._swap_out_ctr.inc(n)
            self._rec.emit("cache", "swap_out", slot=slot, pages=n,
                           resident=len(self._swap))
            self._update_gauges()
        return n

    def swap_in(self, slot: int, tokens: Sequence[int],
                hashes: Optional[List[bytes]] = None) -> int:
        """Write host-swapped pages back into ``slot``'s freshly reserved
        pages (resume; call right after ``allocate``). Walks ``tokens``'
        page keys from past the device prefix hit; each key the store
        holds is written into the slot's page for that position, byte
        for byte, and registered in the prefix map, and
        ``prefix_len(slot)`` advances, so only the unrestored tail
        re-prefills. Leaves at least one token uncovered for the
        sampler's logits, as ``_match_prefix`` does. Returns pages
        restored."""
        if self.config.swap_pages <= 0 or not self._swap or not len(tokens):
            return 0
        pages = self._allocated_pages[slot]
        if not pages:
            raise RuntimeError(
                f"swap_in of slot {slot} which holds no allocation")
        keys = hashes if hashes is not None else self._block_hashes(tokens)
        ps = self.config.page_size
        start = self._prefix_lens[slot] // ps
        stop = min(len(keys), len(pages), (len(tokens) - 1) // ps)
        pools = [self.k_pool, self.v_pool]
        if self.k_scale is not None:
            pools += [self.k_scale, self.v_scale]
        restored = 0
        for i in range(start, stop):
            entry = self._swap.get(keys[i])
            if entry is None:
                break
            page = pages[i]
            if self._refcount[page] != 1 or page in self._page_key:
                # a mapped cache hit past the device-matched prefix: its
                # KV is resident already; only the cursor advances
                self._prefix_lens[slot] += ps
                continue
            for pool, host in zip(pools, entry):
                _write_page(pool, page, host)
            self._swap.move_to_end(keys[i])
            if (self.config.prefix_cache and keys[i] not in self._prefix_map
                    and page not in self._page_key):
                self._prefix_map[keys[i]] = page
                self._page_key[page] = keys[i]
            self._prefix_lens[slot] += ps
            restored += 1
        if restored:
            self.swapped_in_pages += restored
            self._swap_in_ctr.inc(restored)
            self._rec.emit("cache", "swap_in", slot=slot, pages=restored,
                           tokens=self._prefix_lens[slot])
            self._update_gauges()
        return restored

    @property
    def swap_quant_key(self) -> tuple:
        """The quant-config tuple that must match for two caches'
        content-addressed entries to be interchangeable: the fields the
        block-hash salt folds in."""
        c = self.config
        return (c.kv_quant, c.scale_dtype, c.weight_quant, c.coll_quant,
                c.coll_block, c.weight_matmul)

    def release(self, slot: int) -> None:
        """Drop ``slot``'s mapping: refcount-- on every page; uncached
        pages at refcount 0 return to the free list, cached ones park on
        the eviction LRU. Raises instead of corrupting the pool on a
        double free or a garbage-page free."""
        pages = self._allocated_pages[slot]
        if not pages:
            raise RuntimeError(f"double free: slot {slot} holds no allocation")
        for page in pages:
            if page == GARBAGE_PAGE:
                raise RuntimeError(
                    f"slot {slot} maps the reserved garbage page — "
                    "pool metadata corrupted")
            if self._refcount[page] <= 0:
                raise RuntimeError(
                    f"free of unallocated page {page} (slot {slot}) — "
                    "refcount underflow")
        freed: List[int] = []
        for page in pages:
            self._refcount[page] -= 1
            if self._refcount[page] == 1:
                self._n_shared -= 1
            elif self._refcount[page] == 0:
                if page in self._page_key:
                    self._evictable[page] = None    # MRU end of the LRU
                else:
                    freed.append(page)
        self._free.extend(reversed(freed))
        self._zero_scale_rows(freed)
        self._allocated_pages[slot] = []
        self._truncate_slot_pages(slot, 0)
        self.seq_lens[slot] = 0
        self._prefix_lens[slot] = 0
        self._update_gauges()
        self._rec.emit("cache", "pages_released", slot=slot,
                       pages=len(pages), free_pages=self.num_free_pages)

    def scrub_slot(self, slot: int) -> int:
        """Zero the pool values of ``slot``'s PRIVATE pages (refcount 1,
        not prefix-registered) — the device-fault quarantine calls this
        before releasing a poisoned request: NaN K/V left in a freed
        page would leak into the next request that reuses it, because
        IEEE ``0 * NaN = NaN`` defeats the masked attention. Shared or
        registered pages are skipped: a healthy prefill wrote them and
        other requests may read them. The zeroing is queued on the
        cache's stream, behind every step already in flight. Returns
        pages scrubbed."""
        pages = [p for p in self._allocated_pages[slot]
                 if self._refcount[p] == 1 and p not in self._page_key]
        if pages:
            idx = _host_to_device(torch.tensor(pages, dtype=torch.long),
                                  self.device)
            pools = [self.k_pool, self.v_pool]
            if self.k_scale is not None:
                # a poisoned row's scales can be NaN too
                pools += [self.k_scale, self.v_scale]
            for pool in pools:
                if pool.dtype == torch.float8_e4m3fn:
                    pool = pool.view(torch.uint8)     # 0x00 is +0.0
                pool[:, idx] = 0
            self._rec.emit("cache", "pages_scrubbed", slot=slot,
                           pages=len(pages))
        return len(pages)

    def _update_gauges(self) -> None:
        in_use = self.pages_in_use
        self.peak_pages_in_use = max(self.peak_pages_in_use, in_use)
        self.peak_swapped_pages = max(self.peak_swapped_pages,
                                      len(self._swap))
        self._pages_gauge.set(in_use)
        self._shared_gauge.set(self._n_shared)
        self._cached_gauge.set(len(self._evictable))
        g = self._kv_pages_gauge
        g.labels(state="free").set(len(self._free))
        g.labels(state="mapped").set(in_use)
        g.labels(state="cached").set(len(self._evictable))
        g.labels(state="swapped").set(len(self._swap))
        self._kv_peak_gauge.labels(state="mapped").set(
            self.peak_pages_in_use)
        self._kv_peak_gauge.labels(state="swapped").set(
            self.peak_swapped_pages)

    def _zero_scale_rows(self, pages: List[int]) -> None:
        """Quantized pools: zero the scale rows of pages returning to the
        free list (truncate's rolled-back tail, release's uncached
        pages), in place. Stale scales of a free page are never read (a
        reallocated page is rewritten per position and attention masks
        past the length); the zeroing keeps :meth:`scale_pool_clean`
        exact, as the JAX cache does under its audit switch."""
        if self.k_scale is None or not pages:
            return
        idx = _host_to_device(torch.tensor(pages, dtype=torch.long),
                              self.device)
        self.k_scale[:, idx] = 0
        self.v_scale[:, idx] = 0

    def scale_pool_clean(self) -> bool:
        """True when every free-list page's scale rows are exactly zero
        (trivially true for float pools)."""
        if self.k_scale is None or not self._free:
            return True
        idx = torch.tensor(self._free, dtype=torch.long, device=self.device)
        return bool((self.k_scale[:, idx] == 0).all()
                    and (self.v_scale[:, idx] == 0).all())

    def check_invariants(self) -> None:
        """Accounting and refcount invariants; raises ``AssertionError``
        naming the first one broken."""
        c = self.config
        mapped: Dict[int, int] = {}
        for ps in self._allocated_pages.values():
            for p in ps:
                mapped[p] = mapped.get(p, 0) + 1
        _check(GARBAGE_PAGE not in mapped, "garbage page handed out")
        for p, n in mapped.items():
            _check(self._refcount[p] == n,
                   f"page {p} refcount {self._refcount[p]} != {n} mappings")
        _check(not set(self._evictable) & set(mapped),
               "cached page still mapped by a live slot")
        for p in self._evictable:
            _check(self._refcount[p] == 0, "evictable page has references")
        _check(sorted(list(self._free) + list(self._evictable)
                      + list(mapped)) == list(range(1, c.num_pages)),
               "free list + cached pages + allocations must partition the "
               "pool")
        for page, key in self._page_key.items():
            _check(self._prefix_map.get(key) == page,
                   "prefix map / page key desynchronized")
        _check(self._n_shared == sum(1 for n in mapped.values() if n >= 2),
               "shared-page count desynchronized")
        for s, ps in self._allocated_pages.items():
            _check(self.seq_lens[s] <= len(ps) * c.page_size,
                   f"slot {s} overflowed its reservation")
        _check(len(self._swap) <= max(c.swap_pages, 0),
               f"swap store holds {len(self._swap)} pages, budget "
               f"{c.swap_pages}")
        # ---- two-level table ----
        _check(bool((self.index_pool[0] == GARBAGE_PAGE).all()),
               "reserved garbage index row 0 was written")
        used_rows: List[int] = []
        for s, rows in self._slot_rows.items():
            pages = self._allocated_pages[s]
            _check(len(rows) == self._dir_rows_for(len(pages)),
                   f"slot {s} holds {len(rows)} index rows for "
                   f"{len(pages)} pages")
            used_rows.extend(rows)
            flat = [int(x) for r in rows for x in self.index_pool[r]]
            _check(flat[:len(pages)] == list(pages),
                   f"slot {s} index rows desynchronized from its pages")
            _check(all(x == GARBAGE_PAGE for x in flat[len(pages):]),
                   f"slot {s} slack index entries must stay garbage")
            _check(list(self.slot_dir[s, :len(rows)]) == rows
                   and bool((self.slot_dir[s, len(rows):] == 0).all()),
                   f"slot {s} directory desynchronized from its rows")
        _check(len(set(used_rows)) == len(used_rows),
               "index row mapped by two slots")
        _check(sorted(self._dir_free + used_rows)
               == list(range(1, self._dir_capacity)),
               "row free list + slot rows must partition the index pool")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _host_to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``. On CUDA it goes through pinned
    memory without waiting for the stream: the copy is queued behind
    every step already in flight, and PyTorch's pinned allocator
    recycles the staging buffer only once the copy has run."""
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _write_page(pool: torch.Tensor, page: int, host: torch.Tensor) -> None:
    """``pool[:, page] = host`` byte for byte (float8 pools through
    byte views), queued on the pool's stream."""
    dst = pool[:, page]
    if dst.dtype == torch.float8_e4m3fn:
        dst, host = dst.view(torch.uint8), host.view(torch.uint8)
    dst.copy_(_host_to_device(host, pool.device),
              non_blocking=pool.device.type == "cuda")


def ragged_page_indices(page_table, q_starts, q_lens, kv_lens, width: int,
                        page_size: int):
    """Per-FLAT-token (pages [N], offs [N], pos [N], valid [N]) for the
    unified ragged step: token i of the flat block belongs to the row b
    with ``q_starts[b] <= i < q_starts[b] + q_lens[b]`` and its K/V
    scatters to that row's page for global position
    ``kv_lens[b] - q_lens[b] + (i - q_starts[b])`` — the addressing rule
    the attention masks (``ragged_rows``) share. Tokens covered by no
    row are padding: routed to the garbage page at a clamped
    position."""
    row, _, pos, valid = ragged_rows(q_starts, q_lens, kv_lens, width)
    n_pages = page_table.shape[1]
    cpos = torch.clamp(pos, max=n_pages * page_size - 1)
    pages = torch.where(valid, page_table[row.long(), (cpos // page_size).long()],
                        torch.full_like(cpos, GARBAGE_PAGE))
    return pages, cpos % page_size, cpos, valid


def flatten_page_levels(slot_dir, index_pool, pages_per_seq: int):
    """The flat ``[max_slots, pages_per_seq]`` page table from the
    two-level pair, on whatever device they lie: one int32 gather.
    Inactive directory entries point at row 0 (all garbage). The result
    is contiguous (the kernels take no strided table): where the
    directory spans more than ``pages_per_seq`` columns the slice is
    copied."""
    flat = index_pool[slot_dir.long()].reshape(slot_dir.shape[0], -1)
    return flat[:, :pages_per_seq].contiguous()


def page_offsets(page_table, positions, page_size: int):
    """Per-slot (page, offset) of ``positions`` through ``page_table``:
    the addressing rule of every decode-path scatter (``lm_decode``'s
    per-layer appends)."""
    b = torch.arange(page_table.shape[0], device=page_table.device)
    positions = positions.long()
    return page_table[b, positions // page_size], positions % page_size


def append_kv(k_pool, v_pool, k_new, v_new, page_table, positions):
    """Scatter one new token's K/V per slot into the pools, in place.
    k_new/v_new ``[L, B, H, D]``; positions ``[B]`` (each token's
    position, the pre-append length). Returns the pools."""
    pages, offs = page_offsets(page_table, positions, k_pool.shape[2])
    pages = pages.long()
    k_pool[:, pages, offs] = k_new
    v_pool[:, pages, offs] = v_new
    return k_pool, v_pool


def write_prefill_kv(k_pool, v_pool, k, v, page_row, prompt_len: int):
    """Scatter a whole prompt's K/V ``[L, S, H, D]`` (S bucket-padded)
    into one sequence's pages, in place; positions ``>= prompt_len`` go
    to the garbage page (their page-row lookup clamped to the row, as a
    JAX gather clamps). Returns the pools."""
    page_size = k_pool.shape[2]
    pos = torch.arange(k.shape[1], device=page_row.device)
    col = torch.clamp(pos // page_size, max=page_row.shape[0] - 1)
    pages = torch.where(pos < prompt_len, page_row[col],
                        torch.full_like(pos, GARBAGE_PAGE)).long()
    k_pool[:, pages, pos % page_size] = k
    v_pool[:, pages, pos % page_size] = v
    return k_pool, v_pool


def chunk_page_indices(page_row, start, chunk_len, width: int,
                       page_size: int):
    """(pages, offs) ``[width]`` for scattering a ``width``-wide chunk
    starting at position ``start`` through ``page_row``. Rows ``>=
    chunk_len`` are padding: their position is clamped to the table's
    reach (``n_pages * page_size - 1``) and they go to the garbage
    page."""
    i = torch.arange(width, device=page_row.device)
    pos = torch.clamp(start + i, max=page_row.shape[0] * page_size - 1)
    pages = torch.where(i < chunk_len, page_row[pos // page_size],
                        torch.full_like(pos, GARBAGE_PAGE))
    return pages, pos % page_size


def block_page_indices(page_table, starts, q_lens, width: int,
                       page_size: int):
    """Per-slot (pages, offs) ``[B, width]`` for scattering a
    ``width``-wide token block per slot starting at ``starts[b]`` (the
    verify shape: the pending token and its drafts, ragged through
    ``q_lens``). Rows ``t >= q_lens[b]`` are padding: clamped positions,
    routed to the garbage page."""
    n_pages = page_table.shape[1]
    i = torch.arange(width, device=page_table.device)[None, :]
    pos = torch.clamp(starts.long()[:, None] + i,
                      max=n_pages * page_size - 1)
    b = torch.arange(page_table.shape[0], device=page_table.device)[:, None]
    pages = torch.where(i < q_lens[:, None], page_table[b, pos // page_size],
                        torch.full_like(pos, GARBAGE_PAGE))
    return pages, pos % page_size


def write_chunk_kv(k_pool, v_pool, k, v, page_row, start, chunk_len):
    """Scatter one prefill chunk's K/V ``[L, C, H, D]`` into a
    sequence's pages, in place (rows ``>= chunk_len`` to the garbage
    page). Returns the pools."""
    pages, offs = chunk_page_indices(page_row, start, chunk_len, k.shape[1],
                                     k_pool.shape[2])
    pages = pages.long()
    k_pool[:, pages, offs] = k
    v_pool[:, pages, offs] = v
    return k_pool, v_pool
