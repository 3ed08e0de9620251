"""Free-list page allocator for the paged KV cache (vLLM-style).

A global pool of ``num_pages`` fixed-size pages; each sequence owns an
ordered *block table* of page ids covering its logical token range
``[0, seq_len)``. Pages are ref-counted so a forked sequence (GRPO groups,
shared system prompts) shares its parent's prompt pages copy-on-write:
full shared pages stay shared forever (they are append-only), and only a
*partial* last page is copied when a writer appends into it.

Accounting speaks the event vocabulary of the reference's
``repro/core/trace.py`` and of :mod:`repro_torch.core.allocator` —
``(op, vid, nbytes, tag)`` tuples with op in {"alloc", "free"} — so a
paged serving run can be replayed through the paper's
:class:`~repro_torch.core.allocator.CachingAllocator` and compared
against the dense ``[B, capacity]`` layout on reserved bytes and
fragmentation. Internal fragmentation of the paged layout is bounded by
construction: at most one partially-filled page per live sequence.

Cross-request prefix caching (the vLLM block-reuse idiom) extends the
same pool: every *full* page of a committed prompt is indexed by a hash
chain over its token ids (``digest_i = sha256(digest_{i-1} ||
tokens_page_i)``), so a later request whose prompt shares the prefix
takes a ref-count bump on the cached pages instead of re-prefilling
them. Pages whose refcount drops to zero while indexed are *parked* in
an LRU list — still resident in the pool, evicted lazily only when a
fresh allocation finds the free list empty. A weight-version bump
(RLHF updates params between rollouts) invalidates the whole index so
stale KV is never served across a weight update.

A copy of ``repro/paged/page_manager.py`` (pure Python): the port imports
nothing of ``repro``, whose ``paged/__init__.py`` imports JAX.
"""
from __future__ import annotations

import hashlib
import itertools
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

Event = Tuple[str, int, int, str]   # (op, vid, nbytes, tag) — trace.Event

PAGE_TAG = "kv_page"


class PagePoolExhausted(Exception):
    """Raised when an allocation cannot be served; callers preempt."""


@dataclass
class PageManagerStats:
    num_pages: int
    page_size: int
    pages_in_use: int = 0
    peak_pages_in_use: int = 0
    n_page_alloc: int = 0
    n_page_free: int = 0
    n_cow_copies: int = 0
    n_forks: int = 0
    n_prefix_hits: int = 0        # pages served from the prefix index
    n_prefix_queries: int = 0     # allocate_prefix calls
    n_prefix_evictions: int = 0   # parked pages reclaimed under pressure
    n_prefix_invalidations: int = 0


@dataclass
class _Seq:
    pages: List[int] = field(default_factory=list)
    length: int = 0            # logical tokens written


class PageManager:
    """Block allocator over a fixed page pool with per-sequence tables.

    ``bytes_per_token`` (KV bytes for one token across all layers) sizes
    the alloc/free events; with the default 0 the events are still emitted
    with ``nbytes = page_size`` so replay remains meaningful in "slot"
    units.
    """

    def __init__(self, num_pages: int, page_size: int, *,
                 bytes_per_token: int = 0):
        assert num_pages > 0 and page_size > 0
        self.num_pages = num_pages
        self.page_size = page_size
        self.bytes_per_token = bytes_per_token
        self._free: List[int] = list(range(num_pages - 1, -1, -1))  # LIFO
        self._refcount: List[int] = [0] * num_pages
        self._seqs: Dict[int, _Seq] = {}
        self._vids = itertools.count(1)
        self._page_vid: List[int] = [0] * num_pages   # vid of live page
        self.events: List[Event] = []
        self.stats = PageManagerStats(num_pages, page_size)
        # -- prefix cache state --
        # digest -> page holding that (chain-hashed) full page of prompt KV
        self._cached: Dict[bytes, int] = {}
        # per-page digest when indexed (inverse of _cached), else None
        self._page_hash: List[Optional[bytes]] = [None] * num_pages
        # zero-ref indexed pages, oldest-parked first (evictable)
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.weight_version = 0

    # -- low-level page ops --------------------------------------------------
    @property
    def page_bytes(self) -> int:
        return (self.bytes_per_token or 1) * self.page_size

    @property
    def num_free_pages(self) -> int:
        return len(self._free)

    @property
    def num_cached_pages(self) -> int:
        """Zero-ref pages parked in the prefix-cache LRU (evictable)."""
        return len(self._lru)

    def cached_bytes(self) -> int:
        return len(self._lru) * self.page_bytes

    def _deindex(self, p: int):
        h = self._page_hash[p]
        if h is not None:
            self._page_hash[p] = None
            if self._cached.get(h) == p:
                del self._cached[h]
        self._lru.pop(p, None)

    def _release_parked(self, p: int):
        """Truly free a parked page: drop its index entry and emit the
        deferred free event, returning the page to the free list."""
        assert self._refcount[p] == 0
        self._deindex(p)
        self.events.append(("free", self._page_vid[p], self.page_bytes,
                            PAGE_TAG))
        self.stats.n_page_free += 1
        self._free.append(p)
        self.stats.pages_in_use = self.num_pages - len(self._free)

    def _evict_one(self) -> int:
        """LRU eviction under pool pressure: reclaim the oldest parked
        (zero-ref, indexed) page."""
        p, _ = self._lru.popitem(last=False)
        self._release_parked(p)
        self.stats.n_prefix_evictions += 1
        return p

    def _grab_page(self) -> int:
        if not self._free and self._lru:
            self._evict_one()               # pool pressure: LRU eviction
        if not self._free:
            raise PagePoolExhausted(
                f"page pool exhausted ({self.num_pages} pages of "
                f"{self.page_size} tokens)")
        p = self._free.pop()
        assert self._refcount[p] == 0
        self._refcount[p] = 1
        vid = next(self._vids)
        self._page_vid[p] = vid
        self.events.append(("alloc", vid, self.page_bytes, PAGE_TAG))
        self.stats.n_page_alloc += 1
        self.stats.pages_in_use = self.num_pages - len(self._free)
        self.stats.peak_pages_in_use = max(self.stats.peak_pages_in_use,
                                           self.stats.pages_in_use)
        return p

    def _drop_ref(self, p: int):
        assert self._refcount[p] > 0, f"double free of page {p}"
        self._refcount[p] -= 1
        if self._refcount[p] == 0:
            if self._page_hash[p] is not None:
                # indexed page: park in the LRU instead of freeing — its KV
                # stays resident and a later prefix match revives it. The
                # free event is deferred until eviction/invalidation.
                self._lru[p] = None
                return
            self.events.append(("free", self._page_vid[p], self.page_bytes,
                                PAGE_TAG))
            self.stats.n_page_free += 1
            self._free.append(p)
            self.stats.pages_in_use = self.num_pages - len(self._free)

    # -- sequence API --------------------------------------------------------
    def pages_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.page_size)

    def _allocatable(self) -> int:
        """Pages a fresh allocation can claim: free + evictable (parked)."""
        return len(self._free) + len(self._lru)

    def can_allocate(self, num_tokens: int) -> bool:
        return self.pages_needed(num_tokens) <= self._allocatable()

    def allocate(self, seq_id: int, num_tokens: int) -> List[int]:
        """Claim pages covering ``num_tokens`` logical tokens for a new
        sequence. Atomic: on exhaustion nothing is allocated."""
        assert seq_id not in self._seqs, f"seq {seq_id} already allocated"
        need = self.pages_needed(num_tokens)
        if need > self._allocatable():
            raise PagePoolExhausted(
                f"need {need} pages, {self._allocatable()} allocatable")
        seq = _Seq([self._grab_page() for _ in range(need)], num_tokens)
        self._seqs[seq_id] = seq
        return list(seq.pages)

    def fork(self, parent_id: int, child_id: int) -> List[int]:
        """Child shares every parent page (copy-on-write prompt prefix)."""
        assert child_id not in self._seqs
        parent = self._seqs[parent_id]
        for p in parent.pages:
            self._refcount[p] += 1
        self._seqs[child_id] = _Seq(list(parent.pages), parent.length)
        self.stats.n_forks += 1
        return list(parent.pages)

    def append_token(self, seq_id: int) -> List[Tuple[int, int]]:
        """Extend a sequence by one logical token. Returns a list of
        ``(src_page, dst_page)`` device copies the caller must perform:
        a CoW copy when the written page was shared, else nothing (a fresh
        page needs no copy). Atomic on exhaustion."""
        seq = self._seqs[seq_id]
        copies: List[Tuple[int, int]] = []
        if seq.length % self.page_size == 0:
            seq.pages.append(self._grab_page())
        else:
            last = seq.pages[-1]
            if self._refcount[last] > 1:
                fresh = self._grab_page()          # may raise; state intact
                copies.append((last, fresh))
                self._drop_ref(last)
                seq.pages[-1] = fresh
                self.stats.n_cow_copies += 1
            elif self._page_hash[last] is not None:
                # sole owner about to mutate an indexed page (truncated
                # below full, now re-appending): the stored digest no
                # longer describes the content — drop the index entry.
                self._deindex(last)
        seq.length += 1
        return copies

    def append_tokens(self, seq_id: int, n: int) -> List[Tuple[int, int]]:
        """Extend a sequence by ``n`` logical tokens (speculative decode
        grows each slot by ``k+1`` before the verify forward). Atomic: the
        total page need — growth pages plus at most one CoW copy of a
        shared partial last page — is checked up front, so on exhaustion
        nothing is allocated. Returns the concatenated CoW copies."""
        seq = self._seqs[seq_id]
        need = self.pages_needed(seq.length + n) - len(seq.pages)
        if seq.length % self.page_size != 0 and \
                self._refcount[seq.pages[-1]] > 1:
            need += 1                      # CoW copy of the shared last page
        if need > self._allocatable():
            raise PagePoolExhausted(
                f"need {need} pages, {self._allocatable()} allocatable")
        copies: List[Tuple[int, int]] = []
        for _ in range(n):
            copies.extend(self.append_token(seq_id))
        return copies

    def truncate(self, seq_id: int, length: int) -> None:
        """Shrink a sequence's logical length (drop rejected draft tokens
        after the accept step). Whole pages past the new length are freed
        (ref-dropped — a forked sibling may keep them alive); stale tokens
        in the kept partial last page are masked by position and
        overwritten by future appends (CoW fires then if it is shared)."""
        seq = self._seqs[seq_id]
        assert 0 <= length <= seq.length, (length, seq.length)
        keep = self.pages_needed(length)
        for p in seq.pages[keep:]:
            self._drop_ref(p)
        del seq.pages[keep:]
        seq.length = length

    def free_seq(self, seq_id: int):
        seq = self._seqs.pop(seq_id)
        for p in seq.pages:
            self._drop_ref(p)

    def seq_len(self, seq_id: int) -> int:
        return self._seqs[seq_id].length

    def block_table(self, seq_id: int) -> List[int]:
        return list(self._seqs[seq_id].pages)

    def block_table_array(self, seq_ids: Sequence[Optional[int]],
                          max_blocks: int):
        """Padded ``[len(seq_ids), max_blocks]`` int32 table; -1 = no page.
        ``None`` entries (idle slots) yield all -1 rows."""
        import numpy as np
        bt = np.full((len(seq_ids), max_blocks), -1, np.int32)
        for i, sid in enumerate(seq_ids):
            if sid is None or sid not in self._seqs:
                continue
            pages = self._seqs[sid].pages
            assert len(pages) <= max_blocks, (len(pages), max_blocks)
            bt[i, :len(pages)] = pages
        return bt

    # -- prefix cache --------------------------------------------------------
    @staticmethod
    def _chain(prev: bytes, page_tokens) -> bytes:
        """One link of the page hash chain: the digest commits to the full
        token history up to and including this page, so a digest match
        implies the whole prefix matches."""
        import numpy as np
        buf = np.ascontiguousarray(np.asarray(page_tokens, np.int64))
        return hashlib.sha256(prev + buf.tobytes()).digest()

    def hashable_prefix_tokens(self, num_tokens: int) -> int:
        """Longest prefix eligible for cache reuse: whole pages only, and
        strictly shorter than the prompt — the final prompt token is always
        recomputed because its logits seed decoding."""
        return self.page_size * ((num_tokens - 1) // self.page_size)

    def match_prefix(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest indexed prefix of ``tokens``. Returns ``(pages,
        n_cached_tokens)``; takes no references (read-only probe)."""
        limit = self.hashable_prefix_tokens(len(tokens))
        pages: List[int] = []
        h = b""
        for i in range(0, limit, self.page_size):
            h = self._chain(h, tokens[i:i + self.page_size])
            p = self._cached.get(h)
            if p is None:
                break
            pages.append(p)
        return pages, len(pages) * self.page_size

    def can_allocate_prefix(self, tokens: Sequence[int],
                            extra_tokens: int = 0) -> bool:
        """Admission gate for :meth:`allocate_prefix`: would a sequence of
        ``len(tokens) + extra_tokens`` fit, given the prefix pages a match
        would reuse?"""
        cached, _ = self.match_prefix(tokens)
        need = self.pages_needed(len(tokens) + extra_tokens) - len(cached)
        parked = sum(1 for p in cached if self._refcount[p] == 0)
        return need <= self._allocatable() - parked

    def allocate_prefix(self, seq_id: int,
                        tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Like :meth:`allocate` but reuses indexed pages covering the
        longest cached prefix of ``tokens``: matched pages take a refcount
        bump (parked ones are revived from the LRU) and only the suffix
        grabs fresh pages. Atomic on exhaustion. Returns ``(block_table,
        n_cached_tokens)`` — the caller prefills only ``tokens[n_cached:]``.
        """
        assert seq_id not in self._seqs, f"seq {seq_id} already allocated"
        cached, n_cached = self.match_prefix(tokens)
        need = self.pages_needed(len(tokens)) - len(cached)
        # matched parked pages are about to be revived — they no longer
        # count toward the evictable headroom fresh grabs can draw from
        parked = sum(1 for p in cached if self._refcount[p] == 0)
        if need > self._allocatable() - parked:
            raise PagePoolExhausted(
                f"need {need} pages, "
                f"{self._allocatable() - parked} allocatable")
        for p in cached:
            if self._refcount[p] == 0:
                self._lru.pop(p, None)      # revive before grabbing fresh
            self._refcount[p] += 1
        pages = cached + [self._grab_page() for _ in range(need)]
        self._seqs[seq_id] = _Seq(pages, len(tokens))
        self.stats.n_prefix_queries += 1
        self.stats.n_prefix_hits += len(cached)
        return list(pages), n_cached

    def commit_prefix(self, seq_id: int, tokens: Sequence[int]) -> int:
        """Index every full page of a freshly prefilled prompt so later
        requests can reuse it. Full pages are append-only (mutation goes
        through CoW or :meth:`_deindex`), so the digest stays truthful for
        the page's lifetime. Returns the number of pages newly indexed."""
        seq = self._seqs[seq_id]
        n_full = min(len(tokens), seq.length) // self.page_size
        h = b""
        added = 0
        for i in range(n_full):
            h = self._chain(h, tokens[i * self.page_size:
                                      (i + 1) * self.page_size])
            p = seq.pages[i]
            if self._page_hash[p] is not None or h in self._cached:
                continue        # already indexed (ours or a twin's page)
            self._cached[h] = p
            self._page_hash[p] = h
            added += 1
        return added

    def invalidate_prefix_cache(self):
        """Drop the entire index. Parked pages are truly freed; live
        (ref > 0) pages just lose their index entries — in-flight
        sequences keep their KV, which the batcher guarantees was
        produced under the current weights (invalidation happens *at*
        the weight swap, before any new admission)."""
        while self._lru:
            p, _ = self._lru.popitem(last=False)
            self._release_parked(p)
        self._cached.clear()
        self._page_hash = [None] * self.num_pages
        self.stats.n_prefix_invalidations += 1

    def set_weight_version(self, version: int):
        """Serve-side hook for RLHF weight updates: a version bump
        invalidates every cached prefix so stale KV is never matched."""
        if version != self.weight_version:
            self.weight_version = version
            self.invalidate_prefix_cache()

    def reclaimable_pages(self, seq_id: int) -> int:
        """Pages only this sequence references (refcount == 1) — what
        preempting it would actually return to the pool; shared prefix
        pages survive the victim."""
        return sum(1 for p in self._seqs[seq_id].pages
                   if self._refcount[p] == 1)

    # -- accounting ----------------------------------------------------------
    def used_token_slots(self) -> int:
        """Token slots actually holding KV (shared pages counted once)."""
        counted = set()
        total = 0
        for seq in self._seqs.values():
            for i, p in enumerate(seq.pages):
                if p in counted:
                    continue
                counted.add(p)
                full = (i + 1) * self.page_size <= seq.length
                total += self.page_size if full else \
                    seq.length - i * self.page_size
        return total

    def reserved_token_slots(self) -> int:
        return self.stats.pages_in_use * self.page_size

    def fragmentation_slots(self) -> int:
        """Internal fragmentation: reserved minus used token slots. Bounded
        by ``page_size - 1`` per live sequence. Parked prefix-cache pages
        are full of reusable KV, not waste — excluded."""
        return self.reserved_token_slots() - self.used_token_slots() \
            - len(self._lru) * self.page_size

    def reserved_bytes(self) -> int:
        return self.stats.pages_in_use * self.page_bytes

    def check_invariants(self):
        """Pool conservation + refcount sanity (used by property tests)."""
        assert len(self._free) + self.stats.pages_in_use == self.num_pages
        assert all(r >= 0 for r in self._refcount)
        held: Dict[int, int] = {}
        for seq in self._seqs.values():
            for p in seq.pages:
                held[p] = held.get(p, 0) + 1
        free = set(self._free)
        parked = set(self._lru)
        assert not free & parked
        for p, r in enumerate(self._refcount):
            assert held.get(p, 0) == r, (p, held.get(p, 0), r)
            # zero-ref pages are either free or parked in the prefix LRU
            assert (r == 0) == (p in free or p in parked)
        for p in parked:
            assert self._page_hash[p] is not None
        for h, p in self._cached.items():
            assert self._page_hash[p] == h

    def replay_into(self, allocator=None):
        """Replay the page event stream through the paper's caching-
        allocator simulator; returns the allocator for stats inspection."""
        if allocator is None:
            from repro_torch.core.allocator import CachingAllocator
            allocator = CachingAllocator()
        handles: Dict[int, int] = {}
        for op, vid, nbytes, _tag in self.events:
            if op == "alloc":
                handles[vid] = allocator.malloc(nbytes)
            else:
                allocator.free(handles.pop(vid))
        return allocator
