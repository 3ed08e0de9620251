"""Caching-allocator simulator — the mechanistic model behind the paper.

Faithful to the PyTorch CUDA caching allocator (paper §2.2 / Appendix A):

  * two pools — small (< 1 MiB requests, 2 MiB segments) and large;
  * requests rounded to 512 B; large requests get dedicated segments
    (>= 20 MiB rounded to 2 MiB granularity);
  * freed blocks are cached in their pool, split on reuse, and coalesced
    with free neighbours within the same segment;
  * ``cudaMalloc`` (segment growth) happens only when no cached block fits —
    *reserved* grows; *allocated* tracks live tensor bytes;
  * external fragmentation is measured exactly as the paper does (§3):
    at each cudaMalloc, fragmentation = reserved - allocated at that moment,
    attributable to free blocks that could not serve the request;
  * ``empty_cache()`` releases every segment with no live block back to the
    driver (the paper's §3.3 mitigation).

In the reference the simulator is driven by the alloc/free event streams
of its jaxpr liveness tracer (`repro/core/trace.py`), one stream per RLHF
phase; in the port it replays the paged KV cache's page events
(``repro_torch.paged.page_manager.PageManager.replay_into``). A copy of
``repro/core/allocator.py``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

KB = 1024
MB = 1024 * KB

ROUND = 512
SMALL_REQUEST = 1 * MB
SMALL_SEGMENT = 2 * MB
LARGE_SEGMENT_MIN = 20 * MB


def _round_size(size: int) -> int:
    if size <= 0:
        return ROUND
    return -(-size // ROUND) * ROUND


def _segment_size(rounded: int) -> int:
    if rounded <= SMALL_REQUEST:
        return SMALL_SEGMENT
    if rounded < LARGE_SEGMENT_MIN:
        return LARGE_SEGMENT_MIN
    return -(-rounded // SMALL_SEGMENT) * SMALL_SEGMENT


@dataclass
class Block:
    segment: "Segment"
    offset: int
    size: int
    free: bool = True
    prev: Optional["Block"] = None
    next: Optional["Block"] = None


@dataclass
class Segment:
    sid: int
    size: int
    small: bool
    head: Block = None  # type: ignore

    def live_bytes(self) -> int:
        n, b = 0, self.head
        while b is not None:
            if not b.free:
                n += b.size
            b = b.next
        return n


@dataclass
class AllocatorStats:
    reserved: int = 0
    allocated: int = 0
    peak_reserved: int = 0
    peak_allocated: int = 0
    n_cuda_malloc: int = 0
    n_alloc: int = 0
    n_forced_flush: int = 0
    # fragmentation measured at each cudaMalloc (paper Appendix B)
    frag_at_peak: int = 0
    max_frag: int = 0


class CachingAllocator:
    """BFC-style caching allocator with small/large pools."""

    def __init__(self, timeline: bool = False,
                 capacity: Optional[int] = None):
        self.capacity = capacity        # device HBM size; None = unbounded
        self.segments: List[Segment] = []
        # free lists: (size, counter) -> Block, kept sorted for best-fit
        self._free_small: List[Tuple[int, int, Block]] = []
        self._free_large: List[Tuple[int, int, Block]] = []
        self._counter = 0
        self._handles: Dict[int, Block] = {}
        self._next_handle = 1
        self.stats = AllocatorStats()
        self._frag_at_last_grow = 0
        self.timeline_enabled = timeline
        self.timeline: List[Tuple[int, int, int]] = []   # (event#, reserved, allocated)
        self._events = 0

    # -- free-list helpers ---------------------------------------------------
    def _pool(self, small: bool):
        return self._free_small if small else self._free_large

    def _insert_free(self, block: Block):
        block.free = True
        self._counter += 1
        bisect.insort(self._pool(block.segment.small),
                      (block.size, self._counter, block))

    def _remove_free(self, block: Block):
        pool = self._pool(block.segment.small)
        i = bisect.bisect_left(pool, (block.size, -1, None))
        while i < len(pool):
            if pool[i][2] is block:
                pool.pop(i)
                return
            if pool[i][0] != block.size:
                break
            i += 1
        raise RuntimeError("free block not found in pool")

    def _tick(self):
        self._events += 1
        if self.timeline_enabled:
            self.timeline.append((self._events, self.stats.reserved,
                                  self.stats.allocated))

    # -- public API -----------------------------------------------------------
    def malloc(self, size: int) -> int:
        rounded = _round_size(size)
        small = rounded <= SMALL_REQUEST
        pool = self._pool(small)
        # best fit search (default CUDA allocator: any block >= request is
        # usable and the remainder is split back into the pool)
        i = bisect.bisect_left(pool, (rounded, -1, None))
        block = None
        if i < len(pool):
            block = pool[i][2]
            pool.pop(i)
        grew = False
        if block is None:
            # fragmentation measurement point (paper App. B): cached bytes
            # that could not serve this request
            frag = self.stats.reserved - self.stats.allocated
            self.stats.max_frag = max(self.stats.max_frag, frag)
            self._frag_at_last_grow = frag
            block = self._grow(rounded, small)
            grew = True
        # split
        remainder = block.size - rounded
        min_split = ROUND if small else MB
        if remainder >= min_split:
            tail = Block(block.segment, block.offset + rounded, remainder,
                         prev=block, next=block.next)
            if block.next is not None:
                block.next.prev = tail
            block.next = tail
            block.size = rounded
            self._insert_free(tail)
        block.free = False
        self.stats.allocated += block.size
        self.stats.n_alloc += 1
        if self.stats.allocated > self.stats.peak_allocated:
            self.stats.peak_allocated = self.stats.allocated
        if grew and self.stats.reserved > self.stats.peak_reserved:
            # frag at the growth that set the (new) reserved peak
            self.stats.peak_reserved = self.stats.reserved
            self.stats.frag_at_peak = self._frag_at_last_grow
        h = self._next_handle
        self._next_handle += 1
        self._handles[h] = block
        self._tick()
        return h

    def _grow(self, rounded: int, small: bool) -> Block:
        seg_size = _segment_size(rounded)
        if self.capacity is not None and \
                self.stats.reserved + seg_size > self.capacity:
            # real allocator's OOM fallback: release all cached blocks,
            # then retry the cudaMalloc (paper App. A)
            self.empty_cache()
            self.stats.n_forced_flush += 1
            if self.stats.reserved + seg_size > self.capacity:
                raise MemoryError(
                    f"simulated OOM: reserved {self.stats.reserved} + "
                    f"{seg_size} > capacity {self.capacity}")
        seg = Segment(len(self.segments), seg_size, small)
        blk = Block(seg, 0, seg_size)
        seg.head = blk
        self.segments.append(seg)
        self.stats.reserved += seg_size
        self.stats.n_cuda_malloc += 1
        return blk

    def free(self, handle: int):
        block = self._handles.pop(handle)
        assert not block.free
        self.stats.allocated -= block.size
        # coalesce with free neighbours
        if block.next is not None and block.next.free:
            nxt = block.next
            self._remove_free(nxt)
            block.size += nxt.size
            block.next = nxt.next
            if nxt.next is not None:
                nxt.next.prev = block
        if block.prev is not None and block.prev.free:
            prv = block.prev
            self._remove_free(prv)
            prv.size += block.size
            prv.next = block.next
            if block.next is not None:
                block.next.prev = prv
            block = prv
        self._insert_free(block)
        self._tick()

    def empty_cache(self) -> int:
        """Release every segment with no live blocks. Returns bytes freed."""
        released = 0
        keep: List[Segment] = []
        for seg in self.segments:
            if seg.live_bytes() == 0:
                b = seg.head
                while b is not None:
                    if b.free:
                        self._remove_free(b)
                    b = b.next
                released += seg.size
                self.stats.reserved -= seg.size
            else:
                keep.append(seg)
        self.segments = keep
        self._tick()
        return released

    # -- introspection ---------------------------------------------------------
    @property
    def reserved(self) -> int:
        return self.stats.reserved

    @property
    def allocated(self) -> int:
        return self.stats.allocated

    def fragmentation(self) -> int:
        return self.stats.reserved - self.stats.allocated

    def live_handles(self) -> int:
        return len(self._handles)
