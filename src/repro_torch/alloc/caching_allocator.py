"""PyTorch-style BFC caching allocator (the paper's baseline, §2.2 Fig. 2b).

Faithful to the CUDACachingAllocator mechanics that matter for fragmentation:

  * two pools — small (requests <= 1 MB, carved from 2 MB segments) and
    large (20 MB segments; requests > 10 MB get a dedicated rounded segment),
  * best-fit search over free blocks, splitting with a remainder block,
  * deallocation only flips the block free and coalesces with free
    neighbours (no device API calls),
  * on device OOM: release fully-free cached segments and retry.

Also provides ``NativeAllocator`` (cudaMalloc/cudaFree per request with a
device synchronization on free) used to reproduce the ~10x overhead claim.
"""

from __future__ import annotations

import itertools
from bisect import bisect_left, insort
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .chunks import MB, DeviceOOM, VMMDevice, round_up
from .metrics import AllocatorEventLog, AllocatorStats
from .protocol import AllocatorCapabilities
from .recovery import RecoveryConfig, recovery_enabled, run_ladder
from .registry import register

# PyTorch CUDACachingAllocator constants
MIN_BLOCK_SIZE = 512
SMALL_SIZE = 1 * MB
SMALL_BUFFER = 2 * MB
LARGE_BUFFER = 20 * MB
MIN_LARGE_ALLOC = 10 * MB
ROUND_LARGE = 2 * MB

_ids = itertools.count()


class AllocatorOOM(MemoryError):
    """Raised when an allocator cannot satisfy a request (GMLake state S5).

    Carries reserved/active/device-free context in the message so OOM points
    in replays are attributable; ``ReplayResult.oom_at_event`` pins where.
    """


class QuotaDenied(AllocatorOOM):
    """A tenant-local quota denial (ellm per-tenant arena quotas).

    Subclasses ``AllocatorOOM`` so generic admission control defers the
    request, but callers that distinguish it can react correctly: the
    denial is deterministic for the denied tenant and says nothing about
    device pressure — evicting or backpressuring *other* tenants cannot
    fix it, and retrying without a budget livelocks.
    """


@dataclass
class Segment:
    """One cudaMalloc'd region carved into blocks."""

    seg_id: int
    size: int
    pool: str  # 'small' | 'large'
    n_blocks: int = 1


class BFCBlock:
    __slots__ = ("block_id", "segment", "offset", "size", "allocated", "prev", "next")

    def __init__(self, segment: Segment, offset: int, size: int):
        self.block_id = next(_ids)
        self.segment = segment
        self.offset = offset
        self.size = size
        self.allocated = False
        self.prev: Optional[BFCBlock] = None
        self.next: Optional[BFCBlock] = None

    def sort_key(self):
        return (self.size, self.block_id)


@dataclass
class Allocation:
    """Handle returned by ``malloc``; opaque outside the allocator.

    ``block`` is a ``BFCBlock`` (caching pool), ``PBlock``/``SBlock``
    (GMLake), or a plain size (native). ``owner`` routes ``free`` back to
    the allocator that produced it — GMLake's embedded small pool relies on
    this to reclaim sub-2 MB requests.
    """

    req_size: int
    block_size: int
    block: object
    owner: object = None


@register(
    "caching",
    AllocatorCapabilities(caching=True, releases_cached=True, recovery=True),
)
class CachingAllocator:
    """BFC allocator over a ``VMMDevice`` (the paper's baseline, §2.2).

    The fragmentation mechanism under study: best-fit with splitting strands
    free bytes inside segments that can be neither coalesced (live
    neighbour) nor released (segment not fully free). GMLake embeds one of
    these as its sub-2 MB pool (paper §3.1), so the hot-path costs here are
    also on GMLake's small-request path.

    Free lists are (size, id)-sorted per pool with running free-byte
    counters and an incremental whole-segment-free table, so ``malloc``/
    ``free`` are O(log blocks) and ``release_cached`` is O(released).
    """

    name = "caching"

    def __init__(
        self,
        device: VMMDevice,
        record_timeline: bool = False,
        recovery: Optional[bool] = None,
        event_log: Optional[AllocatorEventLog] = None,
    ):
        self.device = device
        self.stats = AllocatorStats(record_timeline=record_timeline)
        # staged OOM recovery: auto-on under a fault-injecting device, else
        # opt-in; the composite parents (gmlake, stalloc) pass their own
        # event_log so one replay yields one coherent event stream
        self._recovery_on = recovery_enabled(device, recovery)
        self._recovery_cfg = RecoveryConfig()
        self.event_log = AllocatorEventLog() if event_log is None else event_log
        # free lists: pool -> sorted [(size, block_id, block)]
        self._free: Dict[str, List[tuple]] = {"small": [], "large": []}
        self._segments: Dict[int, Segment] = {}
        self._reserved = 0
        # running cached-free byte totals per pool (no scan needed to answer
        # "how much could release_cached reclaim / best-fit possibly cover")
        self._free_bytes: Dict[str, int] = {"small": 0, "large": 0}
        # seg_id -> block for free blocks spanning their whole segment; kept
        # in lockstep with the free lists so release_cached is O(released)
        self._releasable: Dict[str, Dict[int, BFCBlock]] = {"small": {}, "large": {}}

    # -- policy helpers -------------------------------------------------------
    @staticmethod
    def _round_size(size: int) -> int:
        return round_up(size, MIN_BLOCK_SIZE)

    @staticmethod
    def _pool_for(size: int) -> str:
        return "small" if size <= SMALL_SIZE else "large"

    @staticmethod
    def _segment_size(size: int) -> int:
        if size <= SMALL_SIZE:
            return SMALL_BUFFER
        if size < MIN_LARGE_ALLOC:
            return LARGE_BUFFER
        return round_up(size, ROUND_LARGE)

    @staticmethod
    def _should_split(pool: str, remaining: int) -> bool:
        if pool == "small":
            return remaining >= MIN_BLOCK_SIZE
        return remaining > SMALL_SIZE

    # -- free-list ops --------------------------------------------------------
    def _free_insert(self, block: BFCBlock) -> None:
        pool = block.segment.pool
        insort(self._free[pool], (block.size, block.block_id, block))
        self._free_bytes[pool] += block.size
        if block.prev is None and block.next is None:
            # the block spans its whole segment: a release_cached candidate.
            # Splitting never turns a prev/next into None and adjacent free
            # blocks always coalesce, so whole-segment status can only change
            # through this insert/remove pair.
            self._releasable[pool][block.segment.seg_id] = block

    def _free_remove(self, block: BFCBlock) -> None:
        pool = block.segment.pool
        lst = self._free[pool]
        i = bisect_left(lst, (block.size, block.block_id, block))
        assert i < len(lst) and lst[i][2] is block, "free-list corruption"
        lst.pop(i)
        self._free_bytes[pool] -= block.size
        self._releasable[pool].pop(block.segment.seg_id, None)

    def _find_best_fit(self, pool: str, size: int) -> Optional[BFCBlock]:
        lst = self._free[pool]
        i = bisect_left(lst, (size, -1, None))
        if i < len(lst):
            return lst[i][2]
        return None

    def cached_free_bytes(self, pool: Optional[str] = None) -> int:
        """Bytes sitting in free blocks (per pool, or total)."""
        if pool is not None:
            return self._free_bytes[pool]
        return sum(self._free_bytes.values())

    # -- segment management ---------------------------------------------------
    def _new_segment(self, size: int, pool: str) -> BFCBlock:
        seg = Segment(next(_ids), size, pool)
        self.device.cu_malloc(size)
        self._segments[seg.seg_id] = seg
        self._reserved += size
        return BFCBlock(seg, 0, size)

    def release_cached(self) -> int:
        """Free fully-free segments back to the device. Returns bytes freed.

        Incremental: walks only the maintained whole-segment-free table, not
        every free block, so the cost is O(segments released).
        """
        freed = 0
        for table in self._releasable.values():
            for block in list(table.values()):
                seg = block.segment
                self._free_remove(block)  # also clears the table entry
                self.device.cu_free(seg.size, synchronize=False)
                del self._segments[seg.seg_id]
                self._reserved -= seg.size
                freed += seg.size
        return freed

    # -- public API -----------------------------------------------------------
    def malloc(self, size: int) -> Allocation:
        """Best-fit malloc with splitting (PyTorch CUDACachingAllocator).

        O(log blocks): one bisect over the pool free list, one optional
        split. On device OOM, releases fully-free cached segments and
        retries once before raising ``AllocatorOOM``.
        """
        rsize = self._round_size(size)
        pool = self._pool_for(rsize)
        block = self._find_best_fit(pool, rsize)
        if block is None:
            seg_size = self._segment_size(rsize)
            if self._recovery_on:
                block = self._recover_segment(seg_size, pool, size)
            else:
                try:
                    block = self._new_segment(seg_size, pool)
                except DeviceOOM:
                    self.release_cached()
                    try:
                        block = self._new_segment(seg_size, pool)
                    except DeviceOOM as e:
                        raise AllocatorOOM(
                            f"caching allocator OOM for {size} bytes "
                            f"(reserved={self._reserved}, device_free={self.device.free_bytes})"
                        ) from e
        else:
            self._free_remove(block)

        remaining = block.size - rsize
        if self._should_split(pool, remaining):
            rest = BFCBlock(block.segment, block.offset + rsize, remaining)
            rest.prev, rest.next = block, block.next
            if block.next is not None:
                block.next.prev = rest
            block.next = rest
            block.size = rsize
            block.segment.n_blocks += 1
            self._free_insert(rest)

        block.allocated = True
        self.stats.on_alloc(block.size, self._reserved)
        return Allocation(req_size=size, block_size=block.size, block=block, owner=self)

    def _recover_segment(self, seg_size: int, pool: str, req_size: int) -> BFCBlock:
        """Recovery-mode segment reservation: release cached segments, then
        bounded backoff retries (clears transient fault bursts)."""
        try:
            return run_ladder(
                lambda: self._new_segment(seg_size, pool),
                [("release_cached", self.release_cached)],
                device=self.device,
                log=self.event_log,
                config=self._recovery_cfg,
                what=f"segment:{seg_size}",
            )
        except DeviceOOM as e:
            raise AllocatorOOM(
                f"caching allocator OOM for {req_size} bytes "
                f"(reserved={self._reserved}, device_free={self.device.free_bytes})"
            ) from e

    def free(self, alloc: Allocation) -> None:
        """Flip the block free and coalesce with free neighbours.

        No device API calls (the cache keeps the segment) — this is what
        makes the caching allocator ~10x cheaper than native free, and also
        what strands capacity (paper Fig. 1). O(log blocks) for the
        free-list reinserts.
        """
        block: BFCBlock = alloc.block
        assert block.allocated, "double free"
        block.allocated = False
        self.stats.on_free(alloc.block_size, self._reserved)
        # coalesce with free neighbours
        for neighbour in (block.prev, block.next):
            if neighbour is not None and not neighbour.allocated:
                self._free_remove(neighbour)
                if neighbour is block.prev:
                    neighbour.next = block.next
                    if block.next is not None:
                        block.next.prev = neighbour
                    neighbour.size += block.size
                    block = neighbour
                else:
                    block.next = neighbour.next
                    if neighbour.next is not None:
                        neighbour.next.prev = block
                    block.size += neighbour.size
                block.segment.n_blocks -= 1
        self._free_insert(block)

    @property
    def reserved_bytes(self) -> int:
        return self._reserved

    def check_invariants(self) -> None:
        """Debug: free lists consistent with block links + running counters."""
        for pool, lst in self._free.items():
            assert lst == sorted(lst), f"{pool} free list unsorted"
            whole = {}
            for size, bid, block in lst:
                assert not block.allocated and block.size == size
                if block.prev is None and block.next is None:
                    whole[block.segment.seg_id] = block
            assert self._free_bytes[pool] == sum(e[0] for e in lst)
            assert self._releasable[pool] == whole


@register("native", AllocatorCapabilities(caching=False))
class NativeAllocator:
    """cudaMalloc/cudaFree per request — the paper's native baseline (§2.2).

    Every free synchronizes the device (modeled as ``DEVICE_SYNC_COST``),
    which is where the ~10x end-to-end overhead against the caching
    allocator comes from. No pooling, no fragmentation beyond rounding.
    """

    name = "native"

    def __init__(self, device: VMMDevice, record_timeline: bool = False):
        self.device = device
        self.stats = AllocatorStats(record_timeline=record_timeline)
        self._reserved = 0

    def malloc(self, size: int) -> Allocation:
        rsize = round_up(size, MIN_BLOCK_SIZE)
        try:
            self.device.cu_malloc(rsize)
        except DeviceOOM as e:
            raise AllocatorOOM(f"native allocator OOM for {size} bytes") from e
        self._reserved += rsize
        self.stats.on_alloc(rsize, self._reserved)
        return Allocation(req_size=size, block_size=rsize, block=rsize, owner=self)

    def free(self, alloc: Allocation) -> None:
        self.device.cu_free(alloc.block_size, synchronize=True)
        self._reserved -= alloc.block_size
        self.stats.on_free(alloc.block_size, self._reserved)

    @property
    def reserved_bytes(self) -> int:
        return self._reserved

    def release_cached(self) -> int:
        """Nothing is ever cached: every free goes straight to the device."""
        return 0

    def check_invariants(self) -> None:
        assert self._reserved >= 0
        assert self.stats.active_bytes == self._reserved
