"""eLLM-style elastic serving allocator (after arXiv 2506.15155).

Serving workloads breathe: admission waves inflate the KV working set,
drain phases deflate it, and weight-class tensors (model shards, large
activations) come and go with tenant churn. A caching allocator keeps the
high-water reservation forever; GMLake keeps its physical chunks on
purpose (Update semantics). The eLLM observation is that the *reservation
itself* should be elastic — grow the arena under admission pressure,
shrink it back when sustained deflation shows the pressure is gone — so a
multi-tenant device can hand unused memory to the next tenant instead of
hoarding it.

This backend composes that idea with the repo's VMS stitching layer:

  * **Elastic weight arena** — requests at or above ``weight_threshold``
    are placed best-fit inside a slab-quantized arena of classic
    contiguous segments (``cu_malloc``). Inflation reserves whole slabs;
    a deflation governor watches arena utilization on every free and,
    after ``deflate_patience`` consecutive low-utilization events,
    releases every trailing slab above the live watermark back to the
    device — no ``release_cached()`` call required. That is the
    ``capabilities.elastic`` honesty contract the conformance suite pins.
  * **VMS stitching core under pressure** — KV-sized requests (below the
    threshold) and any weight request the device cannot cover with a
    contiguous slab run spill to an embedded ``GMLakeAllocator``, whose
    stitching absorbs exactly the fragmentation that elastic inflation
    would otherwise trip over. The core shares this allocator's event
    log, so one serving run yields one recovery/fault stream.

Deflation policy is deterministic and independent of recovery mode, so
fault-free replay digests are bit-identical with recovery compiled in
(the same contract the other recovery-capable backends honour).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .caching_allocator import Allocation, AllocatorOOM, QuotaDenied
from .chunks import CHUNK_SIZE, MB, DeviceOOM, VMMDevice, round_up
from .gmlake import GMLakeAllocator
from .metrics import AllocatorStats
from .protocol import AllocatorCapabilities
from .recovery import RecoveryConfig, recovery_enabled, run_ladder
from .registry import register


class ElasticBlock:
    """One [offset, offset+size) placement inside the elastic weight arena."""

    __slots__ = ("offset", "size", "held", "tenant")

    def __init__(self, offset: int, size: int, tenant: Optional[str] = None):
        self.offset = offset
        self.size = size
        self.held = True  # flipped by free; guards double-free
        self.tenant = tenant  # quota attribution (None = unattributed)

    def __repr__(self):
        return f"ElasticBlock(off={self.offset}, size={self.size >> 20}MB)"


@register(
    "ellm",
    AllocatorCapabilities(
        caching=True,
        stitching=False,  # weight blocks are segment-backed: no extents
        state_counts=True,
        releases_cached=True,
        recovery=True,
        elastic=True,
    ),
)
class ELLMAllocator:
    """Elastic weight arena over a VMS stitching core (module docstring).

    Public surface is the standard protocol plus ``elastic_counters``
    (inflate/deflate/spill tallies, diagnostics only — not digest
    material) and delegated ``state_counts``/``pending_unmaps`` from the
    stitching core so engine memory reports stay uniform across backends.
    """

    name = "ellm"

    #: Reservation quantum of the weight arena. Slab-sized cu_malloc keeps
    #: inflation cheap on the modeled-cost ledger (one call per slab run)
    #: and gives deflation a natural release unit.
    SLAB_BYTES = 32 * MB

    #: Requests at or above this route to the elastic arena; below it they
    #: are KV/dynamic-tail traffic for the stitching core. Two chunks is
    #: the empirical sweet spot on the recorded serving traces: anything
    #: larger packs tighter (and cheaper on the API ledger) as best-fit
    #: spans inside the arena than as stitched chunk lists, while
    #: single-chunk KV churn keeps the stitching core's reuse states hot.
    WEIGHT_THRESHOLD = 2 * CHUNK_SIZE

    #: Deflation governor: after ``DEFLATE_PATIENCE`` consecutive frees
    #: with arena utilization under ``DEFLATE_RATIO``, trailing free slabs
    #: are returned to the device.
    DEFLATE_RATIO = 0.5
    DEFLATE_PATIENCE = 16

    def __init__(
        self,
        device: VMMDevice,
        record_timeline: bool = False,
        recovery: Optional[bool] = None,
        slab_bytes: int = SLAB_BYTES,
        weight_threshold: int = WEIGHT_THRESHOLD,
        deflate_ratio: float = DEFLATE_RATIO,
        deflate_patience: int = DEFLATE_PATIENCE,
        tenant_quota_bytes: Optional[int] = None,
    ):
        if slab_bytes % CHUNK_SIZE:
            raise ValueError("slab_bytes must be a multiple of CHUNK_SIZE")
        self.device = device
        self.stats = AllocatorStats(record_timeline=record_timeline)
        self.slab_bytes = slab_bytes
        self.weight_threshold = weight_threshold
        self.deflate_ratio = deflate_ratio
        self.deflate_patience = deflate_patience

        self._recovery_on = recovery_enabled(device, recovery)
        self._recovery_cfg = RecoveryConfig()
        # the stitching core absorbs KV traffic and weight spills; adopting
        # its event log (shared with its small pool) keeps one stream
        self.core = GMLakeAllocator(device, recovery=self._recovery_on)
        self.event_log = self.core.event_log

        # elastic arena state: free spans tile [0, _top) together with the
        # live blocks; _arena_reserved is the slab-quantized device hold
        self._spans: List[List[int]] = []  # [offset, size], offset-ascending
        self._top = 0  # end of the highest live placement
        self._arena_reserved = 0
        self._arena_live = 0
        self._deflate_streak = 0
        # per-tenant arena quotas (multi-tenant isolation): while a tenant
        # context is set, its live arena bytes may not exceed the quota —
        # the over-quota request fails as AllocatorOOM (admission control
        # defers the *bursting* tenant) instead of inflating the shared
        # arena and starving everyone else's slabs. None = quotas off,
        # which keeps single-tenant behaviour (and digests) bit-identical.
        self.tenant_quota_bytes = tenant_quota_bytes
        self._tenant: Optional[str] = None
        self._tenant_arena_live: Dict[str, int] = {}
        # pressure bypass valve: set when a core-side OOM had to reclaim
        # arena slabs — from then on weight-class requests route through
        # the stitching core (which can assemble scattered chunks) so the
        # arena drains instead of re-pinning its watermark with fresh
        # placements. Cleared, with the arena released wholesale, when the
        # last elastic block frees. Only ever set on an OOM path, so
        # fault-free digests are untouched.
        self._pressure_bypass = False
        # slab indices inside the arena extent given back to the device
        # while the valve is open (interior holes). Only ever populated
        # during bypass — no new placement can land in a hole before the
        # drain completes and resets the arena.
        self._hole_slabs: set = set()
        self.elastic_counters: Dict[str, int] = {
            "inflate": 0,
            "inflated_bytes": 0,
            "deflate": 0,
            "deflated_bytes": 0,
            "spill": 0,
            "quota_denied": 0,
            "bypass": 0,
        }

    # -- accounting -----------------------------------------------------------
    @property
    def reserved_bytes(self) -> int:
        holes = len(self._hole_slabs) * self.slab_bytes
        return self._arena_reserved - holes + self.core.reserved_bytes

    @property
    def state_counts(self) -> Dict[str, int]:
        """BestFit S1–S5 tallies of the stitching core."""
        return self.core.state_counts

    @property
    def pending_unmaps(self) -> int:
        return self.core.pending_unmaps

    def drain_deferred_unmaps(self) -> int:
        return self.core.drain_deferred_unmaps()

    def release_cached(self) -> int:
        """Trailing free slabs of the arena + whatever the core can drop."""
        return self._release_trailing_slabs() + self.core.release_cached()

    # -- tenant attribution ---------------------------------------------------
    def set_tenant(self, tenant: Optional[str] = None) -> None:
        """Set (or clear) the tenant context for subsequent arena mallocs.

        Serving integrations call this around each request's allocations;
        trace replays never do, so the quota layer is invisible there.
        """
        self._tenant = tenant or None

    @property
    def tenant_arena_bytes(self) -> Dict[str, int]:
        """Live arena bytes per attributed tenant (diagnostics)."""
        return {t: b for t, b in sorted(self._tenant_arena_live.items()) if b}

    def _quota_admits(self, rsize: int) -> bool:
        if self.tenant_quota_bytes is None or self._tenant is None:
            return True
        used = self._tenant_arena_live.get(self._tenant, 0)
        return used + rsize <= self.tenant_quota_bytes

    # -- elastic arena placement ----------------------------------------------
    def _span_alloc(self, size: int) -> Optional[int]:
        """Best-fit over free spans, else the top watermark if reserved
        space covers it; None means the arena must inflate."""
        best = -1
        best_size = 0
        for i, (off, sz) in enumerate(self._spans):
            if sz >= size and (best < 0 or sz < best_size):
                best = i
                best_size = sz
                if sz == size:
                    break
        if best >= 0:
            off, sz = self._spans[best]
            if sz == size:
                self._spans.pop(best)
            else:
                self._spans[best] = [off + size, sz - size]
            return off
        if self._top + size <= self._arena_reserved:
            off = self._top
            self._top += size
            return off
        return None

    def _span_free(self, offset: int, size: int) -> None:
        spans = self._spans
        lo, hi = 0, len(spans)
        while lo < hi:  # insertion point by offset
            mid = (lo + hi) // 2
            if spans[mid][0] < offset:
                lo = mid + 1
            else:
                hi = mid
        if lo > 0 and spans[lo - 1][0] + spans[lo - 1][1] == offset:
            spans[lo - 1][1] += size
            if lo < len(spans) and offset + size == spans[lo][0]:
                spans[lo - 1][1] += spans[lo][1]
                spans.pop(lo)
            lo -= 1
        elif lo < len(spans) and offset + size == spans[lo][0]:
            spans[lo][0] = offset
            spans[lo][1] += size
        else:
            spans.insert(lo, [offset, size])
        # a span touching the watermark retracts it
        last = spans[-1]
        if last[0] + last[1] == self._top:
            self._top = last[0]
            spans.pop()

    def _inflate(self, need: int) -> bool:
        """Reserve ``need`` more arena bytes (slab-quantized by callers).
        False means the device cannot cover it — spill to the core."""
        attempt = lambda: self.device.cu_malloc(need)  # noqa: E731
        try:
            if self._recovery_on:
                run_ladder(
                    attempt,
                    [("release_core_cache", self.core.release_cached)],
                    device=self.device,
                    log=self.event_log,
                    config=self._recovery_cfg,
                    what=f"inflate:{need}",
                )
            else:
                attempt()
        except DeviceOOM:
            return False
        self._arena_reserved += need
        self.elastic_counters["inflate"] += 1
        self.elastic_counters["inflated_bytes"] += need
        return True

    def _release_trailing_slabs(self) -> int:
        """Deflate: return every whole free slab above the live watermark.

        Hole slabs in the trailing region were already given back to the
        device (bypass-mode interior release), so they shrink the extent
        without a second ``cu_free``."""
        keep = round_up(self._top, self.slab_bytes) if self._top else 0
        holes_above = {
            i for i in self._hole_slabs if i * self.slab_bytes >= keep
        }
        excess = (
            self._arena_reserved - keep - len(holes_above) * self.slab_bytes
        )
        if excess <= 0:
            if holes_above:
                self._hole_slabs -= holes_above
                self._arena_reserved = keep
            return 0
        self.device.cu_free(excess, synchronize=False)
        self._hole_slabs -= holes_above
        self._arena_reserved = keep
        self.elastic_counters["deflate"] += 1
        self.elastic_counters["deflated_bytes"] += excess
        return excess

    def _release_free_slabs(self) -> int:
        """Bypass-only interior deflate: give back every whole free slab
        *inside* the arena extent, not just the trailing ones.

        Safe only while the valve is open — no new placement can be
        handed out from the arena, so a hole can never be written to
        before the drain completes and the arena resets. This is what
        unsticks a high watermark pinned by one long-lived block: the
        free slabs below it return to the device for the stitching core
        to reuse."""
        assert self._pressure_bypass, "interior release outside bypass"
        slab = self.slab_bytes
        new = set()
        for off, sz in self._spans:
            first = (off + slab - 1) // slab
            last = (off + sz) // slab  # exclusive: whole slabs only
            for i in range(first, last):
                if i not in self._hole_slabs:
                    new.add(i)
        if not new:
            return 0
        freed = len(new) * slab
        self.device.cu_free(freed, synchronize=False)
        self._hole_slabs |= new
        self.elastic_counters["deflate"] += 1
        self.elastic_counters["deflated_bytes"] += freed
        return freed

    def _deflate_tick(self) -> None:
        """Governor: sustained low utilization releases trailing slabs."""
        if self._arena_live < int(self.deflate_ratio * self._arena_reserved):
            self._deflate_streak += 1
            if self._deflate_streak >= self.deflate_patience:
                self._release_trailing_slabs()
                self._deflate_streak = 0
        else:
            self._deflate_streak = 0

    # -- allocation -----------------------------------------------------------
    def malloc(self, size: int) -> Allocation:
        if size >= self.weight_threshold and not self._pressure_bypass:
            return self._malloc_elastic(size)
        return self._core_malloc(size)

    def _malloc_elastic(self, size: int) -> Allocation:
        rsize = round_up(size, CHUNK_SIZE)
        if not self._quota_admits(rsize):
            # isolation: the bursting tenant is the one denied; everyone
            # else's slabs (and the shared core) are untouched. QuotaDenied
            # (an AllocatorOOM) lets admission control defer the request
            # while telling eviction/retry logic the denial is tenant-local
            # and deterministic — device-side recovery cannot fix it.
            self.elastic_counters["quota_denied"] += 1
            raise QuotaDenied(
                f"ellm tenant quota: {self._tenant!r} at "
                f"{self._tenant_arena_live.get(self._tenant, 0)} of "
                f"{self.tenant_quota_bytes} arena bytes, wants {rsize} more"
            )
        off = self._span_alloc(rsize)
        if off is None:
            need = round_up(
                self._top + rsize - self._arena_reserved, self.slab_bytes
            )
            if self._inflate(need):
                off = self._span_alloc(rsize)
                assert off is not None
            else:
                # pressure spill: contiguous slabs are not available, but
                # the stitching core can assemble the block from scattered
                # physical chunks — the GMLake move, applied to elasticity
                self.elastic_counters["spill"] += 1
                return self._core_malloc(size)
        self._arena_live += rsize
        tenant = self._tenant
        if tenant is not None:
            self._tenant_arena_live[tenant] = (
                self._tenant_arena_live.get(tenant, 0) + rsize
            )
        self.stats.on_alloc(rsize, self.reserved_bytes)
        return Allocation(
            req_size=size, block_size=rsize,
            block=ElasticBlock(off, rsize, tenant), owner=self,
        )

    def _core_malloc(self, size: int) -> Allocation:
        try:
            alloc = self.core.malloc(size)  # AllocatorOOM, never DeviceOOM
        except AllocatorOOM:
            # cross-component reclaim: the core's recovery ladder cannot
            # see the arena, so a KV-side OOM with free slabs parked above
            # the arena watermark would fail while memory sits idle.
            # Force-deflate the trailing slabs and open the pressure
            # bypass valve (the arena drains instead of ratcheting), then
            # retry once; fault-free runs never reach this branch, so
            # digests are untouched.
            if not self._pressure_bypass and (
                self._arena_reserved or self._arena_live
            ):
                self._pressure_bypass = True
                self.elastic_counters["bypass"] += 1
            freed = self._release_trailing_slabs()
            if self._pressure_bypass:
                freed += self._release_free_slabs()
            if not freed:
                raise
            self.event_log.append("reclaim.deflate_arena", size=freed)
            alloc = self.core.malloc(size)
        alloc.owner = self
        # the core already counted itself; ours is the published stats
        self.stats.on_alloc(alloc.block_size, self.reserved_bytes)
        return alloc

    def free(self, alloc: Allocation) -> None:
        block = alloc.block
        if isinstance(block, ElasticBlock):
            assert block.held, "double free of elastic block"
            block.held = False
            self._span_free(block.offset, block.size)
            self._arena_live -= block.size
            if block.tenant is not None:
                self._tenant_arena_live[block.tenant] -= block.size
            if self._pressure_bypass and self._arena_live == 0:
                # drained under pressure: give the whole arena back (the
                # watermark retracted to zero with the last free) and
                # resume elastic placement from a clean slate
                self._release_trailing_slabs()
                self._pressure_bypass = False
        else:
            self.core.free(alloc)
        self._deflate_tick()
        self.stats.on_free(alloc.block_size, self.reserved_bytes)

    # -- debug / test support -------------------------------------------------
    def check_invariants(self) -> None:
        holes = len(self._hole_slabs) * self.slab_bytes
        assert 0 <= self._arena_live <= self._arena_reserved - holes
        assert self._arena_reserved % self.slab_bytes == 0
        assert self._top <= self._arena_reserved
        assert not self._hole_slabs or self._pressure_bypass, (
            "interior holes outside pressure bypass"
        )
        assert all(
            0 <= i * self.slab_bytes < self._arena_reserved
            for i in self._hole_slabs
        )
        prev_end = 0
        span_bytes = 0
        for off, sz in self._spans:
            assert sz > 0 and off >= prev_end, "spans unsorted or overlapping"
            prev_end = off + sz
            span_bytes += sz
        assert prev_end <= self._top
        assert span_bytes + self._arena_live == self._top, (
            "arena accounting leak: spans + live != watermark"
        )
        for tenant, used in self._tenant_arena_live.items():
            assert used >= 0, f"negative arena attribution for {tenant!r}"
        assert sum(self._tenant_arena_live.values()) <= self._arena_live, (
            "tenant attribution exceeds live arena bytes"
        )
        self.core.check_invariants()


__all__ = ["ELLMAllocator", "ElasticBlock"]
