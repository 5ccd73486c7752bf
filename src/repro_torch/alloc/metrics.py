"""Fragmentation / utilization accounting shared by both allocators.

Metric definitions follow the paper §5.1:

  * active memory    — bytes held by blocks currently assigned to tensors
  * reserved memory  — bytes set aside from the device (segments + chunks)
  * utilization      — peak_active / peak_reserved
  * fragmentation    — 1 - utilization
  * MemReductionRatio = (sum(reserved) - sum(gmlake_reserved)) / sum(reserved)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class AllocatorStats:
    active_bytes: int = 0
    reserved_bytes: int = 0
    peak_active: int = 0
    peak_reserved: int = 0
    n_alloc: int = 0
    n_free: int = 0
    # timeline: (event index, active, reserved) triples for trace plots
    timeline: List[tuple] = field(default_factory=list)
    record_timeline: bool = False
    #: backend-specific diagnostic counters (e.g. GMLake's round-4 fast-path
    #: hit tallies: seg_reuse / hold_fast / shell_reuse). Never part of the
    #: golden digests — purely observability for the profile harness.
    counters: Optional[dict] = None
    #: GMLake round-5 vectorized-core counters (enabled / numpy_fallback /
    #: seg_cache_builds / ref_purges / ...). Same observability-only
    #: contract as ``counters``; surfaced via ``ReplayResult.vec_counters``.
    vec_counters: Optional[dict] = None

    def __post_init__(self) -> None:
        # on_alloc/on_free run once per replayed event; when no timeline is
        # recorded, bind the branch-free fast variants so the hot path never
        # re-tests record_timeline.
        if not self.record_timeline:
            self.on_alloc = self._on_alloc_fast
            self.on_free = self._on_free_fast

    def on_alloc(self, active_delta: int, reserved: int) -> None:
        self.n_alloc += 1
        self.active_bytes += active_delta
        self.reserved_bytes = reserved
        self.peak_active = max(self.peak_active, self.active_bytes)
        self.peak_reserved = max(self.peak_reserved, self.reserved_bytes)
        if self.record_timeline:
            self.timeline.append((self.n_alloc + self.n_free, self.active_bytes, reserved))

    def on_free(self, active_delta: int, reserved: int) -> None:
        self.n_free += 1
        self.active_bytes -= active_delta
        self.reserved_bytes = reserved
        if self.record_timeline:
            self.timeline.append((self.n_alloc + self.n_free, self.active_bytes, reserved))

    def _on_alloc_fast(self, active_delta: int, reserved: int) -> None:
        self.n_alloc += 1
        active = self.active_bytes + active_delta
        self.active_bytes = active
        self.reserved_bytes = reserved
        if active > self.peak_active:
            self.peak_active = active
        if reserved > self.peak_reserved:
            self.peak_reserved = reserved

    def _on_free_fast(self, active_delta: int, reserved: int) -> None:
        self.n_free += 1
        self.active_bytes -= active_delta
        self.reserved_bytes = reserved

    @property
    def utilization(self) -> float:
        if self.peak_reserved == 0:
            return 1.0
        return self.peak_active / self.peak_reserved

    @property
    def fragmentation(self) -> float:
        return 1.0 - self.utilization


@dataclass
class AllocatorEventLog:
    """Structured allocator event stream (recovery attempts, reclamation
    rungs, spills, injected-fault observations).

    Append-only observability: never part of the golden digests. Composite
    backends (GMLake's small pool, STAlloc's fallback) share the parent's
    log so one replay yields one coherent event stream, surfaced through
    ``ServeEngine.memory_report()`` / ``ReplayResult.recovery`` / the
    fault bench.
    """

    events: List[dict] = field(default_factory=list)
    counts: Dict[str, int] = field(default_factory=dict)

    def append(self, kind: str, **detail) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1
        ev = {"kind": kind}
        ev.update(detail)
        self.events.append(ev)

    def __len__(self) -> int:
        return len(self.events)

    def clear(self) -> None:
        """Drop accumulated events/counts *in place* — composite backends
        share one log object, so reassignment would silently fork the
        stream. The serving engine calls this on restore: post-restore
        memory reports describe the new life only."""
        self.events.clear()
        self.counts.clear()

    def summary(self) -> dict:
        return {"n_events": len(self.events), "counts": dict(self.counts)}


def mem_reduction_ratio(reserved: List[int], gmlake_reserved: List[int]) -> float:
    """Arithmetic-average memory reduction across workloads (paper §5.1)."""
    tot = sum(reserved)
    if tot == 0:
        return 0.0
    return (tot - sum(gmlake_reserved)) / tot


@dataclass
class ReplayResult:
    """One allocator x one trace."""

    name: str
    stats: AllocatorStats
    model_cost: float  # modeled device-API cost (cuMalloc units)
    wall_seconds: float  # host-side data-structure time, measured
    oom: bool = False
    oom_at_event: Optional[int] = None
    state_counts: Optional[dict] = None  # GMLake S1..S5 hit counts
    #: ``AllocatorEventLog.summary()`` when the backend logged recovery /
    #: reclamation events during the replay; None on a quiet run
    recovery: Optional[dict] = None
    #: snapshot of the backend's vectorized-core counters (GMLake round 5:
    #: enabled / numpy_fallback / seg_cache_builds / ref_purges / ...);
    #: None for backends without a vectorized core
    vec_counters: Optional[dict] = None
    #: planned-vs-spilled routing tallies of the hybrid backend
    #: (planned_allocs/planned_bytes/spilled_allocs/spilled_bytes);
    #: None for backends without a planned/spill split
    hybrid_counters: Optional[dict] = None

    @property
    def utilization(self) -> float:
        return self.stats.utilization

    @property
    def fragmentation(self) -> float:
        return self.stats.fragmentation

    @property
    def reserved_gb(self) -> float:
        return self.stats.peak_reserved / (1024**3)

    @property
    def active_gb(self) -> float:
        return self.stats.peak_active / (1024**3)
