"""Hybrid planner backend: stalloc statics + VMS stitching for the tail.

The two planning philosophies in this repo are complementary, not rival:

  * ``stalloc`` (offline planning) is unbeatable *on the profiled
    prefix* — a planned malloc is an array lookup against ONE upfront
    reservation — but everything the profile did not predict lands in a
    plain BFC pool, which is exactly the allocator whose fragmentation
    GMLake was built to fix;
  * ``gmlake`` (runtime stitching) serves anything, but pays its
    segment/stitching machinery on every event, profiled or not.

``hybrid`` composes them: profiled requests replay against a placement
plan built with the *packed* placer (size-ordered first-fit plus the
directed ruin-and-recreate polish — see ``stalloc._polish_packing``),
and the dynamic tail — divergent requests, capacity-budget spills,
anything after the plan runs out — is served by an embedded
``GMLakeAllocator`` core on the same device. The core shares this
backend's event log and recovery ladder (the same embedding pattern as
``ellm``'s elastic arenas), so one replay yields one event stream and
one staged-OOM story: a post-shrink reservation failure walks
release-cache → re-plan-to-capacity → bounded retries, and whatever the
re-plan demotes is absorbed by the stitching core instead of a BFC pool.

Routing is observable, never silent: ``hybrid_counters`` (planned vs
spilled events and bytes) ride through ``ReplayResult`` and
``ServeEngine.memory_report()``, and ``benchmarks/compare_replay.py``
gates on them — a regression that quietly routes the profiled prefix to
the spill path fails CI even if throughput looks plausible.
"""

from __future__ import annotations

from typing import Optional

from .caching_allocator import MIN_BLOCK_SIZE
from .chunks import VMMDevice
from .gmlake import GMLakeAllocator
from .protocol import AllocatorCapabilities
from .registry import register
from .stalloc import PlacementPlan, STAllocAllocator


@register(
    "hybrid",
    AllocatorCapabilities(
        caching=True,
        planning=True,
        state_counts=True,
        releases_cached=True,
        recovery=True,
    ),
)
class HybridAllocator(STAllocAllocator):
    """Planned placements for the profiled prefix, VMS stitching for the
    dynamic tail.

    Inherits the whole planned hot path (cursor match, lazy single
    reservation, re-entrant ``prepare``, re-plan recovery rung) from
    ``STAllocAllocator`` and swaps the fallback pool for an embedded
    ``GMLakeAllocator``. With no plan at all the backend degrades to the
    bare stitching core — digest-identical to ``gmlake`` by construction
    (pinned in ``tests/test_hybrid_planner.py``).
    """

    name = "hybrid"

    def __init__(
        self,
        device: VMMDevice,
        plan: Optional[PlacementPlan] = None,
        record_timeline: bool = False,
        granularity: int = MIN_BLOCK_SIZE,
        recovery: Optional[bool] = None,
        polish_iters: Optional[int] = None,
    ):
        #: packed-placer polish budget; ``None`` = the deterministic auto
        #: formula in ``stalloc._auto_polish_iters``. Set before the base
        #: ctor so ``_plan_opts`` is valid from the first ``prepare``.
        self.polish_iters = polish_iters
        super().__init__(
            device,
            plan=plan,
            record_timeline=record_timeline,
            granularity=granularity,
            recovery=recovery,
        )

    def _make_fallback(self):
        """The dynamic tail goes to a stitching core, not a BFC pool.

        Same embedding pattern as ``ellm``: construct the core, then adopt
        its event log so the planned path, the recovery ladder and the
        core all append to ONE stream.
        """
        core = GMLakeAllocator(self.device, recovery=self._recovery_on)
        self.core = core
        self.event_log = core.event_log
        return core

    def _plan_opts(self) -> dict:
        return {"packed": True, "polish_iters": self.polish_iters}

    # -- observability --------------------------------------------------------
    @property
    def hybrid_counters(self) -> dict:
        """Planned-vs-spilled routing tallies (diagnostics, not digest
        material; the compare_replay CI tier blocks on drift)."""
        return {
            "planned_allocs": self.planned_allocs,
            "planned_bytes": self.planned_bytes,
            "spilled_allocs": self.fallback_allocs,
            "spilled_bytes": self.fallback_bytes,
        }

    # -- delegation to the stitching core ------------------------------------
    @property
    def state_counts(self):
        return self.core.state_counts

    @property
    def vec_counters(self):
        return self.core.vec_counters

    @property
    def pending_unmaps(self) -> int:
        return self.core.pending_unmaps

    def drain_deferred_unmaps(self) -> int:
        return self.core.drain_deferred_unmaps()


__all__ = ["HybridAllocator"]
