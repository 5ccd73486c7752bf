"""The allocator protocol: the contract every backend implements.

The paper frames GMLake as one point in a design space of allocators —
native (cudaMalloc/cudaFree), caching/BFC (PyTorch), VMS-stitching
(GMLake) — and the repo grows that space further (spatio-temporal
planning, and whatever comes next: sharded pools, async reclamation,
elastic serving policies). This module pins down the one surface they all
share, so every consumer (trace replay, the arena, the serving engine,
the benchmarks) is written once against the protocol and picks a backend
by registry key.

The contract, exactly as the replay loop exercises it:

  * ``malloc(size) -> Allocation`` — raises ``AllocatorOOM`` when the
    request cannot be satisfied; never returns None.
  * ``free(alloc)`` — accepts exactly the ``Allocation`` objects this
    allocator's ``malloc`` produced (``Allocation.owner`` routes frees in
    composite allocators).
  * ``stats`` — an ``AllocatorStats`` updated on every malloc/free.
  * ``reserved_bytes`` — bytes currently set aside from the device.
  * ``release_cached() -> int`` — return cached-but-unused memory to the
    device; returns bytes released (0 when the backend caches nothing).
  * ``check_invariants()`` — validate internal structure (test/debug).
  * ``capabilities`` — an ``AllocatorCapabilities`` describing what the
    backend can do, so generic consumers branch on declared capability
    instead of isinstance checks.

Backends that plan from a profiled trace (``capabilities.planning``)
additionally implement ``prepare(trace)``; the replay harness calls it
once, outside the timed loop, before feeding events.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Protocol, runtime_checkable

if TYPE_CHECKING:  # imported for annotations only: no import cycle at runtime
    from .caching_allocator import Allocation
    from .metrics import AllocatorStats


@dataclass(frozen=True)
class AllocatorCapabilities:
    """What a backend can do, declared up front.

    Consumers branch on these instead of isinstance checks, so a new
    backend never requires touching replay/arena/bench code.
    """

    #: keeps freed memory reserved for reuse (anything but native)
    caching: bool = True
    #: can hand out physically non-contiguous blocks (VMS stitching);
    #: implies blocks carry ``extents`` for the stitch kernels
    stitching: bool = False
    #: plans placements from a profiled trace: ``prepare(trace)`` must be
    #: called before replay (the harness does, outside the timed loop)
    planning: bool = False
    #: exposes GMLake-style ``state_counts`` (Algorithm 1 S1–S5 tallies)
    state_counts: bool = False
    #: ``release_cached()`` can actually return memory to the device
    releases_cached: bool = False
    #: walks the staged OOM-recovery ladder (release cached -> evict
    #: StitchFree VA -> drain deferred unmaps -> bounded retry) instead of
    #: surfacing the first ``DeviceOOM``; auto-enabled under a
    #: fault-injecting device, opt-in (``recovery=True``) otherwise
    recovery: bool = False
    #: elastically inflates/deflates its device reservation with demand
    #: (eLLM-style): grows the arena under pressure and — the honesty
    #: contract pinned by the conformance suite — shrinks it back after
    #: sustained deflation, without an explicit ``release_cached()`` call
    elastic: bool = False


@runtime_checkable
class AllocatorProtocol(Protocol):
    """Structural type for allocation backends (see module docstring).

    ``runtime_checkable`` only verifies method presence, not signatures —
    the behavioural contract is pinned by the conformance suite in
    ``tests/test_alloc_protocol.py``, which every registered backend runs.
    """

    name: str

    @property
    def stats(self) -> "AllocatorStats": ...  # noqa: E704

    def malloc(self, size: int) -> "Allocation": ...  # noqa: E704

    def free(self, alloc: "Allocation") -> None: ...  # noqa: E704

    @property
    def reserved_bytes(self) -> int: ...  # noqa: E704

    def release_cached(self) -> int: ...  # noqa: E704

    def check_invariants(self) -> None: ...  # noqa: E704


__all__ = ["AllocatorCapabilities", "AllocatorProtocol"]
