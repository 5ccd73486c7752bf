"""Online invariant sentinel: sampled safety checks with fault attribution.

Replay-time invariant checking (``replay(..., check_invariants_every=n)``)
tells you *that* a backend corrupted its books, but not *which* injected
fault did it — by the time the suite's drain assertions fire, the
triggering event is hundreds of operations in the past. The sentinel
closes that gap: the chaos campaign (and, optionally, the serving
simulator) ticks it once per event with a small event descriptor, it runs
the safety checks at a configurable cadence, and the **first** violation
is attributed to the most recent event descriptor seen — the tightest
attribution a sampling checker can honestly claim (the true trigger lies
between the previous clean check and this one).

Checks per sample (all mid-run safe for every registered backend):

  * ``allocator.check_invariants()`` — the backend's own structural
    audit (chunk refcounts, pool bitmaps, tenant attributions, ...);
  * ``active <= reserved`` — the stats ledger never claims more tensor
    bytes than the backend has set aside;
  * device/backend byte agreement — the device's mapped ``used_bytes``
    covers the backend's ``reserved_bytes`` (no phantom reservation).
    Mid-run the device may legitimately map *more* than the backend
    reports (native/stalloc/hybrid round sub-chunk requests up at the
    device), so the sampled check is one-sided; ``check_drained()`` runs
    the exact two-sided agreement (``used == reserved``, ``active == 0``)
    once everything has been freed.

Violations are recorded, not raised: a chaos campaign wants the full
violation census for its verdict, not a crash at the first one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Violation:
    """One failed safety check, attributed to the nearest known event."""

    check: str  # "check_invariants" | "active_le_reserved" | "device_agreement"
    detail: str
    tick: int  # sentinel tick count at detection
    event: Optional[dict] = None  # descriptor passed to the triggering tick

    def to_payload(self) -> dict:
        return {
            "check": self.check,
            "detail": self.detail,
            "tick": self.tick,
            "event": self.event,
        }


@dataclass
class InvariantSentinel:
    """Sampling safety checker bound to one (allocator, device) pair.

    ``every`` is the event cadence: ``tick()`` increments the event count
    and runs the checks on every ``every``-th call. ``check()`` forces a
    check regardless of cadence (campaigns call it right after each
    scheduled fault event, and once at drain).
    """

    allocator: object
    device: object = None
    every: int = 16
    ticks: int = 0
    checks_run: int = 0
    violations: List[Violation] = field(default_factory=list)
    _last_event: Optional[dict] = None

    def __post_init__(self) -> None:
        self.every = max(1, int(self.every))

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def first_violation(self) -> Optional[Violation]:
        return self.violations[0] if self.violations else None

    def tick(self, event: Optional[dict] = None) -> None:
        """Advance one event; run the checks at the configured cadence."""
        if event is not None:
            self._last_event = event
        self.ticks += 1
        if self.ticks % self.every == 0:
            self.check(event)

    def check(self, event: Optional[dict] = None) -> None:
        """Run every safety check now, attributing failures to ``event``
        (or the last event any tick saw)."""
        self.checks_run += 1
        ev = event if event is not None else self._last_event
        try:
            self.allocator.check_invariants()
        except AssertionError as exc:
            self._record("check_invariants", str(exc) or "assertion failed", ev)
        stats = getattr(self.allocator, "stats", None)
        reserved = getattr(self.allocator, "reserved_bytes", None)
        if stats is not None and reserved is not None:
            if stats.active_bytes > reserved:
                self._record(
                    "active_le_reserved",
                    f"active {stats.active_bytes} > reserved {reserved}",
                    ev,
                )
        if self.device is not None and reserved is not None:
            used = getattr(self.device, "used_bytes", None)
            if used is not None and used < reserved:
                self._record(
                    "device_agreement",
                    f"device used {used} < backend reserved {reserved}",
                    ev,
                )

    def check_drained(self, event: Optional[dict] = None) -> None:
        """Exact agreement at drain: everything freed, books closed."""
        self.check(event)
        ev = event if event is not None else self._last_event
        stats = getattr(self.allocator, "stats", None)
        if stats is not None and stats.active_bytes != 0:
            self._record(
                "drain_active_zero",
                f"active {stats.active_bytes} != 0 after drain",
                ev,
            )
        used = getattr(self.device, "used_bytes", None)
        reserved = getattr(self.allocator, "reserved_bytes", None)
        if used is not None and reserved is not None and used != reserved:
            self._record(
                "drain_device_agreement",
                f"device used {used} != backend reserved {reserved} at drain",
                ev,
            )

    def _record(self, check: str, detail: str, event: Optional[dict]) -> None:
        self.violations.append(
            Violation(check=check, detail=detail, tick=self.ticks, event=event)
        )

    def summary(self) -> dict:
        return {
            "ticks": self.ticks,
            "checks_run": self.checks_run,
            "n_violations": len(self.violations),
            "first_violation": (
                self.first_violation.to_payload()
                if self.first_violation
                else None
            ),
        }


__all__ = ["InvariantSentinel", "Violation"]
