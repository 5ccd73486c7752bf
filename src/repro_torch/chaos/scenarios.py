"""Deterministic chaos scenarios, composed from preemption traces.

Each scenario is a named, seed-stable bundle of ``PreemptionEvent``s plus
the workload knobs the campaign runner needs (replay capacity, serving
load shape, SLO floors). The events compile to a ``FaultSchedule`` via
``FaultSchedule.from_preemption_trace`` at run time — the same scenario
yields a capacity-scaled schedule for a 2 GB replay leg and an 8 GB
serving leg without re-tuning.

The standard campaign mirrors the fault taxonomy the robustness roadmap
item names:

  * ``spot_revocation``   — a spot-style revocation with warning lead
    time: a brownout window (the provider's slowdown signal) precedes a
    capacity shrink plus a transient-failure burst;
  * ``capacity_storm``    — correlated capacity-loss events in quick
    succession (a rack losing lanes, neighbors landing on the device);
  * ``transient_flurry``  — windows of elevated transient fault
    probability on create/map/release paths, no capacity loss;
  * ``brownout``          — slow-device windows only: nothing fails, the
    cost model degrades (catches pacing/timeout-style regressions);
  * ``sustained_pressure``— serving-only: mild capacity loss on top of a
    memory-bound load, the regime the graceful-degradation layer must
    absorb (interactive SLO floor, no interactive preemption).

Severities are sized so revocation failure bursts stay within one
recovery-ladder run (burst = severity x 24 vs ~10 ladder re-attempts):
the campaign's baseline contract is *zero unrecovered faults*, and a
burst no ladder could absorb would test the shedding path instead — that
regime is exercised separately by the kill/recover engine scenario.
"""

from __future__ import annotations

import pathlib
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from ..alloc import GB, MB, FaultSchedule, PreemptionEvent, load_preemption_trace

#: the small checked-in preemption trace (format ``repro.preemption.v1``)
#: the default campaign replays alongside the synthetic scenarios
DEFAULT_TRACE_PATH = (
    pathlib.Path(__file__).resolve().parents[3]
    / "tests" / "data" / "preemption.trace.json"
)


@dataclass(frozen=True)
class ChaosScenario:
    """One named fault scenario + the workload shape it runs against."""

    name: str
    description: str
    events: Tuple[PreemptionEvent, ...]
    seed: int = 0
    #: replay leg (synthetic inference trace over a fault-injected device)
    replay: bool = True
    replay_capacity_bytes: int = 2 * GB
    #: serving leg (ServingSimulator with the degradation layer on)
    serving: bool = True
    serving_capacity_bytes: int = 8 * GB
    duration_steps: int = 160
    arrivals_per_step: float = 3.0
    #: per-SLO-class attainment floors the serving leg must clear
    slo_floors: Tuple[Tuple[str, float], ...] = ()
    #: when False, any interactive-class preemption fails the verdict
    interactive_preemption_ok: bool = True

    def schedule(self, capacity_bytes: int, **overrides) -> FaultSchedule:
        return FaultSchedule.from_preemption_trace(
            self.events,
            capacity_bytes=capacity_bytes,
            seed=self.seed,
            **overrides,
        )

    def describe(self) -> dict:
        return {
            "name": self.name,
            "description": self.description,
            "n_events": len(self.events),
            "seed": self.seed,
            "modes": [m for m, on in (("replay", self.replay),
                                      ("serving", self.serving)) if on],
        }


def spot_revocation(seed: int = 0) -> ChaosScenario:
    """Spot-style revocation with warning lead time (brownout heads-up,
    then a quarter-capacity shrink + absorbable failure burst)."""
    return ChaosScenario(
        name="spot_revocation",
        description="warned revocation: brownout lead, then shrink + burst",
        events=(
            PreemptionEvent(at=48, kind="revocation", severity=0.25,
                            duration=10, lead=12),
        ),
        seed=seed,
    )


def capacity_storm(seed: int = 0) -> ChaosScenario:
    """Correlated capacity-loss events in quick succession."""
    return ChaosScenario(
        name="capacity_storm",
        description="three correlated capacity losses inside 30 calls",
        events=(
            PreemptionEvent(at=40, kind="capacity_loss", severity=0.12),
            PreemptionEvent(at=52, kind="capacity_loss", severity=0.10),
            PreemptionEvent(at=68, kind="capacity_loss", severity=0.08),
        ),
        seed=seed,
    )


def transient_flurry(seed: int = 0) -> ChaosScenario:
    """Elevated transient-fault probability windows on create/map/release."""
    return ChaosScenario(
        name="transient_flurry",
        description="two transient-fault windows, no capacity loss",
        events=(
            PreemptionEvent(at=24, kind="transient", severity=0.35,
                            duration=30),
            PreemptionEvent(at=90, kind="transient", severity=0.55,
                            duration=20),
        ),
        seed=seed,
    )


def brownout(seed: int = 0) -> ChaosScenario:
    """Slow-device windows only; behavior must not change, only cost."""
    return ChaosScenario(
        name="brownout",
        description="slow-device windows (cost-model degradation only)",
        events=(
            PreemptionEvent(at=16, kind="brownout", severity=0.6,
                            duration=40),
            PreemptionEvent(at=100, kind="brownout", severity=0.9,
                            duration=24),
        ),
        seed=seed,
    )


def sustained_pressure(seed: int = 0) -> ChaosScenario:
    """Serving-only: memory-bound load + mild capacity loss. The
    degradation layer must keep interactive attainment >= 0.99, shed into
    the batch class, and never preempt an interactive request."""
    return ChaosScenario(
        name="sustained_pressure",
        description="memory-bound serving load; degradation must absorb",
        events=(
            PreemptionEvent(at=200, kind="capacity_loss", severity=0.05),
            PreemptionEvent(at=600, kind="transient", severity=0.15,
                            duration=60),
        ),
        seed=seed,
        replay=False,
        serving_capacity_bytes=1 * GB,
        duration_steps=400,
        arrivals_per_step=4.0,
        slo_floors=(("interactive", 0.99),),
        interactive_preemption_ok=False,
    )


def from_trace_file(path=None, seed: int = 0) -> ChaosScenario:
    """Scenario replaying the checked-in preemption trace verbatim."""
    p = pathlib.Path(path) if path is not None else DEFAULT_TRACE_PATH
    events = tuple(load_preemption_trace(p))
    return ChaosScenario(
        name="preemption_trace",
        description=f"checked-in preemption trace ({p.name})",
        events=events,
        seed=seed,
    )


def standard_campaign() -> Tuple[ChaosScenario, ...]:
    """The default scenario set (every fault kind + the checked-in trace).

    The simulated legs are all host-milliseconds cheap, so there is no
    trimmed variant here — ``fast`` mode in the campaign runner skips the
    jax-backed kill/recover engine leg instead.
    """
    return (
        spot_revocation(),
        capacity_storm(),
        transient_flurry(),
        brownout(),
        from_trace_file(),
        sustained_pressure(),
    )


__all__ = [
    "ChaosScenario",
    "DEFAULT_TRACE_PATH",
    "spot_revocation",
    "capacity_storm",
    "transient_flurry",
    "brownout",
    "sustained_pressure",
    "from_trace_file",
    "standard_campaign",
]
