"""Chaos campaign runner: scenarios x backends x modes -> verdicts.

A campaign drives every registered backend through every scenario in
three modes and renders a structured verdict per leg:

  * ``replay``  — a synthetic KV-churn trace over a fault-injected
    device, advanced by a manual per-event loop so the online
    ``InvariantSentinel`` can attribute the first violation to the
    triggering event (the library ``replay()`` loop only samples
    ``check_invariants``, without attribution);
  * ``serving`` — the multi-tenant ``ServingSimulator`` with the
    graceful-degradation layer on, over the same injected schedule,
    sentinel ticked once per simulated step;
  * ``engine``  — the jax-backed kill/recover scenario (checkpointed
    ``ServeEngine`` under a revocation-style burst) for the backends
    with calibrated fault points; skipped in ``fast`` mode.

Verdict axes, per leg:

  * **liveness** — the leg ran to completion and every unit of work is
    finished *or accounted for* (replay: denied allocations are counted
    OOM-accounted; serving: arrivals = finished + dropped + reported
    unfinished; engine: drained with all requests finished);
  * **safety**  — no raw ``DeviceOOM`` escaped a backend (transient or
    not, backends must convert to ``AllocatorOOM``), zero sentinel
    violations including the exact drain agreement (no leak at drain),
    and — on replay legs, whose schedules are sized ladder-absorbable —
    zero unrecovered faults on recovery-capable backends (serving legs
    are deliberately memory-bound: there capacity OOMs exhaust the
    ladder by design and are absorbed by the degradation layer);
  * **quality** — scenario-specific SLO floors (per-class attainment,
    interactive-preemption bans) on serving legs; engine legs must have
    actually exercised a restore (``restarts >= 1``).

Everything is seed-stable: same campaign config, same verdicts.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..alloc import (
    GB,
    MB,
    AllocatorOOM,
    DeviceOOM,
    FaultInjector,
    VMMDevice,
    registry,
)
from ..core.trace import ALLOC, FREE, ModelDesc, inference_trace
from ..serve.loadgen import LoadGenConfig, generate
from ..serve.simulate import ServingSimulator, SimConfig
from .scenarios import ChaosScenario, standard_campaign
from .sentinel import InvariantSentinel

#: backends with a calibrated kill/recover fault point (see
#: ``serve.killrecover.KillRecoverConfig.for_backend``); native is the
#: no-recovery baseline and has no restore path to exercise
ENGINE_BACKENDS = ("gmlake", "caching", "ellm", "hybrid")

_REPLAY_MODEL = ModelDesc(
    "chaos-tiny", n_layers=4, d_model=1024, n_heads=16, n_kv=4,
    d_ff=4096, vocab=32000,
)


def _replay_workload():
    """The KV-churn trace every replay leg runs (seed-fixed)."""
    return inference_trace(_REPLAY_MODEL, n_requests=48, max_new=32, seed=5)


@dataclass
class CampaignConfig:
    """Campaign shape. Defaults run the standard scenario set against
    every registered backend."""

    backends: Tuple[str, ...] = ()
    scenarios: Tuple[ChaosScenario, ...] = ()
    sentinel_every: int = 8
    #: skip the jax-backed engine leg (CI smoke / unit tests)
    fast: bool = False

    def resolved_backends(self) -> Tuple[str, ...]:
        return self.backends or tuple(registry.names())

    def resolved_scenarios(self) -> Tuple[ChaosScenario, ...]:
        return self.scenarios or standard_campaign()


@dataclass
class LegVerdict:
    """One (scenario, backend, mode) outcome."""

    scenario: str
    backend: str
    mode: str  # "replay" | "serving" | "engine"
    liveness: bool
    safety: bool
    quality: bool
    detail: Dict[str, object] = field(default_factory=dict)
    sentinel: Optional[dict] = None

    @property
    def ok(self) -> bool:
        return self.liveness and self.safety and self.quality

    def to_payload(self) -> dict:
        return {
            "scenario": self.scenario,
            "backend": self.backend,
            "mode": self.mode,
            "ok": self.ok,
            "liveness": self.liveness,
            "safety": self.safety,
            "quality": self.quality,
            "sentinel": self.sentinel,
            "detail": self.detail,
        }


@dataclass
class CampaignResult:
    verdicts: List[LegVerdict]
    wall_seconds: float

    @property
    def ok(self) -> bool:
        return all(v.ok for v in self.verdicts)

    def failures(self) -> List[LegVerdict]:
        return [v for v in self.verdicts if not v.ok]

    def to_payload(self) -> dict:
        n_violations = sum(
            (v.sentinel or {}).get("n_violations", 0) for v in self.verdicts
        )
        unrecovered = sum(
            int(v.detail.get("unrecovered", 0) or 0) for v in self.verdicts
        )
        return {
            "ok": self.ok,
            "n_legs": len(self.verdicts),
            "n_failed": len(self.failures()),
            "sentinel_violations": n_violations,
            "unrecovered_faults": unrecovered,
            "wall_seconds": self.wall_seconds,
            "legs": [v.to_payload() for v in self.verdicts],
        }


def _recovery_capable(backend: str) -> bool:
    return bool(getattr(registry.get(backend).capabilities, "recovery", False))


def run_replay_leg(
    scenario: ChaosScenario, backend: str, sentinel_every: int = 8
) -> LegVerdict:
    """Manual per-event replay with online sentinel attribution."""
    cap = scenario.replay_capacity_bytes
    # client-call fault clock: preemption traces are authored against the
    # replayed workload's alloc stream, not the device call stream a
    # caching backend happens to leak through — without this, backends
    # that serve the replay almost entirely from cache (stalloc and
    # hybrid issue ONE device call for the whole workload) never reach
    # the scheduled offsets and the leg passes vacuously
    device = FaultInjector(
        VMMDevice(cap), scenario.schedule(cap), external_clock=True
    )
    alloc = registry.create(backend, device)
    trace = _replay_workload()
    if getattr(alloc, "needs_prepare", False):
        alloc.prepare(trace)
    sentinel = InvariantSentinel(alloc, device, every=sentinel_every)

    live: Dict[int, object] = {}
    oom_accounted = 0
    raw_device_oom: Optional[str] = None
    completed = False
    try:
        for i, ev in enumerate(trace.events):
            desc = {"mode": "replay", "i": i, "op": ev.op}
            if ev.op == ALLOC:
                device.tick()  # advance the client-call fault clock
                try:
                    live[ev.tid] = alloc.malloc(ev.size)
                except AllocatorOOM:
                    oom_accounted += 1  # shed + accounted, not a crash
            elif ev.op == FREE:
                a = live.pop(ev.tid, None)
                if a is not None:
                    alloc.free(a)
            sentinel.tick(desc)
        completed = True
    except DeviceOOM as exc:  # a backend let a raw device fault escape
        raw_device_oom = f"{type(exc).__name__}: {exc}"

    for tid in list(live):
        alloc.free(live.pop(tid))
    if hasattr(alloc, "release_cached"):
        alloc.release_cached()
    sentinel.check_drained({"mode": "replay", "op": "drain"})

    log = getattr(alloc, "event_log", None)
    counts = dict(log.counts) if log is not None else {}
    unrecovered = int(counts.get("unrecovered", 0))
    detail = {
        "events": len(trace.events),
        "oom_accounted": oom_accounted,
        "raw_device_oom": raw_device_oom,
        "fault_counts": dict(device.fault_counts),
        "recovery_counts": counts,
        "unrecovered": unrecovered,
        "model_cost": device.ledger.total,
    }
    safety = (
        raw_device_oom is None
        and sentinel.ok
        and (unrecovered == 0 or not _recovery_capable(backend))
    )
    return LegVerdict(
        scenario=scenario.name,
        backend=backend,
        mode="replay",
        liveness=completed,
        safety=safety,
        quality=True,  # replay legs carry no SLO floors
        detail=detail,
        sentinel=sentinel.summary(),
    )


def run_serving_leg(
    scenario: ChaosScenario, backend: str, sentinel_every: int = 8
) -> LegVerdict:
    """ServingSimulator with degradation on, over the injected schedule."""
    cap = scenario.serving_capacity_bytes
    device = FaultInjector(VMMDevice(cap), scenario.schedule(cap))
    alloc = registry.create(backend, device)
    sentinel = InvariantSentinel(alloc, device, every=max(1, sentinel_every))
    sim_cfg = SimConfig(
        allocator=backend,
        capacity_bytes=cap,
        tenant_weight_bytes=32 * MB,
        degradation=True,
    )
    sim = ServingSimulator(
        sim_cfg, allocator=alloc, sentinel=sentinel, device=device
    )
    load = LoadGenConfig(
        duration_steps=scenario.duration_steps,
        seed=scenario.seed + 11,
        base_arrivals_per_step=scenario.arrivals_per_step,
    )

    raw_device_oom: Optional[str] = None
    result = None
    try:
        result = sim.run(generate(load))
    except DeviceOOM as exc:
        raw_device_oom = f"{type(exc).__name__}: {exc}"
    sentinel.check_drained({"mode": "serving", "op": "drain"})

    if result is None:
        return LegVerdict(
            scenario=scenario.name, backend=backend, mode="serving",
            liveness=False, safety=False, quality=False,
            detail={"raw_device_oom": raw_device_oom},
            sentinel=sentinel.summary(),
        )

    counts = (result.recovery or {}).get("counts", {})
    unrecovered = int(counts.get("unrecovered", 0))
    leftover = result.n_unfinished - result.n_dropped
    liveness = leftover >= 0 and (
        result.n_arrived
        == result.n_finished + result.n_dropped + leftover
    )
    # serving legs are deliberately memory-bound: capacity OOMs walk the
    # ladder to exhaustion by design and surface as AllocatorOOM, which
    # the degradation layer absorbs (defer/evict/drop). ``unrecovered``
    # is therefore reported, not gated, here — the replay legs, whose
    # schedules are sized ladder-absorbable, gate it at zero.
    safety = raw_device_oom is None and sentinel.ok
    quality = True
    floor_misses = {}
    # SLO floors are the recovery-capable backends' contract: native is
    # the known-fragile baseline every comparison is *against*
    if _recovery_capable(backend):
        for cls, floor in scenario.slo_floors:
            att = result.slo_attainment(cls)
            if att is None or att < floor:
                quality = False
                floor_misses[cls] = att
        if not scenario.interactive_preemption_ok:
            if sim.preempted_by_class.get("interactive", 0):
                quality = False
                floor_misses["interactive_preemptions"] = (
                    sim.preempted_by_class["interactive"]
                )
            if sim.evicted_by_class.get("interactive", 0):
                quality = False
                floor_misses["interactive_evictions"] = (
                    sim.evicted_by_class["interactive"]
                )
    detail = {
        "n_arrived": result.n_arrived,
        "n_finished": result.n_finished,
        "n_dropped": result.n_dropped,
        "deferrals": result.deferrals,
        "preemptions": result.preemptions,
        "degradation": result.degradation,
        "slo": {
            cls: result.slo_attainment(cls)
            for cls in sorted(result.per_class)
        },
        "floor_misses": floor_misses,
        "fault_counts": dict(device.fault_counts),
        "recovery_counts": dict(counts),
        "unrecovered": unrecovered,
        "pending_unmaps": result.pending_unmaps,
        "raw_device_oom": raw_device_oom,
    }
    return LegVerdict(
        scenario=scenario.name, backend=backend, mode="serving",
        liveness=liveness, safety=safety, quality=quality,
        detail=detail, sentinel=sentinel.summary(),
    )


def run_engine_leg(backend: str) -> LegVerdict:
    """Kill/recover scenario (jax-backed ServeEngine + supervisor)."""
    import tempfile

    from ..serve.killrecover import KillRecoverConfig, run_scenario

    cfg = KillRecoverConfig.for_backend(backend)
    raw_device_oom: Optional[str] = None
    summary = None
    with tempfile.TemporaryDirectory() as ckpt_dir:
        try:
            summary = run_scenario(cfg, ckpt_dir)
        except DeviceOOM as exc:
            raw_device_oom = f"{type(exc).__name__}: {exc}"
    if summary is None:
        return LegVerdict(
            scenario="kill_recover", backend=backend, mode="engine",
            liveness=False, safety=False, quality=False,
            detail={"raw_device_oom": raw_device_oom},
        )
    recovery = (summary["memory_report"].get("recovery") or {})
    counts = recovery.get("counts", {})
    detail = {
        "finished": summary["finished"],
        "requests": summary["requests"],
        "drained": summary["drained"],
        "restarts": summary["restarts"],
        "recovery_counts": dict(counts),
        "unrecovered": int(counts.get("unrecovered", 0)),
    }
    return LegVerdict(
        scenario="kill_recover", backend=backend, mode="engine",
        liveness=bool(summary["drained"])
        and summary["finished"] == summary["requests"],
        safety=raw_device_oom is None,
        quality=summary["restarts"] >= 1,
        detail=detail,
    )


def run_campaign(cfg: Optional[CampaignConfig] = None) -> CampaignResult:
    cfg = cfg or CampaignConfig()
    t0 = time.perf_counter()
    verdicts: List[LegVerdict] = []
    for scenario in cfg.resolved_scenarios():
        for backend in cfg.resolved_backends():
            if scenario.replay:
                verdicts.append(
                    run_replay_leg(scenario, backend, cfg.sentinel_every)
                )
            if scenario.serving:
                verdicts.append(
                    run_serving_leg(scenario, backend, cfg.sentinel_every)
                )
    if not cfg.fast:
        for backend in cfg.resolved_backends():
            if backend in ENGINE_BACKENDS:
                verdicts.append(run_engine_leg(backend))
    return CampaignResult(
        verdicts=verdicts, wall_seconds=time.perf_counter() - t0
    )


__all__ = [
    "ENGINE_BACKENDS",
    "CampaignConfig",
    "CampaignResult",
    "LegVerdict",
    "run_campaign",
    "run_engine_leg",
    "run_replay_leg",
    "run_serving_leg",
]
