"""Port parity: the chaos subsystem on the port's copies.

``repro_torch.chaos``, ``repro_torch.serve.{loadgen,simulate}`` and the
planning backends are byte-identical copies of the JAX package's modules
(``tests/test_torch_alloc.py`` checks that); these are
``tests/test_chaos.py``'s trace-format, sentinel, fault-absorption,
campaign, degradation and payload tests run on the copies, importing them
through the port. The replay and serving legs must also give verdicts
equal to the JAX package's on the same scenario and backend. Campaigns run
with ``fast=True``: the engine legs run the port's kill/recover scenario,
whose CPU parity is ``tests/test_torch_killrecover.py`` and whose card run
is ``chip_smoke.py``'s phase 7a.
"""

import dataclasses
import json
from pathlib import Path

import pytest

from repro_torch.alloc import (
    GB,
    MB,
    FaultInjector,
    FaultSchedule,
    QuotaDenied,
    VMMDevice,
    registry,
)
from repro_torch.alloc.chunks import (
    PREEMPTION_TRACE_FORMAT,
    PreemptionEvent,
    load_preemption_trace,
)
from repro_torch.alloc.ellm import ELLMAllocator
from repro_torch.chaos import (
    CampaignConfig,
    InvariantSentinel,
    run_campaign,
    run_replay_leg,
    run_serving_leg,
)
from repro_torch.chaos.scenarios import (
    DEFAULT_TRACE_PATH,
    capacity_storm,
    spot_revocation,
    sustained_pressure,
)
from repro_torch.serve.loadgen import LoadGenConfig, RequestSpec, generate
from repro_torch.serve.simulate import ServingSimulator, SimConfig
from repro.alloc import FaultSchedule as JFaultSchedule
from repro.chaos import campaign as jcampaign
from repro.chaos import scenarios as jscenarios


def same_verdict(port_verdict, jax_verdict):
    assert port_verdict.to_payload() == jax_verdict.to_payload()


def test_default_trace_path_is_the_checked_in_trace():
    """``parents[3]`` of the copied module is the repository root too."""
    here = Path(__file__).resolve().parent / "data" / "preemption.trace.json"
    assert DEFAULT_TRACE_PATH == jscenarios.DEFAULT_TRACE_PATH == here


# ---------------------------------------------------------------------------
# preemption trace format
# ---------------------------------------------------------------------------


def test_checked_in_trace_parses_and_is_sorted():
    events = load_preemption_trace(str(DEFAULT_TRACE_PATH))
    assert len(events) == 4
    assert [e.at for e in events] == sorted(e.at for e in events)
    assert {e.kind for e in events} <= set(PreemptionEvent.KINDS)


def test_trace_accepts_payload_dict_and_bare_list():
    payload = json.loads(DEFAULT_TRACE_PATH.read_text())
    assert payload["format"] == PREEMPTION_TRACE_FORMAT
    from_dict = load_preemption_trace(payload)
    from_list = load_preemption_trace(payload["events"])
    assert from_dict == from_list


def test_unknown_format_and_bad_rows_are_loud():
    with pytest.raises(ValueError, match="unknown preemption trace format"):
        load_preemption_trace({"format": "v0", "events": []})
    with pytest.raises(ValueError, match="unknown preemption event kind"):
        PreemptionEvent(at=1, kind="meteor", severity=0.5)
    with pytest.raises(ValueError, match="severity"):
        PreemptionEvent(at=1, kind="transient", severity=1.5)
    with pytest.raises(ValueError, match="timing"):
        PreemptionEvent(at=0, kind="transient", severity=0.5)


def test_schedule_synthesis_is_deterministic_and_hashable():
    """Same trace + seed + capacity -> the identical frozen schedule; the
    chaos verdicts' replayability rests on this."""
    a = FaultSchedule.from_preemption_trace(
        str(DEFAULT_TRACE_PATH), capacity_bytes=2 * GB, seed=7
    )
    b = FaultSchedule.from_preemption_trace(
        str(DEFAULT_TRACE_PATH), capacity_bytes=2 * GB, seed=7
    )
    assert a == b and hash(a) == hash(b)
    c = FaultSchedule.from_preemption_trace(
        str(DEFAULT_TRACE_PATH), capacity_bytes=2 * GB, seed=8
    )
    assert c != a  # the seed is part of the schedule identity
    j = JFaultSchedule.from_preemption_trace(
        str(DEFAULT_TRACE_PATH), capacity_bytes=2 * GB, seed=7
    )
    assert dataclasses.asdict(a) == dataclasses.asdict(j)


def test_revocation_synthesizes_warning_shrink_and_burst():
    ev = PreemptionEvent(
        at=50, kind="revocation", severity=0.25, duration=10, lead=12
    )
    s = FaultSchedule.from_preemption_trace([ev], capacity_bytes=1 * GB)
    assert (50, int(0.25 * GB)) in s.shrinks
    assert (50, int(0.25 * FaultSchedule.REVOCATION_BURST_SCALE)) in s.bursts_at
    # the warning brownout leads the revocation; the failure window
    # starts at it
    starts = sorted(w.start_call for w in s.windows)
    assert starts == [38, 50]
    warning = next(w for w in s.windows if w.start_call == 38)
    assert warning.slow_prob == pytest.approx(0.5 * 0.25)


def test_capacity_loss_is_a_plain_shrink():
    ev = PreemptionEvent(at=10, kind="capacity_loss", severity=0.1)
    s = FaultSchedule.from_preemption_trace([ev], capacity_bytes=1 * GB)
    assert s.shrinks == ((10, int(0.1 * GB)),)
    assert not s.windows and not s.bursts_at


# ---------------------------------------------------------------------------
# invariant sentinel
# ---------------------------------------------------------------------------


def test_sentinel_samples_at_cadence_and_stays_clean():
    device = VMMDevice(256 * MB)
    alloc = registry.create("gmlake", device)
    sentinel = InvariantSentinel(alloc, device, every=4)
    live = [alloc.malloc(4 * MB) for _ in range(8)]
    for i in range(12):
        sentinel.tick({"op": "probe", "i": i})
    assert sentinel.ticks == 12
    assert sentinel.checks_run == 3  # ticks 0, 4, 8
    assert sentinel.ok and sentinel.first_violation is None
    for a in live:
        alloc.free(a)
    alloc.release_cached()
    alloc.drain_deferred_unmaps()
    sentinel.check_drained({"op": "drain"})
    assert sentinel.ok
    s = sentinel.summary()
    assert s["n_violations"] == 0 and s["first_violation"] is None


def test_sentinel_attributes_first_violation_to_the_event():
    """Corrupt the device-agreement invariant behind the allocator's back:
    the sentinel must record WHICH event was active, not just that some
    check failed somewhere."""
    device = VMMDevice(256 * MB)
    alloc = registry.create("caching", device)
    sentinel = InvariantSentinel(alloc, device, every=1)
    a = alloc.malloc(4 * MB)
    sentinel.tick({"op": "probe", "i": 0})
    assert sentinel.ok
    # simulate a lost reservation: device hands back bytes the backend
    # still thinks it holds -> used < reserved
    device.cu_free(device.used_bytes)
    sentinel.tick({"op": "probe", "i": 1})
    assert not sentinel.ok
    first = sentinel.first_violation
    assert first.check == "device_agreement"
    assert first.event == {"op": "probe", "i": 1}
    payload = sentinel.summary()["first_violation"]
    assert payload["check"] == "device_agreement"
    assert payload["event"]["i"] == 1
    alloc.free(a)  # keep the allocator's own bookkeeping clean


def test_sentinel_check_drained_catches_a_leak():
    device = VMMDevice(256 * MB)
    alloc = registry.create("caching", device)
    sentinel = InvariantSentinel(alloc, device)
    alloc.malloc(4 * MB)  # never freed
    sentinel.check_drained({"op": "drain"})
    assert not sentinel.ok
    checks = {v.check for v in sentinel.violations}
    assert "drain_active_zero" in checks


# ---------------------------------------------------------------------------
# release-side fault absorption
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", sorted(registry.names()))
def test_release_faults_stall_but_never_leak(backend):
    """Free/drain paths are fire-and-forget: with the release side
    faulting on every call, a full alloc/free cycle must complete, count
    the faults, and still drain to exact device agreement."""
    device = FaultInjector(
        VMMDevice(256 * MB),
        FaultSchedule(seed=1, release_fail_prob=1.0, release_retry_limit=2),
    )
    alloc = registry.create(backend, device)
    # mixed sizes so every backend's release machinery engages: sub-chunk
    # (small pools), chunk-scale, and segment/slab-scale blocks
    live = [alloc.malloc(s) for s in
            (1 * MB, 1 * MB, 3 * MB, 3 * MB, 32 * MB, 32 * MB)]
    for a in live:
        alloc.free(a)
    alloc.release_cached()
    drain = getattr(alloc, "drain_deferred_unmaps", None)
    if drain is not None:
        drain()
    assert alloc.stats.active_bytes == 0
    assert device.used_bytes == alloc.reserved_bytes
    assert device.fault_counts.get("release_fault", 0) > 0


# ---------------------------------------------------------------------------
# campaign legs (reduced sweeps; the full matrix lives in bench_chaos)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", sorted(registry.names()))
def test_replay_legs_are_verdict_clean(backend):
    """Replay legs gate the full contract: zero unrecovered faults
    (recovery-capable backends), zero sentinel violations, no raw
    DeviceOOM, exact drain. Two scenario shapes cover shrink-heavy and
    warning-window schedules."""
    for scenario, jscenario in ((spot_revocation(), jscenarios.spot_revocation()),
                                (capacity_storm(), jscenarios.capacity_storm())):
        v = run_replay_leg(scenario, backend)
        assert v.ok, (scenario.name, backend, v.detail, v.sentinel)
        assert v.sentinel["n_violations"] == 0
        assert v.detail["fault_counts"], "schedule injected nothing"
        same_verdict(v, jcampaign.run_replay_leg(jscenario, backend))


def test_serving_leg_smoke_is_verdict_clean():
    """One trimmed serving leg end to end (the full per-backend sweep is
    bench territory): degradation on, sentinel ticking, verdict ok."""
    scenario = dataclasses.replace(
        spot_revocation(), duration_steps=80, arrivals_per_step=2.0
    )
    v = run_serving_leg(scenario, "gmlake")
    assert v.ok, (v.detail, v.sentinel)
    assert v.sentinel["n_violations"] == 0
    assert v.detail["n_arrived"] > 0
    jscenario = dataclasses.replace(
        jscenarios.spot_revocation(), duration_steps=80, arrivals_per_step=2.0
    )
    same_verdict(v, jcampaign.run_serving_leg(jscenario, "gmlake"))


def test_campaign_runner_fans_out_and_aggregates():
    cfg = CampaignConfig(
        backends=("gmlake", "caching"),
        scenarios=(dataclasses.replace(spot_revocation(), serving=False),),
        fast=True,
    )
    result = run_campaign(cfg)
    assert len(result.verdicts) == 2  # replay leg per backend, no engine
    assert result.ok
    payload = result.to_payload()
    assert payload["n_legs"] == 2 and payload["n_failed"] == 0
    assert payload["sentinel_violations"] == 0
    assert payload["unrecovered_faults"] == 0
    assert {leg["mode"] for leg in payload["legs"]} == {"replay"}
    jresult = jcampaign.run_campaign(jcampaign.CampaignConfig(
        backends=("gmlake", "caching"),
        scenarios=(dataclasses.replace(jscenarios.spot_revocation(), serving=False),),
        fast=True,
    ))
    jpayload = jresult.to_payload()
    del payload["wall_seconds"], jpayload["wall_seconds"]
    assert payload == jpayload


@pytest.mark.parametrize("backend", ["gmlake", "ellm"])
def test_sustained_pressure_degrades_gracefully(backend):
    """THE acceptance regime: a memory-bound serving mix where the
    degradation layer must hold the interactive SLO floor by shedding
    batch-class work — evictions and backpressure engage, interactive is
    never preempted or evicted. gmlake is the flagship; ellm is the
    backend whose arena needed the pressure-bypass valve to pass."""
    v = run_serving_leg(sustained_pressure(), backend)
    assert v.ok, (v.detail["floor_misses"], v.detail["slo"])
    same_verdict(v, jcampaign.run_serving_leg(jscenarios.sustained_pressure(), backend))
    assert v.detail["slo"]["interactive"] >= 0.99
    deg = v.detail["degradation"]
    assert deg["kv_evictions"] >= 1, "pressure never engaged eviction"
    assert deg["backpressure_delays"] >= 1, "pressure never backpressured"
    assert deg["evicted_by_class"].get("interactive", 0) == 0
    assert deg["preempted_by_class"].get("interactive", 0) == 0
    # degradation is absorbed by the lower classes
    absorbed = sum(
        n for cls, n in deg["evicted_by_class"].items() if cls != "interactive"
    )
    assert absorbed >= 1


# ---------------------------------------------------------------------------
# ellm pressure-bypass valve + tenant quota isolation
# ---------------------------------------------------------------------------


def test_ellm_bypass_valve_drains_and_resets_the_arena():
    """Once a core-side OOM opens the valve, weight-class requests route
    through the stitching core, interior free slabs return to the device,
    and the last elastic free releases the arena wholesale and closes the
    valve."""
    device = VMMDevice(128 * MB + 2 * MB)
    alloc = ELLMAllocator(device)
    # fill the arena with weight-class blocks, then pin the watermark high
    low = [alloc.malloc(32 * MB) for _ in range(3)]
    pin = alloc.malloc(32 * MB)
    for a in low:
        alloc.free(a)  # interior free spans below the pinned block
    assert alloc._arena_reserved >= 128 * MB
    # KV-side request larger than what's left outside the arena (2 MB
    # free, the request rounds to two chunks): the core OOMs, the valve
    # opens, interior slabs come back, and the retry lands
    kv = alloc.malloc(3 * MB)
    assert alloc._pressure_bypass
    assert alloc.elastic_counters["bypass"] == 1
    assert alloc._hole_slabs, "interior slabs were not released"
    assert alloc.event_log.counts.get("reclaim.deflate_arena", 0) >= 1
    alloc.check_invariants()
    # bypass routes even weight-class sizes through the core
    w = alloc.malloc(32 * MB)
    assert not isinstance(w.block, type(pin.block))
    alloc.free(w)
    alloc.free(kv)
    alloc.free(pin)  # last elastic block: arena resets, valve closes
    assert not alloc._pressure_bypass and not alloc._hole_slabs
    assert alloc._arena_reserved == 0
    alloc.release_cached()
    alloc.drain_deferred_unmaps()
    assert device.used_bytes == alloc.reserved_bytes
    alloc.check_invariants()


def test_ellm_tenant_quota_isolates_a_bursting_tenant():
    """The bursting tenant is denied at its quota; the co-tenant's
    allocations are untouched and the shared arena never inflates to
    absorb the burst."""
    device = VMMDevice(1 * GB)
    alloc = ELLMAllocator(device, tenant_quota_bytes=64 * MB)
    alloc.set_tenant("victim")
    v = alloc.malloc(32 * MB)
    alloc.set_tenant("burster")
    held = [alloc.malloc(32 * MB), alloc.malloc(32 * MB)]  # at quota
    reserved_before = alloc._arena_reserved
    # QuotaDenied subclasses AllocatorOOM: generic admission control
    # defers it, quota-aware callers can tell it from device pressure
    with pytest.raises(QuotaDenied, match="tenant quota"):
        alloc.malloc(32 * MB)
    assert alloc.elastic_counters["quota_denied"] == 1
    assert alloc._arena_reserved == reserved_before, "burst inflated arena"
    # the victim still has quota headroom and is served
    alloc.set_tenant("victim")
    v2 = alloc.malloc(32 * MB)
    alloc.set_tenant(None)
    assert alloc.tenant_arena_bytes == {"burster": 64 * MB, "victim": 64 * MB}
    for a in (v, v2, *held):
        alloc.free(a)
    alloc.check_invariants()


def _victim_schedule():
    """Two light interactive tenants, steady trickle."""
    return [
        RequestSpec(step=s, user_id=s * 2 + t, tenant=f"victim{t}",
                    slo="interactive", prompt_tokens=128, decode_tokens=16)
        for s in range(0, 120, 4) for t in range(2)
    ]


def test_ellm_quota_holds_victim_attainment_under_a_tenant_burst():
    """Acceptance: a bursting tenant must not drag any co-tenant's SLO
    attainment below the no-burst baseline. Same victim schedule twice —
    alone, then with a heavy batch-class flood from one tenant — on ellm
    with per-tenant quotas; the quota denies the burster at its cap and
    the victims' numbers hold."""
    cfg = SimConfig(
        allocator="ellm",
        capacity_bytes=1 * GB,
        tenant_weight_bytes=32 * MB,
        degradation=True,
        track_tenants=True,
        alloc_kwargs=dict(tenant_quota_bytes=96 * MB),
    )
    victims = _victim_schedule()
    # one burster peaks at 92 MB against the 96 MB quota (32 shard +
    # 40 prompt + 20 geometric growth) — individually completable, but
    # any *concurrent* second burst request is quota-denied at admission
    burst = [
        RequestSpec(step=s, user_id=10_000 + s, tenant="burster",
                    slo="batch", prompt_tokens=2560, decode_tokens=2)
        for s in range(20, 60)
    ]

    def attainment(res, tenant):
        st = res.per_tenant[tenant]
        return st.n_slo_met / max(1, st.n_finished), st.n_finished

    baseline = ServingSimulator(cfg).run(sorted(victims, key=lambda r: r.step))
    flooded = ServingSimulator(cfg).run(
        sorted(victims + burst, key=lambda r: r.step)
    )
    assert (flooded.elastic_counters or {}).get("quota_denied", 0) > 0, (
        "the burst never hit the quota — the scenario is vacuous"
    )
    for tenant in ("victim0", "victim1"):
        base_att, base_n = attainment(baseline, tenant)
        burst_att, burst_n = attainment(flooded, tenant)
        assert burst_n >= base_n, (tenant, burst_n, base_n)
        assert burst_att >= base_att, (tenant, burst_att, base_att)


def test_quota_denied_growth_is_shed_bounded_not_livelocked():
    """A request whose decode growth can *never* fit under its tenant
    quota must be dropped after the retry budget, not preempted and
    readmitted forever (each readmission re-charges the full prefill,
    inflating the modeled clock for every co-tenant)."""
    cfg = SimConfig(
        allocator="ellm",
        capacity_bytes=1 * GB,
        tenant_weight_bytes=32 * MB,
        degradation=True,
        track_tenants=True,
        alloc_kwargs=dict(tenant_quota_bytes=96 * MB),
    )
    # prompt 4096 tokens = 64 MB; with the 32 MB shard the tenant sits at
    # its 96 MB quota, so the first decode-growth slab is denied forever
    doomed = [RequestSpec(step=0, user_id=1, tenant="burster", slo="batch",
                          prompt_tokens=4096, decode_tokens=64)]
    res = ServingSimulator(cfg).run(doomed)
    assert (res.elastic_counters or {}).get("quota_denied", 0) > 0
    assert res.per_class["batch"].n_dropped == 1, "request must be shed"
    assert res.preemptions <= cfg.defer_retry_limit, (
        "quota-denied growth must be retry-bounded, not livelocked"
    )
    # the tail is idle backoff drain (geometric, sums to ~380 steps of
    # near-empty clock), nowhere near the 4096-step livelock ceiling
    assert res.steps < 1000, res.steps


# ---------------------------------------------------------------------------
# ServingResult payload plumbing (what the campaign + CI tier read)
# ---------------------------------------------------------------------------


def _tiny_load():
    return generate(LoadGenConfig(
        duration_steps=40, seed=3, base_arrivals_per_step=1.0
    ))


def test_serving_payload_carries_recovery_and_drop_accounting():
    """to_payload must surface: per-class + top-level n_dropped, the
    pending-unmaps backlog, and the recovery counters (None fault-free;
    a counts dict under an injector)."""
    cfg = SimConfig(allocator="gmlake", capacity_bytes=4 * GB)
    res = ServingSimulator(cfg).run(_tiny_load())
    p = res.to_payload()
    assert p["n_dropped"] == 0
    assert p["pending_unmaps"] == res.pending_unmaps
    assert p["recovery"] is None  # no injector -> no recovery stream
    for cls in p["per_class"].values():
        assert "n_dropped" in cls

    sched = FaultSchedule(seed=2, create_fail_prob=0.05, burst=1)
    device = FaultInjector(VMMDevice(4 * GB), sched)
    alloc = registry.create("gmlake", device)
    res2 = ServingSimulator(cfg, allocator=alloc, device=device).run(
        _tiny_load()
    )
    p2 = res2.to_payload()
    assert isinstance(p2["recovery"], dict)
    assert p2["recovery"]["counts"], "injector ran but no recovery events"


def test_degradation_off_keeps_the_payload_shape_lean():
    """Without degradation the payload must not grow the degradation or
    per-tenant sections (bit-stable payloads for fault-free baselines)."""
    cfg = SimConfig(allocator="caching", capacity_bytes=4 * GB)
    p = ServingSimulator(cfg).run(_tiny_load()).to_payload()
    assert "degradation" not in p
    assert "per_tenant" not in p
