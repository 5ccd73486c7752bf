"""Multi-tenant, admission-controlled serving simulation.

``ServeEngine`` executes a real (small) model, which caps how much traffic
a test can push through it. This module keeps the *memory* side of serving
— the part the GMLake paper is about — and models the compute side with a
deterministic clock, so a million-user schedule from ``loadgen`` can be
driven through any ``repro.alloc`` backend in milliseconds of host time:

  * every running request owns a growing KV allocation series (the exact
    growth math of ``StitchedKVCache``: 1.5x geometric target, 2 MB chunk
    quantization) allocated straight from the backend under test;
  * tenants with live traffic hold weight-class shard allocations that are
    dropped after sustained idleness — tenant churn is what exercises
    elastic inflation/deflation;
  * admission is SLO-priority ordered and memory-gated: an ``AllocatorOOM``
    on prompt KV defers the request (admission control), an OOM growing a
    running request's KV preempts it back to the queue (restart);
  * the clock charges fixed step cost + per-token compute + the device
    ledger's modeled API cost, giving bit-stable TTFT/TPOT per backend —
    the load-independent signal CI gates at 2% while wall time stays
    warn-only.

SLO attainment, deferral/preemption counts and the peak/frag metrics come
out per backend under an *identical* schedule, which is the comparison
``benchmarks/bench_serving.py`` publishes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..alloc import CHUNK_SIZE, GB, MB, AllocatorOOM, QuotaDenied, VMMDevice, registry
from .loadgen import SLO_CLASSES, LoadGenConfig, RequestSpec, generate

#: admission order (lower first) — mirrors ``engine.SLO_PRIORITY``
_PRIORITY = {"interactive": 0, "standard": 1, "batch": 2}


@dataclass
class SimConfig:
    """Simulation knobs. Deterministic given (schedule, allocator)."""

    allocator: str = "gmlake"
    #: 8 GB with the default million-user schedule is the regime the
    #: benchmark wants: memory-bound enough that a fragmenting backend
    #: pays in deferrals and SLO misses, loose enough that stitching /
    #: elastic backends clear the same load untouched
    capacity_bytes: int = 8 * GB
    #: per-token KV bytes summed over layers/heads (fixes chunk_tokens)
    token_bytes: int = 16 * 1024
    max_concurrency: int = 256
    #: weight-class shard bytes a tenant holds while it has live traffic
    tenant_weight_bytes: int = 96 * MB
    #: steps of tenant idleness before its shard is dropped
    weight_idle_steps: int = 64
    #: drain budget after the last scheduled arrival
    max_drain_steps: int = 4096
    # modeled clock (milliseconds)
    step_fixed_ms: float = 2.0
    token_ms: float = 0.02
    api_cost_ms: float = 0.01  # per modeled device-API cost unit
    # -- graceful-degradation layer (chaos campaigns) -----------------------
    #: master switch; OFF by default so the fault-free serving numbers
    #: (and their golden baselines) stay bit-identical
    degradation: bool = False
    #: sustained-pressure detector: >= pressure_threshold deferral events
    #: within the last pressure_window steps engages admission backpressure
    pressure_window: int = 8
    pressure_threshold: int = 3
    #: bounded retry/backoff on deferred submits (replaces the unbounded
    #: re-queue): a request re-enters admission after a class-scaled,
    #: doubling backoff; past defer_retry_limit it is dropped-and-accounted
    defer_retry_limit: int = 6
    defer_backoff_steps: int = 2
    #: admission failures tolerated per step before admission stops —
    #: lets tenant-local denials (ellm quotas) skip past the bursting
    #: tenant instead of head-blocking everyone behind it
    admit_fail_budget: int = 4
    #: per-tenant SLO accounting (quota-isolation experiments)
    track_tenants: bool = False
    #: extra backend ctor kwargs (e.g. ellm's ``tenant_quota_bytes``)
    alloc_kwargs: dict = field(default_factory=dict)


@dataclass
class _LiveRequest:
    spec: RequestSpec
    kv_allocs: List[object] = field(default_factory=list)
    kv_chunks: int = 0  # chunks currently backing this request
    tokens: int = 0  # prompt + decoded so far
    decoded: int = 0
    first_token_ms: Optional[float] = None
    finish_ms: Optional[float] = None
    preemptions: int = 0


@dataclass
class ClassStats:
    n_arrived: int = 0
    n_finished: int = 0
    n_slo_met: int = 0
    n_dropped: int = 0
    ttft_ms: List[float] = field(default_factory=list)
    tpot_ms: List[float] = field(default_factory=list)


def _percentile(xs: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (deterministic, no interpolation)."""
    if not xs:
        return None
    s = sorted(xs)
    k = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[k]


@dataclass
class ServingResult:
    allocator: str
    steps: int
    n_arrived: int
    n_finished: int
    n_unfinished: int
    deferrals: int
    preemptions: int
    peak_active: int
    peak_reserved: int
    final_reserved: int
    model_cost: float
    modeled_ms_total: float
    wall_seconds: float
    per_class: Dict[str, ClassStats]
    elastic_counters: Optional[Dict[str, int]] = None
    n_dropped: int = 0
    pending_unmaps: int = 0
    #: ``AllocatorEventLog.summary()`` of the backend's recovery ladder
    #: (None when the backend keeps no event log or logged nothing)
    recovery: Optional[dict] = None
    #: degradation-layer counters; None unless ``SimConfig.degradation``
    degradation: Optional[dict] = None
    #: per-tenant SLO stats; None unless ``SimConfig.track_tenants``
    per_tenant: Optional[Dict[str, ClassStats]] = None

    @property
    def frag_ratio(self) -> float:
        if not self.peak_reserved:
            return 0.0
        return (self.peak_reserved - self.peak_active) / self.peak_reserved

    def slo_attainment(self, cls: str) -> Optional[float]:
        st = self.per_class.get(cls)
        if st is None or not st.n_finished:
            return None
        return st.n_slo_met / st.n_finished

    def tenant_slo_attainment(self, tenant: str) -> Optional[float]:
        st = (self.per_tenant or {}).get(tenant)
        if st is None or not st.n_finished:
            return None
        return st.n_slo_met / st.n_finished

    def to_payload(self) -> dict:
        """JSON-ready summary (the BENCH_serving.json per-backend row)."""
        classes = {}
        for name, st in sorted(self.per_class.items()):
            classes[name] = {
                "n_arrived": st.n_arrived,
                "n_finished": st.n_finished,
                "n_dropped": st.n_dropped,
                "slo_attainment": self.slo_attainment(name),
                "ttft_ms_p50": _percentile(st.ttft_ms, 0.50),
                "ttft_ms_p95": _percentile(st.ttft_ms, 0.95),
                "tpot_ms_p50": _percentile(st.tpot_ms, 0.50),
                "tpot_ms_p95": _percentile(st.tpot_ms, 0.95),
            }
        tenants = None
        if self.per_tenant is not None:
            tenants = {
                t: {
                    "n_arrived": st.n_arrived,
                    "n_finished": st.n_finished,
                    "n_dropped": st.n_dropped,
                    "slo_attainment": self.tenant_slo_attainment(t),
                }
                for t, st in sorted(self.per_tenant.items())
            }
        return {
            "allocator": self.allocator,
            "steps": self.steps,
            "n_arrived": self.n_arrived,
            "n_finished": self.n_finished,
            "n_unfinished": self.n_unfinished,
            "deferrals": self.deferrals,
            "preemptions": self.preemptions,
            "n_dropped": self.n_dropped,
            "peak_active": self.peak_active,
            "peak_reserved": self.peak_reserved,
            "final_reserved": self.final_reserved,
            "frag_ratio": self.frag_ratio,
            "model_cost": self.model_cost,
            "modeled_ms_total": self.modeled_ms_total,
            "wall_seconds": self.wall_seconds,
            "pending_unmaps": self.pending_unmaps,
            "recovery": self.recovery,
            "per_class": classes,
            **({"elastic_counters": dict(self.elastic_counters)}
               if self.elastic_counters else {}),
            **({"degradation": dict(self.degradation)}
               if self.degradation else {}),
            **({"per_tenant": tenants} if tenants else {}),
        }


class ServingSimulator:
    """One backend under one schedule (see module docstring)."""

    def __init__(self, sim_cfg: SimConfig, allocator=None, sentinel=None,
                 device=None):
        self.cfg = sim_cfg
        self.device = (
            device if device is not None else VMMDevice(sim_cfg.capacity_bytes)
        )
        self.alloc = (
            allocator
            if allocator is not None
            else registry.create(
                sim_cfg.allocator, self.device, **sim_cfg.alloc_kwargs
            )
        )
        self.chunk_tokens = max(1, CHUNK_SIZE // sim_cfg.token_bytes)
        self.queue: List[Tuple[int, int, RequestSpec]] = []  # (prio, seq, spec)
        self.running: List[_LiveRequest] = []  # admission order
        self.per_class: Dict[str, ClassStats] = {}
        self.per_tenant: Dict[str, ClassStats] = {}
        self.deferrals = 0
        self.preemptions = 0
        self.now_ms = 0.0
        self._arrival_ms: Dict[int, float] = {}  # schedule seq -> arrival clock
        self._seq = 0
        self._tenant_weights: Dict[str, object] = {}
        self._tenant_last_active: Dict[str, int] = {}
        self._cost_seen = self._ledger_total()
        # optional chaos sentinel, ticked once per simulated step
        self._sentinel = sentinel
        # quota-capable backends (ellm) attribute arena bytes per tenant
        self._set_tenant = getattr(self.alloc, "set_tenant", None)
        # graceful-degradation state (inert while cfg.degradation is off)
        self._not_before: Dict[int, int] = {}  # seq -> earliest retry step
        self._retries: Dict[int, int] = {}  # seq -> deferred-submit count
        # seq -> quota-denied growth count; survives readmission (the denial
        # is deterministic for the tenant, so readmitting resets nothing)
        self._quota_retries: Dict[int, int] = {}
        self._pressure_marks: List[int] = []  # recent deferral steps
        self.backpressure_delays = 0
        self.dropped = 0
        self.kv_evictions = 0
        self.evicted_by_class: Dict[str, int] = {}
        self.preempted_by_class: Dict[str, int] = {}

    # -- modeled clock ------------------------------------------------------
    def _ledger_total(self) -> float:
        ledger = getattr(self.device, "ledger", None)
        return float(ledger.total) if ledger is not None else 0.0

    def _charge_step(self, tokens: int) -> None:
        cost = self._ledger_total()
        api = cost - self._cost_seen
        self._cost_seen = cost
        self.now_ms += (
            self.cfg.step_fixed_ms
            + self.cfg.token_ms * tokens
            + self.cfg.api_cost_ms * api
        )

    # -- KV accounting (StitchedKVCache growth math) ------------------------
    def _grow_kv(self, lr: _LiveRequest, n_tokens: int) -> None:
        """Grow ``lr`` to hold ``n_tokens`` more tokens; 1.5x geometric."""
        have = lr.kv_chunks * self.chunk_tokens
        if lr.tokens + n_tokens <= have:
            lr.tokens += n_tokens
            return
        want = max(lr.tokens + n_tokens, int(have * 1.5))
        need_chunks = -(-want // self.chunk_tokens)
        delta = need_chunks - lr.kv_chunks
        assert delta > 0
        if self._set_tenant is not None:
            self._set_tenant(lr.spec.tenant)
        try:
            alloc = self.alloc.malloc(delta * CHUNK_SIZE)  # may raise AllocatorOOM
        finally:
            if self._set_tenant is not None:
                self._set_tenant(None)
        lr.kv_allocs.append(alloc)
        lr.kv_chunks = need_chunks
        lr.tokens += n_tokens

    def _free_request(self, lr: _LiveRequest) -> None:
        for a in lr.kv_allocs:
            self.alloc.free(a)
        lr.kv_allocs.clear()
        lr.kv_chunks = 0
        lr.tokens = 0

    # -- tenant weight shards ----------------------------------------------
    def _touch_tenant(self, tenant: str, step: int) -> bool:
        """Mark activity; load the tenant's shard if absent. False means
        the shard could not be loaded (admission must defer)."""
        self._tenant_last_active[tenant] = step
        if tenant in self._tenant_weights:
            return True
        if self._set_tenant is not None:
            self._set_tenant(tenant)
        try:
            self._tenant_weights[tenant] = self.alloc.malloc(
                self.cfg.tenant_weight_bytes
            )
        except AllocatorOOM:
            return False
        finally:
            if self._set_tenant is not None:
                self._set_tenant(None)
        return True

    def _evict_idle_tenants(self, step: int) -> None:
        idle_cut = step - self.cfg.weight_idle_steps
        for tenant in sorted(self._tenant_weights):
            if self._tenant_last_active.get(tenant, step) <= idle_cut:
                self.alloc.free(self._tenant_weights.pop(tenant))

    # -- scheduling ---------------------------------------------------------
    def _enqueue(self, spec: RequestSpec) -> None:
        st = self.per_class.setdefault(spec.slo, ClassStats())
        st.n_arrived += 1
        if self.cfg.track_tenants:
            self.per_tenant.setdefault(spec.tenant, ClassStats()).n_arrived += 1
        self._arrival_ms[self._seq] = self.now_ms
        self.queue.append((_PRIORITY.get(spec.slo, 1), self._seq, spec))
        self._seq += 1

    def _admit(self, step: int) -> int:
        """Admit in (priority, arrival) order until memory says stop.
        Returns prompt tokens prefetched this step (for the clock)."""
        if self.cfg.degradation:
            return self._admit_degraded(step)
        self.queue.sort()
        prefill_tokens = 0
        admitted: List[Tuple[int, int, RequestSpec]] = []
        while self.queue and len(self.running) < self.cfg.max_concurrency:
            prio, seq, spec = self.queue[0]
            if not self._touch_tenant(spec.tenant, step):
                self.deferrals += 1
                break
            lr = _LiveRequest(spec)
            try:
                self._grow_kv(lr, spec.prompt_tokens)
            except AllocatorOOM:
                self._free_request(lr)
                self.deferrals += 1
                break  # admission control: keep the queue, stop admitting
            self.queue.pop(0)
            lr._seq = seq  # type: ignore[attr-defined]
            self.running.append(lr)
            admitted.append((prio, seq, spec))
            prefill_tokens += spec.prompt_tokens
        return prefill_tokens

    # -- graceful degradation ----------------------------------------------
    def _admit_degraded(self, step: int) -> int:
        """Admission with the degradation layer on: same (priority,
        arrival) order, but deferred submits retry on a bounded,
        class-scaled backoff once sustained pressure is detected, and a
        small per-step failure budget lets admission skip past tenant-local
        denials (ellm quotas) instead of head-blocking the whole queue."""
        self.queue.sort()
        prefill_tokens = 0
        failures = 0
        i = 0
        while i < len(self.queue) and len(self.running) < self.cfg.max_concurrency:
            prio, seq, spec = self.queue[i]
            if self._not_before.get(seq, 0) > step:
                i += 1  # backing off; later arrivals may still fit
                continue
            admitted = False
            quota_denied = False
            if self._touch_tenant(spec.tenant, step):
                lr = _LiveRequest(spec)
                try:
                    self._grow_kv(lr, spec.prompt_tokens)
                    admitted = True
                except QuotaDenied:
                    self._free_request(lr)
                    quota_denied = True
                except AllocatorOOM:
                    self._free_request(lr)
            if admitted:
                self.queue.pop(i)
                self._not_before.pop(seq, None)
                self._retries.pop(seq, None)
                lr._seq = seq  # type: ignore[attr-defined]
                self.running.append(lr)
                prefill_tokens += spec.prompt_tokens
                continue
            failures += 1
            if not self._defer(i, step, quota=quota_denied):
                i += 1  # kept in queue with backoff — move past it
            if failures >= self.cfg.admit_fail_budget:
                break
        return prefill_tokens

    def _under_pressure(self, step: int) -> bool:
        """>= pressure_threshold deferral events inside pressure_window."""
        cut = step - self.cfg.pressure_window
        marks = self._pressure_marks
        while marks and marks[0] <= cut:
            marks.pop(0)
        return len(marks) >= self.cfg.pressure_threshold

    def _defer(self, i: int, step: int, *, quota: bool = False) -> bool:
        """Handle an admission failure for ``queue[i]``. Returns True when
        the request was dropped (removed from the queue).

        ``quota=True`` marks a tenant-local quota denial: it is not
        evidence of device pressure (the detector and backpressure
        counters are skipped) and it is deterministic for the tenant, so
        it goes straight to bounded retry accounting instead of the
        plain-retry grace path."""
        prio, seq, spec = self.queue[i]
        self.deferrals += 1
        if not quota:
            self._pressure_marks.append(step)
            if not self._under_pressure(step):
                return False  # transient blip: plain retry next step
            self.backpressure_delays += 1
        retries = self._retries.get(seq, 0) + 1
        self._retries[seq] = retries
        if retries > self.cfg.defer_retry_limit:
            self.queue.pop(i)
            self._account_drop(seq, spec)
            return True
        # deadline-aware backoff: tighter SLO classes back off least,
        # repeat offenders back off exponentially longer
        self._not_before[seq] = step + (
            self.cfg.defer_backoff_steps * (1 + prio) * (2 ** (retries - 1))
        )
        return False

    def _account_drop(self, seq: int, spec: RequestSpec) -> None:
        """Retry budget exhausted: shed the request, but keep the books —
        liveness means every arrival is finished *or accounted for*."""
        self.dropped += 1
        self.per_class.setdefault(spec.slo, ClassStats()).n_dropped += 1
        if self.cfg.track_tenants:
            self.per_tenant.setdefault(spec.tenant, ClassStats()).n_dropped += 1
        self._arrival_ms.pop(seq, None)
        self._not_before.pop(seq, None)
        self._retries.pop(seq, None)
        self._quota_retries.pop(seq, None)

    def _pick_victim(self, my_prio: int) -> Optional[_LiveRequest]:
        """Latest-admitted running request of the *lowest* SLO class that
        is still strictly lower-priority than the requester (batch first)."""
        best = None
        best_p = my_prio
        for cand in reversed(self.running):
            p = _PRIORITY.get(cand.spec.slo, 1)
            if p > best_p:
                best, best_p = cand, p
        return best

    def _evict(self, victim: _LiveRequest, step: int) -> None:
        """Batch-class KV eviction with recompute-on-resume: drop the
        victim's KV, re-queue it (decoded=0 forces prompt recompute), and
        hold it out briefly so it does not re-take the bytes it yielded."""
        self.running.remove(victim)
        self._free_request(victim)
        victim.decoded = 0
        victim.first_token_ms = None
        victim.preemptions += 1
        self.kv_evictions += 1
        slo = victim.spec.slo
        self.evicted_by_class[slo] = self.evicted_by_class.get(slo, 0) + 1
        seq = victim._seq  # type: ignore[attr-defined]
        self.queue.append((_PRIORITY.get(slo, 1), seq, victim.spec))
        self._not_before[seq] = step + self.cfg.defer_backoff_steps

    def _grow_with_eviction(
        self, lr: _LiveRequest, n_tokens: int, step: int
    ) -> bool:
        """Absorb a growth OOM by evicting strictly lower-priority KV
        (batch before standard) before ``lr`` itself would be preempted."""
        my_prio = _PRIORITY.get(lr.spec.slo, 1)
        while True:
            victim = self._pick_victim(my_prio)
            if victim is None:
                return False
            self._evict(victim, step)
            try:
                self._grow_kv(lr, n_tokens)
                return True
            except AllocatorOOM:
                continue

    def _shed_quota_denied(self, lr: _LiveRequest, step: int) -> None:
        """A running request's growth was quota-denied. The denial is
        deterministic for this tenant — evicting *other* tenants' KV
        cannot lift it, and an unbounded preempt/readmit cycle livelocks,
        re-charging the full prefill every round while inflating the
        modeled clock for everyone else. Bounded retry with class-scaled
        backoff, then shed. The counter survives readmission on purpose:
        readmitting changes nothing about the tenant's quota state."""
        seq = lr._seq  # type: ignore[attr-defined]
        retries = self._quota_retries.get(seq, 0) + 1
        self._quota_retries[seq] = retries
        if retries > self.cfg.defer_retry_limit:
            self._free_request(lr)
            self._account_drop(seq, lr.spec)
            return
        prio = _PRIORITY.get(lr.spec.slo, 1)
        self._preempt(lr)
        self._not_before[seq] = step + (
            self.cfg.defer_backoff_steps * (1 + prio) * (2 ** (retries - 1))
        )

    def _preempt(self, lr: _LiveRequest) -> None:
        """OOM growing a running request: restart it from the queue."""
        self._free_request(lr)
        lr.decoded = 0
        lr.first_token_ms = None
        self.preemptions += 1
        spec = lr.spec
        self.preempted_by_class[spec.slo] = (
            self.preempted_by_class.get(spec.slo, 0) + 1
        )
        self.queue.append((_PRIORITY.get(spec.slo, 1), lr._seq, spec))  # type: ignore[attr-defined]

    # -- main loop ----------------------------------------------------------
    def run(self, schedule: List[RequestSpec]) -> ServingResult:
        t0 = time.perf_counter()
        by_step: Dict[int, List[RequestSpec]] = {}
        horizon = 0
        for spec in schedule:
            by_step.setdefault(spec.step, []).append(spec)
            horizon = max(horizon, spec.step + 1)

        step = 0
        drain = 0
        while True:
            if step < horizon:
                for spec in by_step.get(step, ()):
                    self._enqueue(spec)
            elif not self.queue and not self.running:
                break
            else:
                drain += 1
                if drain > self.cfg.max_drain_steps:
                    break  # drain budget exhausted; report unfinished

            tokens = self._admit(step)

            finished_now: List[_LiveRequest] = []
            for lr in list(self.running):
                if lr not in self.running:
                    continue  # evicted by a higher-priority grower this step
                grown = True
                quota_denied = False
                try:
                    self._grow_kv(lr, 1)
                except QuotaDenied:
                    # tenant-local: eviction can't lift it — bounded shed
                    grown = False
                    quota_denied = self.cfg.degradation
                except AllocatorOOM:
                    grown = bool(
                        self.cfg.degradation
                        and self._grow_with_eviction(lr, 1, step)
                    )
                if not grown:
                    self.running.remove(lr)
                    if quota_denied:
                        self._shed_quota_denied(lr, step)
                    else:
                        self._preempt(lr)
                    continue
                tokens += 1
                lr.decoded += 1
                if lr.decoded >= lr.spec.decode_tokens:
                    finished_now.append(lr)

            self._charge_step(tokens)

            # stamp latencies at post-step clock; newly admitted requests'
            # first token lands at the end of their prefill step
            for lr in self.running:
                if lr.first_token_ms is None and lr.decoded >= 1:
                    lr.first_token_ms = self.now_ms
            for lr in finished_now:
                lr.finish_ms = self.now_ms
                self.running.remove(lr)
                self._free_request(lr)
                self._retire(lr)

            self._evict_idle_tenants(step)
            if self._sentinel is not None:
                self._sentinel.tick({"kind": "serving.step", "step": step})
            step += 1

        # drop still-running KV and tenant shards so leak checks see a
        # drained allocator even when the drain budget ran out
        for lr in self.running:
            self._free_request(lr)
        self.running.clear()
        for tenant in sorted(self._tenant_weights):
            self.alloc.free(self._tenant_weights.pop(tenant))

        return self._result(step, len(schedule), time.perf_counter() - t0)

    def _retire(self, lr: _LiveRequest) -> None:
        spec = lr.spec
        st = self.per_class[spec.slo]
        st.n_finished += 1
        self._quota_retries.pop(lr._seq, None)  # type: ignore[attr-defined]
        arrival = self._arrival_ms.pop(lr._seq)  # type: ignore[attr-defined]
        ttft = (lr.first_token_ms or lr.finish_ms) - arrival
        n_decode = max(1, spec.decode_tokens - 1)
        tpot = (lr.finish_ms - (lr.first_token_ms or arrival)) / n_decode
        st.ttft_ms.append(ttft)
        st.tpot_ms.append(tpot)
        slo = SLO_CLASSES.get(spec.slo)
        slo_ok = bool(
            slo and ttft <= slo.ttft_deadline_ms and tpot <= slo.tpot_deadline_ms
        )
        if slo_ok:
            st.n_slo_met += 1
        if self.cfg.track_tenants:
            tst = self.per_tenant.setdefault(spec.tenant, ClassStats())
            tst.n_finished += 1
            tst.ttft_ms.append(ttft)
            tst.tpot_ms.append(tpot)
            if slo_ok:
                tst.n_slo_met += 1

    def _result(self, steps: int, n_arrived: int, wall: float) -> ServingResult:
        stats = self.alloc.stats
        n_finished = sum(st.n_finished for st in self.per_class.values())
        log = getattr(self.alloc, "event_log", None)
        recovery = log.summary() if log is not None and len(log) else None
        degradation = None
        if self.cfg.degradation:
            degradation = {
                "backpressure_delays": self.backpressure_delays,
                "dropped": self.dropped,
                "kv_evictions": self.kv_evictions,
                "evicted_by_class": dict(sorted(self.evicted_by_class.items())),
                "preempted_by_class": dict(
                    sorted(self.preempted_by_class.items())
                ),
            }
        return ServingResult(
            allocator=self.alloc.name,
            steps=steps,
            n_arrived=n_arrived,
            n_finished=n_finished,
            n_unfinished=n_arrived - n_finished,
            deferrals=self.deferrals,
            preemptions=self.preemptions,
            peak_active=stats.peak_active,
            peak_reserved=stats.peak_reserved,
            final_reserved=self.alloc.reserved_bytes,
            model_cost=self._ledger_total(),
            modeled_ms_total=self.now_ms,
            wall_seconds=wall,
            per_class=self.per_class,
            elastic_counters=dict(
                getattr(self.alloc, "elastic_counters", None) or {}
            ) or None,
            n_dropped=self.dropped,
            pending_unmaps=int(getattr(self.alloc, "pending_unmaps", 0) or 0),
            recovery=recovery,
            degradation=degradation,
            per_tenant=self.per_tenant if self.cfg.track_tenants else None,
        )


def simulate(
    load_cfg: LoadGenConfig, sim_cfg: SimConfig, allocator=None
) -> ServingResult:
    """Generate the schedule for ``load_cfg`` and run it (convenience)."""
    return ServingSimulator(sim_cfg, allocator=allocator).run(generate(load_cfg))


__all__ = [
    "SimConfig",
    "ServingResult",
    "ServingSimulator",
    "ClassStats",
    "simulate",
]
