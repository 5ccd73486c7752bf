"""STAlloc-style spatio-temporal planning allocator (after arXiv 2507.16274).

Where GMLake *reacts* to fragmentation at runtime (stitching inactive
physical chunks under a fresh VA), STAlloc-style planning *prevents* it
offline: profile one run of the workload to learn every allocation's
(alloc-time, free-time, size) interval, solve the 2D placement problem —
time on one axis, address offset on the other — ahead of time, and replay
with the planned placements. The runtime allocator is then trivially cheap:
a planned malloc is an array lookup, a planned free is a counter update,
and the device sees exactly ONE upfront reservation of the plan's peak.

Two-phase operation:

  phase 1 — ``build_plan(trace)`` (offline, not on the timed path):
    * profile the trace into lifetime intervals,
    * split them STAlloc-style into a **static region** (intervals that
      live to the end of the trace: parameters, optimizer state — packed
      back-to-back at the bottom, where they can never fragment anything)
      and a **transient region** above it,
    * place transient intervals three ways and keep the smallest arena:
      arrival-order best-fit over free spans, size-ordered first-fit
      (vectorized over flat interval arrays with per-interval overlap
      candidate lists, so it stays tractable at 100k+ intervals), and —
      opt-in, for the hybrid backend — a strip-packing polish pass that
      runs a directed annealed ruin-and-recreate over the size-ordered
      packing to squeeze serving-shaped lifetime patterns the greedy
      heuristics leave fragmented.
    * optionally fit the result to a ``capacity`` budget by demoting the
      worst-fitting transients to a *spill set* the runtime serves from
      its fallback pool — this is what lets the recovery ladder re-plan
      under a shrunken device instead of failing fast.

  phase 2 — ``STAllocAllocator`` (runtime): hands out planned placements
    in profiled arrival order, verifying each request's rounded size
    against the plan. Any divergence — a request the profile never saw, a
    replay of a different trace — falls back to an embedded BFC pool on
    the same device, so the allocator is total: it serves any stream,
    planned or not. (Planned placements are only guaranteed disjoint when
    the profiled trace is what's being replayed — the same contract as
    STAlloc's own offline plans.) ``prepare`` is re-entrant: re-planning a
    used instance retires the live arena into a draining list whose
    reservation is released on the last outstanding free.

Registered as backend key ``"stalloc"`` with ``capabilities.planning``:
the replay harness calls ``prepare(trace)`` once, outside the timed loop.
"""

from __future__ import annotations

import heapq
import math
import random
import time
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Tuple

from .caching_allocator import (
    MIN_BLOCK_SIZE,
    Allocation,
    AllocatorOOM,
    CachingAllocator,
)
from .chunks import DeviceOOM, VMMDevice, round_up
from .metrics import AllocatorEventLog, AllocatorStats
from .protocol import AllocatorCapabilities
from .recovery import RecoveryConfig, recovery_enabled, run_ladder
from .registry import register

try:  # vectorized placement path; the object path below keeps parity
    import numpy as _np
except ImportError:  # pragma: no cover - numpy is part of the toolchain
    _np = None


class PlannedBlock:
    """A planned placement: one [offset, offset+size) slice of the arena."""

    __slots__ = ("offset", "size", "held", "arena")

    def __init__(self, offset: int, size: int, arena=None):
        self.offset = offset
        self.size = size
        self.held = True  # flipped by free; guards double-free
        self.arena = arena  # the reservation this placement lives in

    def __repr__(self):
        return f"PlannedBlock(off={self.offset}, size={self.size >> 20}MB)"


class _PlanArena:
    """One upfront arena reservation and its outstanding-block count.

    A re-entrant ``prepare`` retires the current arena; a retired arena's
    reservation is released the moment its last planned block is freed
    (drain-or-migrate, not fail-fast).
    """

    __slots__ = ("reserved", "live", "retired")

    def __init__(self, reserved: int):
        self.reserved = reserved
        self.live = 0
        self.retired = False


@dataclass(frozen=True)
class PlacementPlan:
    """Output of the offline planning pass: placements + peak capacity.

    ``offsets``/``sizes`` are parallel tuples indexed by *profiled arrival
    order* (the j-th alloc event of the trace). ``capacity`` is the peak
    watermark of the placement — the bytes the runtime reserves upfront.

    When the plan was built against a ``capacity`` budget, ``spilled``
    holds the arrival indices demoted out of the arena (their offset is
    ``-1``); the runtime serves those from its fallback pool.
    """

    capacity: int
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    static_bytes: int  # bottom region: trace-lifetime intervals
    n_events: int  # provenance: length of the profiled trace
    plan_seconds: float  # wall time of the planning pass itself
    spilled: FrozenSet[int] = field(default_factory=frozenset)
    spilled_bytes: int = 0
    #: peak *concurrent* bytes of the spill set — the fallback-pool
    #: headroom the runtime must leave next to the arena reservation
    spill_peak_bytes: int = 0

    @property
    def n_requests(self) -> int:
        return len(self.offsets)


def _profile_intervals(events, granularity: int):
    """Pass 1: (start_event, end_event, rounded_size) per alloc, in order.

    ``end_event`` is ``len(events)`` for allocations never freed in the
    profile — those are the static region.
    """
    n = len(events)
    starts: List[int] = []
    sizes: List[int] = []
    ends: List[int] = []
    open_req: Dict[int, int] = {}  # tid -> request index
    for i, ev in enumerate(events):
        if ev.op == "alloc":
            open_req[ev.tid] = len(starts)
            starts.append(i)
            sizes.append(round_up(ev.size, granularity))
            ends.append(n)  # provisional: lives forever
        elif ev.op == "free":
            j = open_req.pop(ev.tid, None)
            if j is not None:
                ends[j] = i
    return starts, ends, sizes


class _SpanAllocator:
    """Best-fit placement over an open-ended offset range (planner only).

    Free spans are kept offset-sorted and coalesced on free; allocation
    takes the smallest adequate span (lowest offset on ties) or extends
    the top watermark. This is the classical DSA heuristic the planning
    literature starts from; running it *offline* is what removes the
    online allocator's caching/segment overhead — the watermark IS the
    reservation.
    """

    __slots__ = ("base", "top", "peak", "spans")

    def __init__(self, base: int):
        self.base = base
        self.top = base  # end of the highest placement so far
        self.peak = base
        self.spans: List[List[int]] = []  # [offset, size], offset-ascending

    def alloc(self, size: int) -> int:
        best = -1
        best_size = 0
        for i, (off, sz) in enumerate(self.spans):
            if sz >= size and (best < 0 or sz < best_size):
                best = i
                best_size = sz
                if sz == size:
                    break
        if best < 0:
            off = self.top
            self.top = off + size
            if self.top > self.peak:
                self.peak = self.top
            return off
        off, sz = self.spans[best]
        if sz == size:
            self.spans.pop(best)
        else:
            self.spans[best] = [off + size, sz - size]
        return off

    def free(self, offset: int, size: int) -> None:
        spans = self.spans
        lo, hi = 0, len(spans)
        while lo < hi:  # insertion point by offset
            mid = (lo + hi) // 2
            if spans[mid][0] < offset:
                lo = mid + 1
            else:
                hi = mid
        # coalesce with the predecessor / successor where adjacent
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
        # a span touching the watermark retracts it (keeps spans compact)
        last = spans[-1]
        if last[0] + last[1] == self.top:
            self.top = last[0]
            spans.pop()


def _place_event_order(starts, ends, sizes, n_events, static_top):
    """Arrival-order best-fit placement with known lifetimes (round 3).

    Replays the interval endpoints in event order through best-fit over
    free spans. Each event index is one alloc or one free, and ``starts``
    is ascending by construction, so a single merged sweep visits every
    endpoint in trace order. Returns (offsets-for-transients, capacity).
    """
    offsets = [0] * len(starts)
    sim = _SpanAllocator(static_top)
    frees_at: Dict[int, int] = {}  # free-event index -> request index
    for j, end in enumerate(ends):
        if end < n_events:
            frees_at[end] = j
    k = 0  # next interval to place
    n_requests = len(starts)
    for i in range(n_events):
        j = frees_at.get(i)
        if j is not None:
            sim.free(offsets[j], sizes[j])
        elif k < n_requests and starts[k] == i:
            if ends[k] < n_events:
                offsets[k] = sim.alloc(sizes[k])
            k += 1
    return offsets, sim.peak


#: Above this many transient intervals the O(n^2) object-path size-ordered
#: placement is skipped: the quadratic pass costs minutes at ~60k
#: intervals. The vectorized path below replaces the all-pairs overlap
#: test with per-interval candidate lists (a start-ordered sweep), so it
#: stays tractable far beyond this — its own ceiling is a backstop only.
SIZE_ORDERED_MAX_INTERVALS = 20_000
SIZE_ORDERED_MAX_INTERVALS_VEC = 150_000


def _place_size_ordered(starts, ends, sizes, n_events, static_top, include=None):
    """Size-ordered offset assignment (round 4; the planning literature's
    classic DSA heuristic): place large intervals first, each at the lowest
    offset that is free across its whole lifetime.

    Arrival-order placement lets early small tensors claim low offsets and
    forces later large ones to stack above them; placing by descending size
    (ties broken by arrival, for determinism) lets the big intervals sit
    low and the small ones fill lifetime-disjoint holes around them — this
    is what cuts the training traces' planned fragmentation (BENCHMARKS.md
    §5.1). The per-interval scan is first-fit over the offset-sorted set of
    lifetime-overlapping placements — O(n^2) worst case, so callers skip it
    past ``SIZE_ORDERED_MAX_INTERVALS`` (the vectorized twin
    ``_place_size_ordered_vec`` reproduces it bit-for-bit and is preferred
    when numpy is available). ``include`` restricts placement to a subset
    of transient indices (capacity-budget demotion rounds). Returns
    (offsets, capacity).
    """
    offsets = [0] * len(starts)
    order = sorted(
        (
            j
            for j in range(len(starts))
            if ends[j] < n_events and (include is None or j in include)
        ),
        key=lambda j: (-sizes[j], j),
    )
    placed_s: List[int] = []
    placed_e: List[int] = []
    placed_off: List[int] = []
    placed_sz: List[int] = []
    peak = static_top
    for j in order:
        s, e, sz = starts[j], ends[j], sizes[j]
        overlaps = sorted(
            (placed_off[i], placed_sz[i])
            for i in range(len(placed_s))
            if placed_s[i] < e and s < placed_e[i]
        )
        off = static_top
        for po, psz in overlaps:
            if off + sz <= po:
                break  # the gap below this placement fits
            top = po + psz
            if top > off:
                off = top
        offsets[j] = off
        placed_s.append(s)
        placed_e.append(e)
        placed_off.append(off)
        placed_sz.append(sz)
        if off + sz > peak:
            peak = off + sz
    return offsets, peak


# ---------------------------------------------------------------------------
# vectorized strip-packing machinery (numpy flat-array domain)
# ---------------------------------------------------------------------------
#
# The placers below operate on the *transient* intervals only, as three
# flat int64 arrays (start event, end event, size) plus per-interval
# overlap candidate lists — the PR-7 ``_VecCore`` treatment applied to the
# planner. The candidate lists turn every "which placements overlap this
# lifetime?" query from an all-pairs scan into an indexed gather: on the
# serving traces the mean candidate count is ~16 per interval, so the
# whole placement drops from minutes to roughly a second at 60k intervals.


def _overlap_lists(ts, te):
    """Per-interval overlap candidates via a start-ordered sweep.

    ``ts`` is ascending by construction (one alloc per event index), so a
    single pass with an end-ordered heap of live intervals yields exactly
    the pairs with ``ts_j < te_k and ts_k < te_j``.
    """
    m = len(ts)
    overlaps: List[List[int]] = [[] for _ in range(m)]
    live: List[Tuple[int, int]] = []  # (end, index) min-heap
    ts_l = ts.tolist()
    te_l = te.tolist()
    for k in range(m):
        s = ts_l[k]
        while live and live[0][0] <= s:
            heapq.heappop(live)
        for _, j in live:
            overlaps[j].append(k)
            overlaps[k].append(j)
        heapq.heappush(live, (te_l[k], k))
    return [_np.array(o, dtype=_np.int64) for o in overlaps]


def _transient_arrays(starts, ends, sizes, n_events):
    """Split the profile into the flat transient-interval arrays."""
    trans = [j for j in range(len(starts)) if ends[j] < n_events]
    ts = _np.array([starts[j] for j in trans], dtype=_np.int64)
    te = _np.array([ends[j] for j in trans], dtype=_np.int64)
    tsz = _np.array([sizes[j] for j in trans], dtype=_np.int64)
    return trans, ts, te, tsz


def _lowest_fit(off_arr, sz_arr, ov, sz, floor):
    """Lowest offset >= floor free of every placed overlap in ``ov``.

    Mirrors the object path's scan exactly: walk placed overlaps in
    offset order, break at the first gap that fits, else sit on the
    highest conflicting top.
    """
    if len(ov) == 0:
        return floor
    o = off_arr[ov]
    z = sz_arr[ov]
    srt = _np.argsort(o, kind="stable")
    o = o[srt]
    z = z[srt]
    off = floor
    for po, pz in zip(o.tolist(), z.tolist()):
        if off + sz <= po:
            break
        top = po + pz
        if top > off:
            off = top
    return off


def _fit_below(off_arr, sz_arr, ov, sz, floor, limit):
    """Best-fit into the smallest gap wholly below ``limit``; fall back to
    the lowest fit (possibly above the limit) when no bounded gap exists.
    Used by the polish pass to pull intervals down without re-stacking
    them straight back over the target watermark."""
    if len(ov) == 0:
        return floor
    o = off_arr[ov]
    z = sz_arr[ov]
    srt = _np.argsort(o, kind="stable")
    o = o[srt]
    z = z[srt]
    best_off = None
    best_waste = None
    cur = floor
    for po, pz in zip(o.tolist(), z.tolist()):
        if po > cur:
            gap = po - cur
            if gap >= sz and cur + sz <= limit:
                waste = gap - sz
                if best_waste is None or waste < best_waste:
                    best_off, best_waste = cur, waste
        top = po + pz
        if top > cur:
            cur = top
    return cur if best_off is None else best_off


def _ffd(tsz, overlaps, static_top, order=None):
    """First-fit decreasing-size over the overlap candidate lists.

    With the default order this computes exactly the object-path
    size-ordered placement (same (-size, index) order, same
    first-fit-lowest scan), only via indexed gathers. Returns the per-
    transient offset array; entries outside ``order`` stay ``-1``.
    """
    m = len(tsz)
    szl = tsz.tolist()
    if order is None:
        order = sorted(range(m), key=lambda k: (-szl[k], k))
    off_arr = _np.full(m, -1, dtype=_np.int64)
    placed = _np.zeros(m, dtype=bool)
    for k in order:
        ov = overlaps[k]
        ov = ov[placed[ov]]
        off_arr[k] = _lowest_fit(off_arr, tsz, ov, szl[k], static_top)
        placed[k] = True
    return off_arr


def _place_size_ordered_vec(starts, ends, sizes, n_events, static_top):
    """Vectorized twin of ``_place_size_ordered`` — bit-identical offsets,
    built on flat arrays + overlap candidate lists instead of the
    all-pairs interval test. Returns (offsets, capacity)."""
    trans, ts, te, tsz = _transient_arrays(starts, ends, sizes, n_events)
    offsets = [0] * len(starts)
    if not trans:
        return offsets, static_top
    overlaps = _overlap_lists(ts, te)
    off_arr = _ffd(tsz, overlaps, static_top)
    for k, j in enumerate(trans):
        offsets[j] = int(off_arr[k])
    peak = max(int((off_arr + tsz).max()), static_top)
    return offsets, peak


def _transient_peak_active(ts, te, tsz, n_events):
    """Peak concurrently-live transient bytes (placement lower bound)."""
    if len(ts) == 0:
        return 0
    delta = _np.zeros(n_events + 1, dtype=_np.int64)
    _np.add.at(delta, ts, tsz)
    _np.add.at(delta, te, -tsz)
    return int(delta.cumsum().max())


#: re-plan recovery rung: budget-walk rounds and fallback-pool slack
_REPLAN_MAX_ROUNDS = 4
_REPLAN_SLACK = 256 << 20

#: polish-pass tuning (see ``_polish_packing``); all deterministic
_POLISH_STEP = 256 << 20  # initial target-capacity decrement
_POLISH_MIN_STEP = 16 << 20
_POLISH_TEMP0 = 48 << 20  # initial annealing temperature (bytes overflow)
_POLISH_MAX_VICTIMS = 60
_POLISH_STALL_LIMIT = 6000  # non-improving iterations before step-halving
POLISH_MIN_ITERS = 20_000
POLISH_MAX_ITERS = 100_000
#: skip the polish when FFD is already within 5% of the placement lower
#: bound (static bytes + peak live transient bytes) — training-shaped
#: traces land well under this and keep their fast plan times.
POLISH_SKIP_WITHIN_PCT = 5


def _polish_packing(tsz, overlaps, static_top, off_arr, max_iters, seed=0):
    """Directed annealed ruin-and-recreate over an existing packing.

    The greedy placements handle training-shaped traces (layered, highly
    regular lifetimes) well but leave serving-shaped traces — a sliding
    window of wildly varied request sizes — ~15% fragmented. This pass
    closes most of that gap: hold a target capacity ``T`` just below the
    best known, and drive the total overflow above ``T`` to zero by
    repeatedly *ruining* a victim set around a random overflowing interval
    (its lifetime-overlaps sitting in the top ``1-theta`` band) and
    *recreating* it in randomized order with a mix of lowest-fit and
    bounded best-fit. Worsening moves are accepted with simulated-
    annealing probability ``exp(-d_overflow/temp)``; a long stall halves
    the capacity step and restarts from the best packing found. Once
    feasible at ``T``, the target drops another step.

    Deterministic by construction: iteration-bounded (never wall-clock
    bounded) and driven by a seeded ``random.Random`` — the same inputs
    always yield the same packing, which is what keeps the hybrid
    backend's golden digests bit-stable. Returns (capacity, offsets).
    """
    m = len(tsz)
    if m == 0 or max_iters <= 0:
        return static_top, off_arr
    rng = random.Random(seed)
    szl = tsz.tolist()
    placed = _np.ones(m, dtype=bool)
    tops = off_arr + tsz
    best_cap = cap = int(tops.max())
    best_off = off_arr.copy()
    step = _POLISH_STEP
    target = cap - step
    stall = 0
    for it in range(max_iters):
        tops = off_arr + tsz
        over_idx = _np.nonzero(tops > target)[0]
        if len(over_idx) == 0:  # feasible at T: bank it, tighten T
            cap = int(tops.max())
            if cap < best_cap:
                best_cap = cap
                best_off = off_arr.copy()
            target = cap - step
            stall = 0
            continue
        overflow = int((tops[over_idx] - target).sum())
        seed_k = int(over_idx[rng.randrange(len(over_idx))])
        theta = rng.uniform(0.3, 0.9)
        lo = static_top + int((target - static_top) * theta)
        victims = [seed_k] + [
            int(x) for x in overlaps[seed_k] if tops[x] >= lo
        ]
        if len(victims) > _POLISH_MAX_VICTIMS:
            victims = rng.sample(victims, _POLISH_MAX_VICTIMS)
            if seed_k not in victims:
                victims.append(seed_k)
        saved = off_arr[victims].copy()
        placed[victims] = False
        order = victims[:]
        r = rng.random()
        if r < 0.35:
            rng.shuffle(order)
        elif r < 0.75:
            order.sort(key=lambda k: (-szl[k], k))
        else:
            order.sort(key=lambda k: (szl[k], k))
        use_bestfit = rng.random() < 0.5
        for k in order:
            ov = overlaps[k]
            ov = ov[placed[ov]]
            if use_bestfit:
                off_arr[k] = _fit_below(off_arr, tsz, ov, szl[k], static_top, target)
            else:
                off_arr[k] = _lowest_fit(off_arr, tsz, ov, szl[k], static_top)
            placed[k] = True
        new_tops = off_arr + tsz
        new_overflow = int(_np.maximum(new_tops - target, 0).sum())
        d_overflow = new_overflow - overflow
        temp = _POLISH_TEMP0 * (1.0 - it / max_iters)
        if d_overflow <= 0 or (
            temp > 0 and rng.random() < math.exp(-d_overflow / temp)
        ):
            stall = stall + 1 if d_overflow >= 0 else 0
        else:
            off_arr[victims] = saved
            placed[victims] = True
            stall += 1
        if stall > _POLISH_STALL_LIMIT:
            step = max(step // 2, _POLISH_MIN_STEP)
            target = best_cap - step
            off_arr[:] = best_off
            placed[:] = True
            stall = 0
    return best_cap, best_off


def _auto_polish_iters(m, ffd_cap, lower_bound):
    """Deterministic polish budget: skip when FFD is already near the
    lower bound, else scale with the transient count (bounded)."""
    if ffd_cap * 100 <= lower_bound * (100 + POLISH_SKIP_WITHIN_PCT):
        return 0
    return min(POLISH_MAX_ITERS, max(POLISH_MIN_ITERS, 2 * m))


def build_plan(
    trace,
    granularity: int = MIN_BLOCK_SIZE,
    *,
    capacity: Optional[int] = None,
    packed: bool = False,
    polish_iters: Optional[int] = None,
    polish_seed: int = 0,
) -> PlacementPlan:
    """The offline spatio-temporal planning pass (see module docstring).

    Runs the transient placements — arrival-order best-fit, size-ordered
    first-fit, and (``packed=True``) the ruin-and-recreate polish — and
    keeps whichever needs the smallest arena (better algorithms win
    ties); the plan is offline, so trying them all costs nothing on the
    replay path.

    ``capacity`` fits the plan to a device budget: when the best placement
    exceeds it, the worst-fitting transients (those placed above the
    budget line) are demoted to the plan's *spill set* round by round
    until the remainder fits. Statics are never spilled — the static
    region is the plan's floor even when it exceeds the budget (callers
    see that as ``plan.capacity > capacity`` and give up).
    """
    t0 = time.perf_counter()
    events = getattr(trace, "events", trace)
    starts, ends, sizes = _profile_intervals(events, granularity)
    n_events = len(events)

    # static region: intervals alive at end-of-trace stack at the bottom in
    # arrival order. They can never be freed mid-run, so nothing above them
    # ever has to route around a hole they leave.
    static_offsets: List[int] = [0] * len(starts)
    static_top = 0
    for j, end in enumerate(ends):
        if end >= n_events:
            static_offsets[j] = static_top
            static_top += sizes[j]

    ev_offsets, ev_cap = _place_event_order(starts, ends, sizes, n_events, static_top)
    n_transient = sum(1 for end in ends if end < n_events)

    # candidates: (capacity, rank, offsets) — lower rank wins ties, so the
    # packed polish beats size-ordered beats arrival-order at equal cost.
    candidates = [(ev_cap, 2, ev_offsets)]
    vec = None  # flat-array machinery, reused by polish and demotion
    if _np is not None and 0 < n_transient <= SIZE_ORDERED_MAX_INTERVALS_VEC:
        trans, ts, te, tsz = _transient_arrays(starts, ends, sizes, n_events)
        overlaps = _overlap_lists(ts, te)
        off_arr = _ffd(tsz, overlaps, static_top)
        so_cap = max(int((off_arr + tsz).max()), static_top)
        so_offsets = [0] * len(starts)
        for k, j in enumerate(trans):
            so_offsets[j] = int(off_arr[k])
        candidates.append((so_cap, 1, so_offsets))
        vec = (trans, ts, te, tsz, overlaps, off_arr, so_cap)
    elif n_transient <= SIZE_ORDERED_MAX_INTERVALS:
        so_offsets, so_cap = _place_size_ordered(
            starts, ends, sizes, n_events, static_top
        )
        candidates.append((so_cap, 1, so_offsets))

    if packed and vec is not None:
        trans, ts, te, tsz, overlaps, off_arr, so_cap = vec
        iters = polish_iters
        if iters is None:
            lower_bound = static_top + _transient_peak_active(ts, te, tsz, n_events)
            iters = _auto_polish_iters(len(trans), so_cap, lower_bound)
        if iters > 0:
            pk_cap, pk_off = _polish_packing(
                tsz, overlaps, static_top, off_arr.copy(), iters, seed=polish_seed
            )
            pk_offsets = [0] * len(starts)
            for k, j in enumerate(trans):
                pk_offsets[j] = int(pk_off[k])
            candidates.append((max(pk_cap, static_top), 0, pk_offsets))

    cap, _, offsets = min(candidates, key=lambda c: (c[0], c[1]))

    spilled: FrozenSet[int] = frozenset()
    spilled_bytes = 0
    spill_peak = 0
    if capacity is not None and cap > max(int(capacity), static_top):
        budget = max(int(capacity), static_top)
        offsets, cap, spilled = _demote_to_budget(
            starts, ends, sizes, n_events, static_top, budget, vec
        )
        spilled_bytes = sum(sizes[j] for j in spilled)
        spill_peak = _spill_peak(starts, ends, sizes, n_events, spilled)

    for j, end in enumerate(ends):  # statics share every placement's bottom
        if end >= n_events:
            offsets[j] = static_offsets[j]

    return PlacementPlan(
        capacity=cap,
        offsets=tuple(offsets),
        sizes=tuple(sizes),
        static_bytes=static_top,
        n_events=n_events,
        plan_seconds=time.perf_counter() - t0,
        spilled=spilled,
        spilled_bytes=spilled_bytes,
        spill_peak_bytes=spill_peak,
    )


def _spill_peak(starts, ends, sizes, n_events, spilled):
    """Peak concurrently-live bytes across the spilled intervals."""
    if not spilled:
        return 0
    deltas: Dict[int, int] = {}
    for j in spilled:
        deltas[starts[j]] = deltas.get(starts[j], 0) + sizes[j]
        end = min(ends[j], n_events)
        deltas[end] = deltas.get(end, 0) - sizes[j]
    peak = cur = 0
    for i in sorted(deltas):
        cur += deltas[i]
        if cur > peak:
            peak = cur
    return peak


def _demote_to_budget(starts, ends, sizes, n_events, static_top, budget, vec):
    """Fit the transient placement under ``budget`` by spilling offenders.

    Round by round: place the kept set size-ordered, demote every interval
    whose placement tops out above the budget line, repeat until the rest
    fits. Deterministic and monotone (the kept set only shrinks), so it
    always terminates — in the limit every transient spills and the plan
    is just the static region. Returns (offsets, capacity, spilled).
    """
    if vec is not None:
        trans, ts, te, tsz, overlaps, _off, _cap = vec
        m = len(trans)
        szl = tsz.tolist()
        base_order = sorted(range(m), key=lambda k: (-szl[k], k))
        keep = _np.ones(m, dtype=bool)
        while True:
            order = [k for k in base_order if keep[k]]
            off_arr = _ffd(tsz, overlaps, static_top, order=order)
            tops = off_arr + tsz
            over = keep & (tops > budget)
            if not bool(over.any()):
                break
            keep &= ~over
        offsets = [0] * len(starts)
        spilled = set()
        cap = static_top
        for k, j in enumerate(trans):
            if keep[k]:
                offsets[j] = int(off_arr[k])
                cap = max(cap, int(tops[k]))
            else:
                offsets[j] = -1
                spilled.add(j)
        return offsets, cap, frozenset(spilled)

    # object-path fallback (no numpy): same loop over the quadratic placer
    include = {j for j in range(len(starts)) if ends[j] < n_events}
    while True:
        offsets, cap = _place_size_ordered(
            starts, ends, sizes, n_events, static_top, include=include
        )
        over = {j for j in include if offsets[j] + sizes[j] > budget}
        if not over:
            break
        include -= over
    spilled = {
        j for j in range(len(starts)) if ends[j] < n_events and j not in include
    }
    for j in spilled:
        offsets[j] = -1
    cap = max(
        [static_top] + [offsets[j] + sizes[j] for j in include]
    )
    return offsets, cap, frozenset(spilled)


@register(
    "stalloc",
    AllocatorCapabilities(
        caching=True, planning=True, releases_cached=True, recovery=True
    ),
)
class STAllocAllocator:
    """Runtime half of the planner: planned placements + BFC fallback.

    The runtime hot path is deliberately thin — a planned malloc costs one
    tuple index and one size comparison, a planned free costs one stats
    update, and the device model is charged ONE ``cuMalloc`` for the whole
    plan (the paper-world equivalent of a single upfront reservation).
    Everything the profile did not predict goes to the embedded BFC pool.
    """

    name = "stalloc"

    def __init__(
        self,
        device: VMMDevice,
        plan: Optional[PlacementPlan] = None,
        record_timeline: bool = False,
        granularity: int = MIN_BLOCK_SIZE,
        recovery: Optional[bool] = None,
    ):
        self.device = device
        self.stats = AllocatorStats(record_timeline=record_timeline)
        self.plan = plan
        self.granularity = granularity
        self._cursor = 0  # arrival index of the next planned request
        self._plan_reserved = 0  # chunk-rounded plan.capacity once reserved
        self._arena: Optional[_PlanArena] = None
        self._draining: List[_PlanArena] = []  # retired arenas, live > 0
        self._draining_bytes = 0  # cached sum of draining reservations
        self._last_trace = None  # profiled trace, kept for re-planning
        # staged OOM recovery (auto-on under a fault-injecting device); the
        # fallback pool shares this allocator's event log and ladder setting
        self._recovery_on = recovery_enabled(device, recovery)
        self._recovery_cfg = RecoveryConfig()
        self.event_log = AllocatorEventLog()
        self._fallback = self._make_fallback()
        self.planned_allocs = 0
        self.planned_bytes = 0
        self.fallback_allocs = 0
        self.fallback_bytes = 0

    def _make_fallback(self):
        """Pool serving everything the plan does not cover. Subclasses
        swap this out (the hybrid backend embeds a stitching core)."""
        return CachingAllocator(
            self.device, recovery=self._recovery_on, event_log=self.event_log
        )

    def _plan_opts(self) -> dict:
        """Extra ``build_plan`` options; the hybrid backend turns on the
        packed placer here."""
        return {}

    # -- planning hooks -------------------------------------------------------
    @property
    def needs_prepare(self) -> bool:
        return self.plan is None

    def prepare(self, trace, capacity: Optional[int] = None) -> PlacementPlan:
        """Profile + plan ``trace`` (phase 1). Called off the timed path.

        Re-entrant: planning on a used instance retires the live arena —
        outstanding planned blocks keep their placements and the old
        reservation is released when the last of them is freed — then
        resets the cursor against the fresh plan. ``capacity`` forwards a
        device budget to ``build_plan`` (see its spill-set contract).
        """
        if self._cursor or self._plan_reserved:
            self._retire_arena()
        self.plan = build_plan(
            trace, self.granularity, capacity=capacity, **self._plan_opts()
        )
        self._last_trace = trace
        self._cursor = 0
        return self.plan

    def _retire_arena(self) -> None:
        arena = self._arena
        if arena is not None:
            arena.retired = True
            if arena.live > 0:
                # drain-or-migrate: outstanding planned blocks keep their
                # placements; the reservation is released on the last free
                self._draining.append(arena)
                self._draining_bytes += arena.reserved
                self.event_log.append("arena_retired", size=arena.reserved)
            else:
                self._release_arena(arena)
        self._arena = None
        self._plan_reserved = 0
        self._cursor = 0

    def _release_arena(self, arena: _PlanArena) -> None:
        if arena.reserved:
            self.device.cu_free(arena.reserved, synchronize=False)
            self.event_log.append("arena_drained", size=arena.reserved)
            if arena in self._draining:
                self._draining.remove(arena)
                self._draining_bytes -= arena.reserved
            arena.reserved = 0

    # -- accounting -----------------------------------------------------------
    @property
    def reserved_bytes(self) -> int:
        return (
            self._plan_reserved + self._draining_bytes + self._fallback.reserved_bytes
        )

    def release_cached(self) -> int:
        """The planned arena is one live reservation sized to the plan's
        peak — nothing cached there to give back; the fallback pool's free
        segments are released."""
        return self._fallback.release_cached()

    # -- allocation -----------------------------------------------------------
    def _reserve_arena(self) -> None:
        cap = self.plan.capacity
        if not cap:
            return
        # the replan rung may swap self.plan, so the attempt re-reads it
        attempt = lambda: self.device.cu_malloc(self.plan.capacity)
        if self._recovery_on:
            stages = [
                ("release_fallback_cache", self._fallback.release_cached),
            ]
            if self._last_trace is not None:
                # structural rung: re-plan the profiled trace to the
                # device's shrunken capacity, spilling what no longer
                # fits. Skipped on transient faults — those are what the
                # ladder's bounded retries are for.
                stages.append(("replan_to_capacity", self._replan_to_fit, True))
            try:
                run_ladder(
                    attempt,
                    stages,
                    device=self.device,
                    log=self.event_log,
                    config=self._recovery_cfg,
                    what=f"arena:{cap}",
                )
            except DeviceOOM as e:
                raise AllocatorOOM(
                    f"{self.name} plan needs {self.plan.capacity} bytes upfront "
                    f"(device_free={self.device.free_bytes})"
                ) from e
        else:
            try:
                attempt()
            except DeviceOOM as e:
                raise AllocatorOOM(
                    f"{self.name} plan needs {cap} bytes upfront "
                    f"(device_free={self.device.free_bytes})"
                ) from e
        # the device rounds cu_malloc up to its chunk granularity, so the
        # published reservation must too — otherwise ``reserved_bytes``
        # undercounts device ``used_bytes`` by up to a chunk and the
        # drain agreement (device used == backend reserved) breaks
        reserved = round_up(self.plan.capacity, self.device.chunk_size)
        self._plan_reserved = reserved
        self._arena = _PlanArena(reserved)

    def _replan_to_fit(self) -> int:
        """Recovery rung: re-plan to the device's current free capacity.

        Only meaningful before any placement was handed out (the arena is
        reserved lazily at the first planned malloc, so a post-shrink OOM
        lands exactly here with the cursor still at zero). The new plan
        demotes what no longer fits to its spill set; the rung reports the
        capacity it gave up and the ladder re-attempts the reservation.
        """
        if self._last_trace is None or self._cursor or self.plan is None:
            return 0
        free = self.device.free_bytes
        old_cap = self.plan.capacity
        if free <= 0 or free >= old_cap:
            return 0
        # re-planning under pressure always spends the packed placer's
        # polish budget: its ruin-and-recreate pass is a target-capacity
        # feasibility solver, so a moderate shrink is usually absorbed by
        # packing tighter — no spill set at all. Only when packing cannot
        # reach the budget does demotion kick in, and then the spill set
        # needs fallback-pool headroom *next to* the arena: spilling more
        # shrinks the arena but grows the headroom, so walk the budget down
        # until arena + spill peak (+ slack for fallback rounding) fits.
        opts = dict(self._plan_opts())
        opts.setdefault("packed", True)
        budget = free - _REPLAN_SLACK
        for _ in range(_REPLAN_MAX_ROUNDS):
            if budget <= 0:
                break
            plan = build_plan(
                self._last_trace, self.granularity, capacity=budget, **opts
            )
            need = plan.capacity + plan.spill_peak_bytes + _REPLAN_SLACK
            if plan.capacity <= budget and need <= free:
                self.plan = plan
                return old_cap - plan.capacity
            next_budget = free - plan.spill_peak_bytes - _REPLAN_SLACK
            if next_budget >= budget:  # no progress possible
                break
            budget = next_budget
        return 0  # even the static floor + spill headroom cannot fit

    def malloc(self, size: int) -> Allocation:
        plan = self.plan
        j = self._cursor
        rsize = round_up(size, self.granularity)
        if plan is not None and j < len(plan.sizes) and plan.sizes[j] == rsize:
            if j in plan.spilled:
                # capacity-budget demotion: profiled, but planned OUT of
                # the arena — serve from the fallback pool, cursor moves.
                self._cursor = j + 1
                return self._fallback_malloc(size)
            if not self._plan_reserved:
                if self._recovery_on:
                    try:
                        self._reserve_arena()
                    except AllocatorOOM:
                        # fallback-region spill: the plan's upfront arena
                        # cannot be reserved on a shrunken/faulty device
                        # even after the ladder. Serve this request from
                        # the BFC pool instead of failing the replay; the
                        # cursor stays put, so the next planned request
                        # retries the reservation.
                        self.event_log.append("spill_to_fallback", size=rsize)
                        return self._fallback_malloc(size)
                else:
                    self._reserve_arena()
                # the replan rung may have spilled this very request
                if j in self.plan.spilled:
                    self._cursor = j + 1
                    return self._fallback_malloc(size)
                plan = self.plan
            self._cursor = j + 1
            self.planned_allocs += 1
            self.planned_bytes += rsize
            arena = self._arena
            if arena is not None:
                arena.live += 1
            block = PlannedBlock(plan.offsets[j], rsize, arena)
            self.stats.on_alloc(rsize, self.reserved_bytes)
            return Allocation(
                req_size=size, block_size=rsize, block=block, owner=self
            )
        # divergence from the profile: serve from the BFC pool instead. The
        # cursor does not advance, so one unexpected request cannot shift
        # every subsequent planned placement out of alignment.
        return self._fallback_malloc(size)

    def _fallback_malloc(self, size: int) -> Allocation:
        alloc = self._fallback.malloc(size)
        alloc.owner = self
        self.fallback_allocs += 1
        self.fallback_bytes += alloc.block_size
        # the fallback already counted itself; ours is the published stats
        self.stats.on_alloc(alloc.block_size, self.reserved_bytes)
        return alloc

    def free(self, alloc: Allocation) -> None:
        block = alloc.block
        if isinstance(block, PlannedBlock):
            assert block.held, "double free of planned block"
            block.held = False
            arena = block.arena
            if arena is not None:
                arena.live -= 1
                if arena.retired and arena.live == 0:
                    self._release_arena(arena)
            self.stats.on_free(alloc.block_size, self.reserved_bytes)
            return
        self._fallback.free(alloc)
        self.stats.on_free(alloc.block_size, self.reserved_bytes)

    # -- debug / test support -------------------------------------------------
    def check_invariants(self) -> None:
        if self.plan is not None:
            assert self._cursor <= self.plan.n_requests
            assert self._plan_reserved in (
                0, round_up(self.plan.capacity, self.device.chunk_size)
            )
        else:
            assert self._cursor == 0 and self._plan_reserved == 0
        drain_total = 0
        for arena in self._draining:
            assert arena.retired and arena.live > 0 and arena.reserved > 0
            drain_total += arena.reserved
        assert drain_total == self._draining_bytes
        self._fallback.check_invariants()


__all__ = [
    "PlacementPlan",
    "PlannedBlock",
    "STAllocAllocator",
    "build_plan",
]
