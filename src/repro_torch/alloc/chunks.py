"""Chunk/extent primitives and the VMM device model.

GMLake's physical unit is a fixed-size chunk (2 MB in the paper, §3.1). On
GPU these are physical pages created by ``cuMemCreate``; on TPU we adapt them
to slots of a pre-reserved HBM arena (see DESIGN.md §2). This module holds:

  * the chunk-size constants and rounding helpers,
  * ``Extent`` — a run of consecutive chunk ids (the unit of the extent
    tables consumed by the Pallas stitch kernels),
  * ``VMMDevice`` — a device model that tracks physical-chunk inventory and
    charges per-API costs calibrated from the paper's own measurements
    (Table 1 / Fig. 6), in units of one ``cuMalloc`` call.

The device model is what lets the benchmarks regenerate the paper's latency
microbenchmarks on hardware that has no CUDA driver.
"""

from __future__ import annotations

import itertools
import json
import math
import random
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

try:  # the array fast paths need numpy; the scalar paths must not
    import numpy as np
except ImportError:  # pragma: no cover - exercised via subprocess guard test
    np = None

MB = 1024 * 1024
GB = 1024 * MB

#: GMLake uses a uniform 2 MB chunk (paper §3.1).
CHUNK_SIZE = 2 * MB

#: Requests below one chunk fall through to the splitting (caching) pool.
SMALL_ALLOC_LIMIT = CHUNK_SIZE

#: "minimal fragmentation limit ... (e.g., 128 MB)" — paper §4.2.3.
DEFAULT_FRAG_LIMIT = 128 * MB


def round_up(size: int, granularity: int = CHUNK_SIZE) -> int:
    if size <= 0:
        raise ValueError(f"allocation size must be positive, got {size}")
    return ((size + granularity - 1) // granularity) * granularity


def num_chunks(size: int) -> int:
    return round_up(size) // CHUNK_SIZE


@dataclass(frozen=True)
class Extent:
    """A run of ``n`` consecutive chunks starting at chunk id ``start``.

    Extent tables (lists of extents) are the TPU-side replacement for the
    GPU's VA->PA page mapping: the Pallas kernels walk them with scalar
    prefetch to issue chunk-granular DMA.
    """

    start: int
    n: int

    def __post_init__(self) -> None:
        if self.start < 0 or self.n <= 0:
            raise ValueError(f"bad extent ({self.start}, {self.n})")

    @property
    def stop(self) -> int:
        return self.start + self.n

    @property
    def nbytes(self) -> int:
        return self.n * CHUNK_SIZE


class ChunkRun:
    """An immutable view over a slice of a chunk-id list — O(1) splits.

    GMLake's Split divides a pBlock's ordered chunk list; copying the two
    halves is O(chunks) per split (pBlocks span up to ~1600 chunks on the
    serving traces). ``ChunkRun`` shares the backing list instead: slicing
    returns a new view over the same storage, so Split's chunk bookkeeping
    is O(1) regardless of block size. The backing list is never mutated —
    Alloc creates it, Split only ever narrows views — which is what makes
    sharing safe. Views compare equal to any sequence with the same ids,
    so consumers (extent packing, kernels, tests) treat them as lists.
    """

    __slots__ = ("base", "start", "stop", "_arr")

    def __init__(self, base: List[int], start: int = 0, stop: Optional[int] = None):
        self.base = base
        self.start = start
        self.stop = len(base) if stop is None else stop
        self._arr = None

    def asarray(self):
        """The view's ids as an int64 array (cached — the backing list is
        immutable by the ChunkRun contract, so the array can never go
        stale). Requires numpy; the scalar paths never call this."""
        arr = self._arr
        if arr is None:
            arr = np.asarray(self.base[self.start : self.stop], dtype=np.int64)
            self._arr = arr
        return arr

    def __len__(self) -> int:
        return self.stop - self.start

    def __iter__(self):
        if self.start == 0 and self.stop == len(self.base):
            return iter(self.base)
        return iter(self.base[self.start : self.stop])

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step != 1:
                return self.base[self.start + start : self.start + stop : step]
            return ChunkRun(self.base, self.start + start, self.start + stop)
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError("ChunkRun index out of range")
        return self.base[self.start + i]

    def __eq__(self, other) -> bool:
        if isinstance(other, ChunkRun):
            return list(self) == list(other)
        if isinstance(other, (list, tuple)):
            return list(self) == list(other)
        return NotImplemented

    def __repr__(self) -> str:
        return f"ChunkRun({list(self)!r})"


def _pack_ids_array(a) -> List[Extent]:
    """Vectorized run-length compression of an int64 id array: one compare
    finds every run break, the Extents are read off the break positions.
    Output is identical to the scalar scan — same runs, same order."""
    n = len(a)
    breaks = np.flatnonzero(a[1:] != a[:-1] + 1) + 1
    starts = np.concatenate(([0], breaks))
    stops = np.concatenate((breaks, [n]))
    return [
        Extent(int(a[s]), int(e - s))
        for s, e in zip(starts.tolist(), stops.tolist())
    ]


def pack_extents(chunk_ids: Iterable[int]) -> List[Extent]:
    """Compress an ordered chunk-id list into maximal consecutive runs."""
    if np is not None:
        if isinstance(chunk_ids, ChunkRun):
            a = chunk_ids.asarray()
        else:
            a = np.fromiter(chunk_ids, dtype=np.int64)
        if len(a):
            return _pack_ids_array(a)
        return []
    out: List[Extent] = []
    for cid in chunk_ids:
        if out and cid == out[-1].stop:
            out[-1] = Extent(out[-1].start, out[-1].n + 1)
        else:
            out.append(Extent(cid, 1))
    return out


def pack_extent_runs(chunk_runs: Iterable[Iterable[int]]) -> List[Extent]:
    """``pack_extents`` over a sequence of chunk-id runs without concatenating.

    Runs merge across boundaries exactly as if the ids were one flat list —
    this is the extent-table builder for stitched blocks, whose chunk ids
    live in per-member lists. With numpy, member ChunkRuns contribute their
    cached id arrays and one concatenate feeds the vectorized packer.
    """
    if np is not None:
        parts = [
            r.asarray() if isinstance(r, ChunkRun) else np.fromiter(r, dtype=np.int64)
            for r in chunk_runs
        ]
        parts = [p for p in parts if len(p)]
        if not parts:
            return []
        return _pack_ids_array(parts[0] if len(parts) == 1 else np.concatenate(parts))
    return pack_extents(itertools.chain.from_iterable(chunk_runs))


def unpack_extents(extents: Iterable[Extent]) -> List[int]:
    out: List[int] = []
    for e in extents:
        out.extend(range(e.start, e.stop))
    return out


# ---------------------------------------------------------------------------
# VMM cost model (paper Table 1 / Fig. 6)
# ---------------------------------------------------------------------------

# Per-allocation totals from Table 1: allocating 2 GB out of chunks of the
# given size, normalized to one cuMalloc call of the full 2 GB. We divide by
# the number of per-chunk calls to get per-call costs and interpolate in
# log-log space for intermediate chunk sizes.
_TABLE1_CHUNK_SIZES = (2 * MB, 128 * MB, 1024 * MB)
_TABLE1_CALLS = tuple(2 * GB // s for s in _TABLE1_CHUNK_SIZES)  # (1024, 16, 2)
_TABLE1_TOTALS = {
    # api: totals at chunk sizes 2MB / 128MB / 1024MB (in cuMalloc units)
    "cuMemAddressReserve": (0.003, 0.003, 0.002),  # one call per allocation
    "cuMemCreate": (18.1, 0.89, 0.79),
    "cuMemMap": (0.70, 0.01, 0.002),
    "cuMemSetAccess": (96.8, 8.2, 0.7),
}

#: cuMalloc / cuFree cost: the unit. cudaFree additionally synchronizes the
#: device; the ~10x end-to-end gap between the native allocator and the
#: caching allocator (paper §2.2) comes from those synchronizations stalling
#: pending kernels, which we fold into a sync surcharge.
CUMALLOC_COST = 1.0
CUFREE_COST = 1.0
DEVICE_SYNC_COST = 4.0


@lru_cache(maxsize=None)
def _per_call_cost(api: str, chunk_size: int) -> float:
    """Pure log-log interpolation of Table 1; cached — it sits on the
    per-allocation ledger path and only ever sees a handful of chunk sizes."""
    totals = _TABLE1_TOTALS[api]
    if api == "cuMemAddressReserve":
        # one call regardless of chunking; interpolate the totals directly
        per = totals
        calls = (1, 1, 1)
    else:
        per = tuple(t / c for t, c in zip(totals, _TABLE1_CALLS))
        calls = _TABLE1_CALLS
    xs = [math.log(s) for s in _TABLE1_CHUNK_SIZES]
    ys = [math.log(p) for p in per]
    x = math.log(min(max(chunk_size, _TABLE1_CHUNK_SIZES[0]), _TABLE1_CHUNK_SIZES[-1]))
    # piecewise-linear in log-log space
    if x <= xs[1]:
        t = (x - xs[0]) / (xs[1] - xs[0])
        y = ys[0] + t * (ys[1] - ys[0])
    else:
        t = (x - xs[1]) / (xs[2] - xs[1])
        y = ys[1] + t * (ys[2] - ys[1])
    return math.exp(y)


@dataclass
class VMMCostLedger:
    """Accumulated modeled device-API cost, in cuMalloc units."""

    by_api: dict = field(default_factory=dict)

    def charge(self, api: str, cost: float, calls: int = 1) -> None:
        entry = self.by_api.setdefault(api, [0.0, 0])
        entry[0] += cost
        entry[1] += calls

    @property
    def total(self) -> float:
        return sum(v[0] for v in self.by_api.values())

    @property
    def total_calls(self) -> int:
        return sum(v[1] for v in self.by_api.values())

    def snapshot(self) -> dict:
        return {k: tuple(v) for k, v in self.by_api.items()}


class DeviceOOM(MemoryError):
    """Raised by the device model when physical capacity is exhausted."""


class TransientDeviceError(DeviceOOM):
    """An injected *transient* VMM API failure (see ``FaultInjector``).

    Subclasses ``DeviceOOM`` so every existing ``except DeviceOOM`` site
    still contains it — a fault can never escape a backend as a raw device
    error — while recovery-aware backends can distinguish a retryable
    driver hiccup from genuine capacity exhaustion.
    """


class VMMDevice:
    """Physical-memory inventory + API cost model.

    Models a device with ``capacity_bytes`` of HBM, handing out 2 MB
    physical chunks (``cu_mem_create``) or classic contiguous segments
    (``cu_malloc``). Contiguity of chunk ids is *not* guaranteed — freed
    chunks are recycled LIFO, exactly the property that forces stitching.
    """

    def __init__(self, capacity_bytes: int, chunk_size: int = CHUNK_SIZE):
        if capacity_bytes % chunk_size:
            raise ValueError("capacity must be a multiple of the chunk size")
        self.capacity_bytes = capacity_bytes
        self.chunk_size = chunk_size
        self.total_chunks = capacity_bytes // chunk_size
        self._free_chunks: List[int] = list(range(self.total_chunks - 1, -1, -1))
        self._segment_bytes = 0  # bytes held by cu_malloc segments
        self.ledger = VMMCostLedger()
        self._next_va = 0
        # capacity-shrink accounting (simulated device loss, see shrink())
        self._pending_shrink_chunks = 0
        self.shrunk_bytes = 0

    # -- accounting ---------------------------------------------------------
    @property
    def used_bytes(self) -> int:
        chunk_bytes = (self.total_chunks - len(self._free_chunks)) * self.chunk_size
        return chunk_bytes + self._segment_bytes

    @property
    def free_bytes(self) -> int:
        return self.capacity_bytes - self.used_bytes

    def shrink(self, nbytes: int) -> int:
        """Permanently lose ``nbytes`` of capacity (device loss / neighbor-
        tenant pressure).

        Free chunks are confiscated immediately; when the free inventory
        cannot cover the loss, the remainder becomes a *pending* debt that
        is retired by future ``cu_mem_release`` calls — the tenant reclaims
        physical pages as the allocator hands them back. While the debt is
        outstanding ``free_bytes`` may go negative and every alloc-side API
        fails, which is exactly the pressure a recovery ladder must relieve
        by releasing memory. Returns the pending (not yet retired) bytes.
        """
        n = round_up(nbytes, self.chunk_size) // self.chunk_size
        take = min(n, len(self._free_chunks))
        # confiscate from the bottom of the LIFO stack so the recycling
        # order of the surviving free chunks is undisturbed
        del self._free_chunks[:take]
        self.total_chunks -= take
        self.capacity_bytes -= n * self.chunk_size
        self._pending_shrink_chunks += n - take
        self.shrunk_bytes += n * self.chunk_size
        return self._pending_shrink_chunks * self.chunk_size

    # -- native allocator path ---------------------------------------------
    def cu_malloc(self, size: int) -> int:
        """Classic cudaMalloc: contiguous segment, charged 1 unit (+sync)."""
        size = round_up(size, self.chunk_size)
        if size > self.free_bytes:
            raise DeviceOOM(f"cuMalloc({size}) with {self.free_bytes} free")
        self._segment_bytes += size
        self.ledger.charge("cuMalloc", CUMALLOC_COST)
        va = self._next_va
        self._next_va += size
        return va

    def cu_free(self, size: int, *, synchronize: bool = True) -> None:
        size = round_up(size, self.chunk_size)
        self._segment_bytes -= size
        assert self._segment_bytes >= 0
        cost = CUFREE_COST + (DEVICE_SYNC_COST if synchronize else 0.0)
        self.ledger.charge("cuFree", cost)

    # -- low-level VMM path ---------------------------------------------------
    def cu_mem_address_reserve(self, size: int) -> int:
        self.ledger.charge(
            "cuMemAddressReserve", _per_call_cost("cuMemAddressReserve", self.chunk_size)
        )
        va = self._next_va
        self._next_va += round_up(size, self.chunk_size)
        return va

    def cu_mem_create(self, n: int) -> List[int]:
        """Create ``n`` physical chunks; ids are NOT contiguous in general.

        The free-chunk inventory alone is not the capacity check: segment
        bytes held via ``cu_malloc`` never leave the chunk pool, so a
        backend mixing large segments with VMM chunks (ellm's elastic
        arena atop a GMLake core) could otherwise reserve past physical
        capacity. Chunk creation therefore also respects ``free_bytes``.
        """
        if n > len(self._free_chunks) or n * self.chunk_size > self.free_bytes:
            raise DeviceOOM(
                f"cuMemCreate({n} chunks) with {len(self._free_chunks)} free "
                f"chunks, {self.free_bytes} free bytes"
            )
        if n:
            # one slice + delete instead of n pops; a reversed tail is
            # exactly the pop sequence, so recycling order is unchanged
            chunks = self._free_chunks[-n:]
            del self._free_chunks[-n:]
            chunks.reverse()
        else:
            chunks = []
        self.ledger.charge("cuMemCreate", n * _per_call_cost("cuMemCreate", self.chunk_size), n)
        return chunks

    def cu_mem_map(self, n: int) -> None:
        self.ledger.charge("cuMemMap", n * _per_call_cost("cuMemMap", self.chunk_size), n)

    def cu_mem_set_access(self, n: int) -> None:
        self.ledger.charge(
            "cuMemSetAccess", n * _per_call_cost("cuMemSetAccess", self.chunk_size), n
        )

    def cu_mem_unmap(self, n: int) -> None:
        self.ledger.charge("cuMemUnmap", n * 0.01, n)

    def cu_mem_release(self, chunks: Iterable[int]) -> None:
        chunks = list(chunks)
        ncalls = len(chunks)
        if self._pending_shrink_chunks:
            # retire outstanding shrink debt before refilling the free list:
            # the confiscating tenant takes pages the moment they come back
            retired = min(self._pending_shrink_chunks, ncalls)
            self._pending_shrink_chunks -= retired
            self.total_chunks -= retired
            chunks = chunks[retired:]
        self._free_chunks.extend(chunks)
        self.ledger.charge("cuMemRelease", ncalls * 0.01, ncalls)

    def cu_mem_address_free(self) -> None:
        self.ledger.charge("cuMemAddressFree", 0.003)

    # -- composite helpers ----------------------------------------------------
    def vmm_alloc(self, size: int) -> List[int]:
        """Reserve + create + map + set-access for one block. Returns chunks."""
        n = num_chunks(size)
        self.cu_mem_address_reserve(size)
        chunks = self.cu_mem_create(n)
        self.cu_mem_map(n)
        self.cu_mem_set_access(n)
        return chunks

    def vmm_map_existing(self, n: int) -> None:
        """Stitch: reserve a VA and re-map ``n`` already-created chunks."""
        self.cu_mem_address_reserve(n * self.chunk_size)
        self.cu_mem_map(n)
        self.cu_mem_set_access(n)

    def vmm_split_remap(self, na: int, nb: int) -> None:
        """Split: re-map both halves (``na`` + ``nb`` chunks) of one block.

        Deliberately issues the exact call sequence of two
        ``vmm_map_existing`` calls: batching the charges into one ledger
        update per API would change floating-point summation order and
        break the bit-identity of ``model_cost`` across rounds — the
        load-independent signal the replay regression gate keys on.
        """
        self.vmm_map_existing(na)
        self.vmm_map_existing(nb)


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FaultWindow:
    """A bounded interval of elevated fault pressure.

    Windows are indexed in 1-based alloc-side device calls (the same clock
    as ``shrink_at_call``) and cover ``[start_call, start_call + duration)``.
    While a window is active its probabilities *override* the schedule's
    base rates wherever they are higher (``max`` composition), so several
    overlapping windows model correlated storms without double-drawing.
    """

    start_call: int
    duration: int
    create_fail_prob: float = 0.0
    map_fail_prob: float = 0.0
    release_fail_prob: float = 0.0
    slow_prob: float = 0.0

    def active_at(self, call: int) -> bool:
        return self.start_call <= call < self.start_call + self.duration


@dataclass(frozen=True)
class PreemptionEvent:
    """One row of the checked-in preemption-trace format.

    ``at`` is the event time in alloc-side device calls (1-based, the
    injector's deterministic clock); ``severity`` is a kind-specific
    magnitude in [0, 1]; ``duration`` is the event's window length in
    calls. Kinds:

      * ``revocation``    — spot-style instance revocation: a warning
        brownout window ``lead`` calls ahead of ``at`` (checkpoint
        pressure), then a capacity loss of ``severity x capacity`` plus a
        deterministic transient burst over the revocation window;
      * ``capacity_loss`` — plain shrink of ``severity x capacity`` (a
        cluster of these close together is a correlated loss storm);
      * ``transient``     — flurry window: elevated transient-failure
        probability (create/map/release sides) of ``severity``;
      * ``brownout``      — slow-device window: slow-call probability of
        ``severity``, no failures.
    """

    at: int
    kind: str
    severity: float
    duration: int = 1
    #: warning lead time (calls) before a revocation; ignored elsewhere
    lead: int = 0

    KINDS = ("revocation", "capacity_loss", "transient", "brownout")

    def __post_init__(self) -> None:
        if self.kind not in self.KINDS:
            raise ValueError(
                f"unknown preemption event kind {self.kind!r}; "
                f"expected one of {self.KINDS}"
            )
        if self.at < 1 or self.duration < 1:
            raise ValueError(f"bad preemption event timing ({self.at}, {self.duration})")
        if not 0.0 <= self.severity <= 1.0:
            raise ValueError(f"severity must be in [0, 1], got {self.severity}")


#: the checked-in preemption trace format tag (see tests/data/)
PREEMPTION_TRACE_FORMAT = "repro.preemption.v1"


def load_preemption_trace(source) -> List[PreemptionEvent]:
    """Parse a ``repro.preemption.v1`` trace into ``PreemptionEvent`` rows.

    ``source`` is a path to a JSON file, an already-parsed payload dict,
    or a bare event list (dicts or ``PreemptionEvent`` instances pass
    through). The format is deliberately tiny — event time, kind,
    severity, duration — so real spot-market / maintenance preemption
    logs reduce to it with a one-line converter.
    """
    if isinstance(source, (str,)) or hasattr(source, "read_text"):
        with open(source) as f:
            source = json.load(f)
    if isinstance(source, dict):
        fmt = source.get("format")
        if fmt != PREEMPTION_TRACE_FORMAT:
            raise ValueError(
                f"unknown preemption trace format {fmt!r}; "
                f"expected {PREEMPTION_TRACE_FORMAT!r}"
            )
        source = source["events"]
    out: List[PreemptionEvent] = []
    for ev in source:
        if isinstance(ev, PreemptionEvent):
            out.append(ev)
        else:
            out.append(PreemptionEvent(
                at=int(ev["at"]),
                kind=str(ev["kind"]),
                severity=float(ev["severity"]),
                duration=int(ev.get("duration", 1)),
                lead=int(ev.get("lead", 0)),
            ))
    return sorted(out, key=lambda e: (e.at, e.kind))


@dataclass(frozen=True)
class FaultSchedule:
    """Deterministic fault plan for a :class:`FaultInjector`.

    All randomness comes from ``random.Random(seed)`` drawn in device-API
    call order, so the same allocator run over the same schedule observes
    the same faults — replays, tests and benchmarks are reproducible.
    """

    seed: int = 0
    #: per-call probability that an alloc-side API (``cuMalloc`` /
    #: ``cuMemCreate``) fails transiently
    create_fail_prob: float = 0.0
    #: per-call probability that ``cuMemMap`` fails transiently
    map_fail_prob: float = 0.0
    #: consecutive failures per triggered fault (a flaky driver rarely
    #: fails exactly once)
    burst: int = 1
    #: driver-level retries absorbed per cuMemMap fault before the error
    #: propagates; keep >= ``burst`` or a mid-stitch map can fail
    #: non-transactionally (see FaultInjector docstring)
    map_retry_limit: int = 8
    #: per-call probability of a slow device call; the stall is charged to
    #: the ledger under ``faultStall``
    slow_prob: float = 0.0
    slow_cost: float = DEVICE_SYNC_COST
    #: one-shot capacity loss fired entering the Nth alloc-side call
    #: (1-based; None = never) — simulated device loss / tenant pressure
    shrink_at_call: Optional[int] = None
    shrink_bytes: int = 0
    #: one-shot deterministic failure burst armed entering the Nth
    #: alloc-side call (1-based; None = never): the next ``fail_burst``
    #: alloc-side calls raise ``TransientDeviceError`` regardless of the
    #: probability schedule. Sized past a backend's recovery-ladder
    #: attempt budget this reproducibly forces the AllocatorOOM ->
    #: supervisor-restore path (the kill/recover scenario)
    fail_at_call: Optional[int] = None
    fail_burst: int = 0
    #: per-call probability that a release-side API (``cuMemRelease`` /
    #: ``cuMemUnmap``) faults transiently. Release-side faults are always
    #: *absorbed* at the injector (bounded retries, each charged as
    #: ``faultStall``) — free/drain paths are fire-and-forget in every
    #: backend, so an exception there would corrupt allocator state
    #: instead of exercising recovery. The counters/ledger still record
    #: every fault, which is what the chaos verdicts assert on.
    release_fail_prob: float = 0.0
    #: stall-charged retries per release-side fault before the injector
    #: gives up stalling and lets the call complete
    release_retry_limit: int = 4
    #: additional capacity losses beyond ``shrink_at_call``:
    #: ``((call, bytes), ...)`` — multi-event chaos schedules need more
    #: than the legacy one-shot knob
    shrinks: Tuple[Tuple[int, int], ...] = ()
    #: additional deterministic failure bursts: ``((call, n), ...)``
    bursts_at: Tuple[Tuple[int, int], ...] = ()
    #: bounded windows of elevated fault pressure (see ``FaultWindow``)
    windows: Tuple[FaultWindow, ...] = ()

    # -- preemption-trace synthesis ----------------------------------------
    #: from_preemption_trace: transient-burst length per unit severity of a
    #: revocation (sized so severity ~0.5 exceeds one ladder's retry budget)
    REVOCATION_BURST_SCALE = 24
    #: warning-window slow probability per unit severity
    WARNING_SLOW_PROB = 0.5

    @classmethod
    def from_preemption_trace(
        cls,
        events: Union[str, Sequence],
        *,
        capacity_bytes: int,
        seed: int = 0,
        **overrides,
    ) -> "FaultSchedule":
        """Synthesize a multi-event schedule from a preemption trace.

        ``events`` is anything ``load_preemption_trace`` accepts (a path
        to a checked-in ``repro.preemption.v1`` file, a payload dict, or
        an event list). ``capacity_bytes`` scales each event's severity
        into a concrete byte loss; chunk-quantization happens in
        ``VMMDevice.shrink``. The synthesis is pure — the same trace,
        seed and capacity always yield the same (hashable, frozen)
        schedule — so chaos campaigns are replayable end to end.
        """
        evs = load_preemption_trace(events)
        shrinks: List[Tuple[int, int]] = []
        bursts: List[Tuple[int, int]] = []
        windows: List[FaultWindow] = []
        for ev in evs:
            if ev.kind == "revocation":
                if ev.lead > 0:
                    # the warning: a pre-revocation brownout (checkpoint
                    # pressure in a real fleet shows up as device stalls)
                    start = max(1, ev.at - ev.lead)
                    windows.append(FaultWindow(
                        start_call=start, duration=ev.at - start,
                        slow_prob=cls.WARNING_SLOW_PROB * ev.severity,
                    ))
                shrinks.append((ev.at, int(ev.severity * capacity_bytes)))
                bursts.append(
                    (ev.at, max(1, int(ev.severity * cls.REVOCATION_BURST_SCALE)))
                )
                windows.append(FaultWindow(
                    start_call=ev.at, duration=ev.duration,
                    create_fail_prob=min(1.0, 0.5 * ev.severity),
                ))
            elif ev.kind == "capacity_loss":
                shrinks.append((ev.at, int(ev.severity * capacity_bytes)))
            elif ev.kind == "transient":
                windows.append(FaultWindow(
                    start_call=ev.at, duration=ev.duration,
                    create_fail_prob=ev.severity,
                    map_fail_prob=0.5 * ev.severity,
                    release_fail_prob=0.5 * ev.severity,
                ))
            else:  # brownout
                windows.append(FaultWindow(
                    start_call=ev.at, duration=ev.duration,
                    slow_prob=ev.severity,
                ))
        kw = dict(
            seed=seed,
            shrinks=tuple(shrinks),
            bursts_at=tuple(bursts),
            windows=tuple(windows),
        )
        kw.update(overrides)
        return cls(**kw)


class FaultInjector:
    """Seed-scheduled fault-injecting wrapper around a :class:`VMMDevice`.

    A drop-in ``device`` for every backend: anything not overridden
    delegates to the wrapped device (``__getattr__``), so ledgers, capacity
    accounting and the native path behave identically. What it injects:

      * alloc-side APIs (``cu_malloc``, ``cu_mem_create``) raise
        :class:`TransientDeviceError` per the probability/burst schedule,
        and fire the scheduled capacity shrinks (the legacy one-shot knobs
        plus any ``shrinks``/``bursts_at``/``windows`` multi-event rows);
      * ``cu_mem_map`` faults are absorbed by a bounded driver-level retry
        loop, each absorbed fault charged to the ledger as ``faultStall``.
        Retrying at the injector (not the backend) keeps mid-stitch /
        mid-split map failures crash-consistent: GMLake mutates its
        registries before remapping, so a map error escaping there would
        corrupt allocator state rather than exercise recovery;
      * release-side APIs (``cu_mem_release``, ``cu_mem_unmap``) fault per
        ``release_fail_prob`` but are *always absorbed*: free and
        deferred-unmap drains are fire-and-forget in every backend, so the
        injector stalls (bounded by ``release_retry_limit``, charged as
        ``faultStall``) and then lets the call complete. The fault
        counters and ledger record every hit, which is how chaos verdicts
        see the drain path exercised under failure;
      * ``vmm_alloc`` is transactional: if mapping fails past the retry
        limit after chunks were created, the chunks are released before the
        error propagates — the backend sees the fault at a safe point and
        its recovery ladder takes over;
      * slow-call injection charges ``faultStall`` without failing.

    Backends auto-detect the wrapper via ``supports_fault_injection`` and
    enable their recovery ladder, keeping the fault-free default path
    bit-identical to the legacy one.
    """

    supports_fault_injection = True

    def __init__(
        self,
        device: VMMDevice,
        schedule: FaultSchedule = FaultSchedule(),
        *,
        external_clock: bool = False,
    ):
        self.inner = device
        self.schedule = schedule
        # external_clock: the fault clock is advanced by the driver (one
        # ``tick()`` per *client* allocation) instead of per device call.
        # Caching backends absorb almost every device call — a replayed
        # workload can reach the device once for hundreds of client
        # mallocs — so trace offsets authored in client-call time would
        # otherwise never fire against them.
        self.external_clock = external_clock
        self._rng = random.Random(schedule.seed)
        self._alloc_calls = 0
        self._burst_left = 0  # alloc-side burst in progress
        self._map_burst_left = 0
        self._release_burst_left = 0
        self.fault_counts: Dict[str, int] = {}
        self.fault_events: List[dict] = []
        # multi-event rows folded in with the legacy one-shot knobs; the
        # dicts key on the 1-based alloc-side call counter
        self._shrinks: Dict[int, int] = {
            call: nbytes for call, nbytes in schedule.shrinks
        }
        if schedule.shrink_at_call is not None and schedule.shrink_bytes:
            self._shrinks[schedule.shrink_at_call] = (
                self._shrinks.get(schedule.shrink_at_call, 0)
                + schedule.shrink_bytes
            )
        self._armed_bursts: Dict[int, int] = {
            call: n for call, n in schedule.bursts_at
        }
        if schedule.fail_at_call is not None and schedule.fail_burst:
            self._armed_bursts[schedule.fail_at_call] = max(
                self._armed_bursts.get(schedule.fail_at_call, 0),
                schedule.fail_burst,
            )

    # -- window composition ---------------------------------------------------
    def _prob(self, field: str) -> float:
        """Effective probability of ``field`` at the current alloc-side
        call: the schedule's base rate, raised by any active window."""
        p = getattr(self.schedule, field)
        for w in self.schedule.windows:
            if w.active_at(self._alloc_calls):
                wp = getattr(w, field)
                if wp > p:
                    p = wp
        return p

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __repr__(self) -> str:
        return f"FaultInjector({self.inner!r}, {self.schedule!r})"

    # -- bookkeeping ----------------------------------------------------------
    def _note(self, kind: str, **detail) -> None:
        self.fault_counts[kind] = self.fault_counts.get(kind, 0) + 1
        ev = {"kind": kind, "call": self._alloc_calls}
        ev.update(detail)
        self.fault_events.append(ev)

    def _maybe_slow(self) -> None:
        s = self.schedule
        p = self._prob("slow_prob")
        if p and self._rng.random() < p:
            self.inner.ledger.charge("faultStall", s.slow_cost)
            self._note("slow")

    def _advance_clock(self) -> None:
        """One step of the fault clock: apply any shrink or burst arming
        scheduled for the new call index. Never raises — clock-driven
        events take effect on the device (shrink) or arm state consumed
        by the next real device call (burst)."""
        self._alloc_calls += 1
        nbytes = self._shrinks.pop(self._alloc_calls, 0)
        if nbytes:
            pending = self.inner.shrink(nbytes)
            self._note("shrink", bytes=nbytes, pending=pending)
        armed = self._armed_bursts.pop(self._alloc_calls, 0)
        if armed:
            self._burst_left = armed
            self._note("burst_armed", n=armed)

    def tick(self) -> None:
        """Advance the external fault clock by one client allocation.

        Only meaningful with ``external_clock=True``: drivers that sit
        above a caching backend call this once per client malloc, so
        preemption-trace ``at`` offsets land in client-call time no
        matter how few device calls the backend actually issues. A
        burst armed here still strikes on the next genuine device call
        — a backend that serves the burst window entirely from cache
        legitimately never sees those faults."""
        if self.external_clock:
            self._advance_clock()

    def _alloc_side(self, api: str) -> None:
        s = self.schedule
        if not self.external_clock:
            self._advance_clock()
        self._maybe_slow()
        if self._burst_left:
            self._burst_left -= 1
            self._note("create_fault", api=api, burst=True)
            raise TransientDeviceError(f"injected transient {api} failure (burst)")
        p = self._prob("create_fail_prob")
        if p and self._rng.random() < p:
            self._burst_left = s.burst - 1
            self._note("create_fault", api=api, burst=False)
            raise TransientDeviceError(f"injected transient {api} failure")

    # -- injected primitives --------------------------------------------------
    def cu_malloc(self, size: int) -> int:
        self._alloc_side("cuMalloc")
        return self.inner.cu_malloc(size)

    def cu_mem_create(self, n: int) -> List[int]:
        self._alloc_side("cuMemCreate")
        return self.inner.cu_mem_create(n)

    def _map_fault(self) -> bool:
        """One cuMemMap draw; True = this call faults."""
        s = self.schedule
        self._maybe_slow()
        if self._map_burst_left:
            self._map_burst_left -= 1
            return True
        p = self._prob("map_fail_prob")
        if p and self._rng.random() < p:
            self._map_burst_left = s.burst - 1
            return True
        return False

    def cu_mem_map(self, n: int) -> None:
        s = self.schedule
        for attempt in range(s.map_retry_limit + 1):
            if not self._map_fault():
                if attempt:
                    self._note("map_retries_absorbed", retries=attempt)
                return self.inner.cu_mem_map(n)
            self._note("map_fault")
            self.inner.ledger.charge("faultStall", s.slow_cost)
        raise TransientDeviceError(
            f"injected cuMemMap failure persisted past {s.map_retry_limit} retries"
        )

    # -- release-side injection ----------------------------------------------
    def _release_fault(self) -> bool:
        """One release-side draw; True = this call faults (is stalled)."""
        if self._release_burst_left:
            self._release_burst_left -= 1
            return True
        p = self._prob("release_fail_prob")
        if p and self._rng.random() < p:
            self._release_burst_left = self.schedule.burst - 1
            return True
        return False

    def _release_side(self, api: str) -> None:
        """Absorb release-side faults: stall (bounded), never fail.

        Free and drain paths mutate backend registries *before* touching
        the device, so an exception here would corrupt allocator state
        rather than exercise recovery — and real streams retire unmaps
        asynchronously, where a transient driver error degrades to a
        stall, not a leak. The injector therefore charges each fault as a
        ``faultStall`` and retries; past ``release_retry_limit`` it stops
        stalling and completes the call, noting the exhaustion.
        """
        s = self.schedule
        if not s.release_fail_prob and not self._release_burst_left:
            has_window = any(
                w.release_fail_prob for w in s.windows
            )
            if not has_window:
                return  # fault-free fast path: zero draws, zero notes
        for attempt in range(s.release_retry_limit + 1):
            if not self._release_fault():
                if attempt:
                    self._note("release_retries_absorbed", api=api,
                               retries=attempt)
                return
            self._note("release_fault", api=api)
            self.inner.ledger.charge("faultStall", s.slow_cost)
        self._note("release_fault_exhausted", api=api)

    def cu_mem_release(self, chunks: Iterable[int]) -> None:
        self._release_side("cuMemRelease")
        return self.inner.cu_mem_release(chunks)

    def cu_mem_unmap(self, n: int) -> None:
        self._release_side("cuMemUnmap")
        return self.inner.cu_mem_unmap(n)

    def cu_free(self, size: int, *, synchronize: bool = True) -> None:
        # segment-granularity release — the path every caching-family
        # backend's release_cached walks; same absorb-and-stall contract
        # as the VMM-level release primitives
        self._release_side("cuFree")
        return self.inner.cu_free(size, synchronize=synchronize)

    # -- composite helpers ----------------------------------------------------
    # Re-declared so they route through the injector's primitives; the base
    # class's composites would call the wrapped device's own cu_* methods
    # and bypass injection entirely.
    def vmm_alloc(self, size: int) -> List[int]:
        n = num_chunks(size)
        self.cu_mem_address_reserve(size)
        chunks = self.cu_mem_create(n)
        try:
            self.cu_mem_map(n)
            self.cu_mem_set_access(n)
        except TransientDeviceError:
            # transactional: never leak created chunks on a map failure
            self.inner.cu_mem_release(chunks)
            raise
        return chunks

    def vmm_map_existing(self, n: int) -> None:
        self.cu_mem_address_reserve(n * self.chunk_size)
        self.cu_mem_map(n)
        self.cu_mem_set_access(n)

    def vmm_split_remap(self, na: int, nb: int) -> None:
        self.vmm_map_existing(na)
        self.vmm_map_existing(nb)
