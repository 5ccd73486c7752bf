"""GMLake: virtual-memory-stitching allocator (paper §3–§4).

Faithful reproduction of the paper's allocator on top of the chunk-granular
device model (GPU physical pages -> arena chunk ids; see DESIGN.md §2):

  * ``PBlock``   — primitive block: owns an ordered list of physical chunks
                   plus its own VA reservation. Created only by ``_alloc_new``
                   (paper: Alloc), divided only by ``_split`` (paper: Split).
  * ``SBlock``   — stitched block: a VA reservation re-mapping the chunks of
                   one or more pBlocks (paper: Stitch). Never split. Active
                   iff any member pBlock is active.
  * ``BestFit``  — Algorithm 1 verbatim: S1 exact match (the only state where
                   an sBlock may be handed out), S2 single larger block,
                   S3 stitch multiple blocks, S4 insufficient -> Alloc.
  * Deallocation = ``Update`` (state flip only, physical memory kept),
    ``StitchFree`` = LRU eviction of inactive sBlocks when the sPool exceeds
    its VA budget (paper §4.2.3).
  * Fragmentation limit (default 128 MB): blocks below it are neither split
    nor used as stitch sources. Requests < 2 MB go to an embedded splitting
    (caching) pool, as in the paper (§3.1).

Emergency paths beyond the paper's letter (documented in DESIGN.md §7): on
S4 shortfall we retry BestFit ignoring the fragmentation limit and release
cached small-pool segments before declaring OOM — chunk-granular stitching
guarantees every inactive byte is usable, which is the paper's
"theoretically eliminates all fragmentation" claim (§4.2.1) made operational.

Hot-path data structures (rounds 1–4 — see docs/ARCHITECTURE.md):

  * Inactive pools are size-indexed bucket maps partitioned at the
    fragmentation limit, with running byte totals (round 1). The S3/S4
    decision reads one counter; the candidate walk only ever sees legal
    stitch sources.
  * StitchFree is a lazy-invalidation LRU min-heap of ``(last_use, sid)``
    entries; stale entries are skipped at pop time (round 1).
  * Activity uses a **per-sBlock activation generation counter**: a held
    (handed-out) sBlock stamps its members with its current ``gen``;
    a member is active iff it was handed out directly or its stamp matches
    its holder's generation. ``free`` of a stitched block is therefore O(1)
    — it bumps the generation and defers the structural work (pool
    re-insertion, membership refcounts, byte totals) to a **batched
    reconcile** that runs before the next pool read (round 2).
  * Membership back-references are **compact flat arrays** (round 3):
    each pBlock keeps a flat list of its referencing sBlocks, and refcount
    passes count straight out of those lists. Round 4 stores the objects
    themselves (id-hashed at C speed), so no loop ever resolves a registry
    entry per edge or per distinct referencing block.
  * **Plan-identity segments** (round 4): candidate handout, free plans and
    pool pending runs all share one representation — ``_Seg``, a frozen
    bucket slice. Segments cycle wholesale between the pool and successive
    stitched blocks' free plans: ``_reconcile`` re-inserts a freed plan as
    one segment append per size (no per-member bucket work), and the take
    walk moves a whole-bucket slice into the new plan as one list object
    (no per-member splicing). Each plan freezes its aggregated
    membership-refcount ``Counter`` (one C-level counting pass per take)
    alongside ``(segment, generation)`` stamps; any operation that breaks
    a slice — bucket settle, partial take, split, individual remove —
    bumps the segment's generation (the plan-generation flag), and
    ``StitchFree`` destruction appends the dead block to a log that
    cached Counters replay lazily (``_refs_mark`` — the destroy-dirty
    watermark) before being trusted, so a frozen plan can never resurrect
    a destroyed sBlock. When a take consumes exactly a previously-freed
    cached plan — the dominant serving pattern, a stitched block freed
    then re-taken at the same size class — ``_hold_sblock`` re-activates
    the frozen plan in O(members-touched): no candidate walk, no
    membership recount, no bucket filtering.
  * **Lazy inactive-sBlock delisting** (round 4): a take re-activates tens
    of sBlocks that share members with its candidates, and the paired free
    drops them back; instead of a bucket remove + insert per bounce, the
    inactive-sBlock pool leaves re-activated entries in place and filters
    them at its only ordered read (S1 ``exact``), so a bounce costs pure
    integer refcount updates (``_InactiveSBlocks``).
  * **Deferred split substitution** (round 4): ``_split`` no longer walks
    every referencing sBlock to substitute the halves into slot structures;
    it links ``parent.split_into = (a, b)`` and copies the membership
    array to both halves. Referencing sBlocks resolve the expansion lazily
    inside ``members()`` the next time they are held, destroyed, or
    inspected — walks that already iterate the member list anyway.
  * **sBlock shell recycling** (round 4): destroyed sBlocks park their
    shells on a free list; ``_stitch_plan`` re-stamps a recycled shell
    instead of allocating a fresh object. Shell generations continue
    monotonically across lives so stale ``holder`` stamps from a previous
    life can never read as active.
  * The completing-bucket window keeps its sorted remainder as the settled
    bucket when the settled base was exhausted (round 4): consecutive
    same-size takes slice the tail of one persistent sorted list — the
    per-size cursor — instead of re-sorting a pending run each time.
  * **Vectorized flat-array core** (round 5): every live pBlock/sBlock
    carries a dense integer slot id into flat numpy arrays (``_VecCore``).
    Reconciled activity counts live in one int64 array indexed by sBlock
    slot; membership edges are cached per frozen segment as CSR-style
    ``edge_ptr``/``edge_sid`` int32 arrays plus their aggregated
    ``(ref_sids, ref_counts)`` unique form, so a segment that cycles
    wholesale between pool and plans (the dominant serving pattern) never
    re-walks its edges. The three refcount passes — the per-take
    membership count, the reconcile apply/decrement pair, and the
    destroy-sweep purge — become a handful of vectorized ops
    (``np.concatenate``/``np.unique``/``np.bincount`` merges, fancy-index
    scatter, boolean-mask compaction) instead of per-edge iteration,
    aligning the take/free cycle with the compiled-event design of
    ``replay_batched``. Destroyed slot ids are quarantined until the
    dead-log compaction proves no cached array can still name them, which
    is what makes slot recycling safe. ``vectorized=False`` (or a missing
    numpy) falls back to the round-4 object path.

All of this is mechanical sympathy only. Replay behaviour — S1–S5 state
counts, peak active/reserved bytes, OOM points — is bit-identical to the
seed implementation; ``tests/test_golden_equivalence.py`` pins it,
``tests/test_plan_identity.py`` additionally pins digest equality with the
round-4 fast paths force-disabled (``plan_identity=False``), and
``tests/test_vectorized_core.py`` pins digest parity between the round-5
array core and the object path (``vectorized=True/False``). The only
documented *policy* knob is the StitchFree VA budget (``va_budget`` tiers):
a non-default tier changes eviction decisions — a trade refereed by the
load-independent modeled device cost, never by wall time.
"""

from __future__ import annotations

import itertools
from bisect import bisect_left, insort
from collections import Counter, deque

try:  # C-level "count iterable into mapping" (CPython implementation detail)
    from _collections import _count_elements
except ImportError:  # pragma: no cover - pure-python fallback
    def _count_elements(mapping, iterable):
        get = mapping.get
        for elem in iterable:
            mapping[elem] = get(elem, 0) + 1
from heapq import heapify, heappop, heappush
from itertools import chain, repeat
from operator import attrgetter, itemgetter
from typing import Dict, List, Optional, Tuple

try:  # the vectorized core needs numpy; the object path must not
    import numpy as np
except ImportError:  # pragma: no cover - exercised via subprocess guard test
    np = None

_EMPTY_I64 = None if np is None else np.zeros(0, dtype=np.int64)

from .caching_allocator import Allocation, AllocatorOOM, CachingAllocator
from .chunks import (
    CHUNK_SIZE,
    DEFAULT_FRAG_LIMIT,
    SMALL_ALLOC_LIMIT,
    ChunkRun,
    DeviceOOM,
    Extent,
    VMMDevice,
    pack_extent_runs,
    pack_extents,
    round_up,
)
from .metrics import AllocatorEventLog, AllocatorStats
from .protocol import AllocatorCapabilities
from .recovery import RecoveryConfig, recovery_enabled, run_ladder
from .registry import register

_ids = itertools.count()

_get_sb_refs = attrgetter("sb_refs")
_get_split_into = attrgetter("split_into")
_get_slot = attrgetter("slot")
_get_block = itemgetter(1)
_get_active_members = attrgetter("active_members")


class PBlock:
    """Primitive block (paper: pBlock): an ordered chunk list + one VA.

    Activity is *computed*, not stored: a pBlock is active iff it was handed
    out directly (``direct``) or its generation stamp matches its holder
    sBlock's current generation (``holder``/``holder_gen`` — see the module
    docstring). Both tests are O(1); nothing iterates members to flip flags.

    ``sb_refs`` is the membership back-reference — every live sBlock
    referencing this pBlock — stored as a **compact flat list** (round 3
    introduced flat arrays; round 4 stores the objects themselves: the
    refcount loops that consume these lists — Counter building, activation
    deltas, destroy sweeps — then never pay a registry lookup per entry,
    and object identity hashes at C speed). Lists stay tiny (typically
    ~10 entries), so the O(k) removal at destroy is noise.

    ``split_into`` is the deferred-substitution link (round 4): Split sets
    it to the two halves instead of walking every referencing sBlock.
    A pBlock with ``split_into`` set is dead — it owns nothing, sits in no
    pool, and exists only so unresolved member lists can expand it later.
    """

    __slots__ = (
        "pid", "size", "chunks", "direct", "holder", "holder_gen",
        "sb_refs", "split_into", "va", "slot", "_extents",
    )

    def __init__(self, chunks, va: int = 0):
        self.pid = next(_ids)
        self.chunks = chunks if isinstance(chunks, ChunkRun) else ChunkRun(chunks)
        self.size = len(self.chunks) * CHUNK_SIZE
        self.direct = False  # handed out on its own (S1/S2/S4 pBlock paths)
        self.holder: Optional["SBlock"] = None  # last sBlock that held it
        self.holder_gen = 0  # holder generation stamped at handout
        self.sb_refs: List["SBlock"] = []  # live sBlocks referencing this
        self.split_into: Optional[Tuple["PBlock", "PBlock"]] = None
        self.va = va
        self.slot = -1  # dense id in the vectorized core (-1 = object mode)
        self._extents: Optional[List[Extent]] = None

    @property
    def active(self) -> bool:
        """O(1): directly handed out, or stamped by a currently-held holder."""
        h = self.holder
        return self.direct or (h is not None and self.holder_gen == h.gen)

    @property
    def extents(self) -> List[Extent]:
        # chunks are immutable after construction (Split creates new pBlocks),
        # so the packed form is computed once and reused by every kernel call.
        if self._extents is None:
            self._extents = pack_extents(self.chunks)
        return self._extents

    def __repr__(self):
        return f"PBlock(id={self.pid}, size={self.size >> 20}MB, active={self.active})"


class _Seg:
    """A frozen pool segment: one same-size bucket slice that cycles
    wholesale between the pool and successive free plans.

    ``entries`` is a ``[(pid, block), ...]`` slice exactly as stored in a
    pool bucket; while the segment is frozen the very list object moves —
    pool -> plan -> pool — with no per-member copying. ``gen`` is the
    segment's **plan-generation flag**: it is bumped whenever the slice
    stops being *this* slice — consumed by a take into a new plan, settled
    into a sorted bucket, or partially broken up. A cached plan records
    the gens of its segments at freeze time; a matching gen proves the
    slice (and therefore every member's size and membership) is untouched
    since, which is what makes ``_hold_sblock``'s plan-identity
    re-activation bit-identical. ``owner`` is the sBlock whose
    held/pending free plan the segment currently belongs to, or ``None``
    while pooled.

    Round 5 (vectorized core only) attaches flat membership arrays to the
    frozen slice itself, so a segment that cycles wholesale between pool
    and plans never re-walks its edges:

      * ``ref_sids``/``ref_counts`` — the aggregated form the hot path
        lives on: parallel int64 arrays mapping referencing sBlock slot ->
        member count (ascending slot order), i.e. the array analogue of
        the object path's refcount ``Counter``, sized by unique
        referencing blocks rather than raw edges.
      * ``edge_sid``/``edge_ptr`` — the raw pBlock→sBlock membership edges
        in CSR form: ``edge_sid[edge_ptr[i]:edge_ptr[i+1]]`` are the sBlock
        slot ids referencing member ``entries[i]``. Materialized on demand
        (``_seg_edges`` — invariant checker, kernels, debugging); dropped
        (``None``) whenever the edge set changes shape under the cache
        (owner append, entry append). Cached arrays may name slots whose
        block has since been destroyed — consumers mask against
        ``sb_alive`` at the point of use (the invariant checker filters
        before comparing), so no eager per-destroy purge ever walks the
        caches.
      * ``ref_extra`` — owner appends (one ``(slot, count)`` pair per
        stitch that consumed the slice wholesale) buffered on a plain
        list; ``_seg_refs`` folds them into the arrays at the next read.
        Extending a numpy array per append costs ~40x a list append, and
        stitches append far more often than takes read.
    """

    __slots__ = (
        "size", "entries", "gen", "owner",
        "edge_sid", "edge_ptr", "ref_sids", "ref_counts", "ref_extra",
    )

    def __init__(self, size: int, entries: List[tuple]):
        self.size = size
        self.entries = entries
        self.gen = 0
        self.owner: Optional["SBlock"] = None
        self.edge_sid = None
        self.edge_ptr = None
        self.ref_sids = None
        self.ref_counts = None
        self.ref_extra = None

    def __repr__(self):
        return f"_Seg(size={self.size >> 20}MB, n={len(self.entries)}, gen={self.gen})"


class SBlock:
    """Stitched block (paper: sBlock): a VA re-mapping member pBlock chunks.

    Members are a flat list. Split substitution is **deferred** (round 4):
    a member with ``split_into`` set expands to its halves the next time
    ``members()`` is consulted — the resolution rewrites the list in place,
    preserving order, so chunk coverage is identical across splits
    (``chunks`` caches forever).

    ``gen`` is the activation generation: bumped on every handout and every
    free. Handout stamps each member with the new value; free only bumps the
    counter, which un-stamps all members at once (O(1) — the structural pool
    work is deferred to ``GMLakeAllocator._reconcile``). Shell recycling
    keeps ``gen`` monotone across lives so stale stamps stay stale.
    ``active_members`` is the *reconciled* count of active members, used by
    the pool/LRU machinery; ``active`` recomputes the truth from member
    stamps so it is correct even between a free and the next reconcile.

    While held (and until its free is reconciled), the block carries its own
    **free plan**: ``_plan`` is a list of ``(_Seg, gen)`` pairs — the very
    segments the take pass consumed, with their plan-generation stamps at
    freeze time — and ``_refs`` is the plan's membership-refcount Counter
    (referencing sBlock -> member count, keyed by object). Both are exact
    at free time because a held member's size and membership set are
    frozen: splits and new stitches only touch inactive pBlocks, and
    StitchFree can only destroy a fully-inactive sBlock, which by the
    activity-exclusivity argument shares no member with any held one.
    After reconcile, plan and refs are *kept* as a cache (``_refs_mark``
    remembers the dead-block log position): if every segment is still
    pooled with a matching generation when the block wins S1 again,
    ``_hold_sblock`` re-activates the whole plan without a walk or a
    recount (plan-identity reuse).
    """

    __slots__ = (
        "sid", "size", "n_members", "active_members", "gen", "held", "va",
        "last_use", "pool_listed", "heap_lu", "slot", "_members", "_plan",
        "_refs", "_refs_mark", "_chunks", "_extents",
    )

    def __init__(
        self,
        pblocks: List[PBlock],
        tick: int,
        va: int = 0,
        size: Optional[int] = None,
        active_members: Optional[int] = None,
    ):
        """Plain (non-held) construction — the S2 opportunistic stitch and
        test paths. Held stitches go through ``GMLakeAllocator._stitch_plan``
        which fuses member stamping with the segment walk."""
        self.sid = next(_ids)
        self._members: List[PBlock] = pblocks
        self.n_members = len(pblocks)
        # callers that already know the totals pass them in; both are
        # cross-checked against the members by check_invariants()
        self.size = sum(p.size for p in pblocks) if size is None else size
        self.active_members = (
            sum(1 for p in pblocks if p.active)
            if active_members is None
            else active_members
        )
        self.gen = 0
        self.held = False
        self.va = va
        self.last_use = tick
        self.pool_listed = False
        self.heap_lu: Optional[int] = None  # last_use of this block's live
        # LRU-heap entry, or None — dedups crossing pushes (round 4)
        self.slot = -1  # dense id in the vectorized core (-1 = object mode)
        self._plan: Optional[List[Tuple[_Seg, int]]] = None
        self._refs: Optional[Dict["SBlock", int]] = None
        self._refs_mark = 0
        self._chunks: Optional[List[int]] = None
        self._extents: Optional[List[Extent]] = None
        for p in pblocks:
            p.sb_refs.append(self)

    def members(self) -> List[PBlock]:
        """Current member list, split halves in place of their parent.

        Deferred split links (``split_into``) are resolved here, in one
        in-place rewrite that preserves member order; until some walk needs
        the members, a split costs the referencing sBlocks nothing. The
        no-split probe runs as one C-level ``any(map(...))`` pass.
        """
        ms = self._members
        if any(map(_get_split_into, ms)):
            out: List[PBlock] = []
            ap = out.append
            for q in ms:
                sp = q.split_into
                if sp is None:
                    ap(q)
                else:
                    stack = [sp[1], sp[0]]
                    while stack:
                        q2 = stack.pop()
                        sp2 = q2.split_into
                        if sp2 is None:
                            ap(q2)
                        else:
                            stack.append(sp2[1])
                            stack.append(sp2[0])
            self._members = out
            self.n_members = len(out)
            return out
        return ms

    @property
    def pblocks(self) -> List[PBlock]:
        """Flattened member list (compat alias for ``members()``)."""
        return list(self.members())

    @property
    def active(self) -> bool:
        """True iff any member is active. Exact even before a reconcile."""
        return self.held or any(p.active for p in self.members())

    @property
    def chunks(self) -> List[int]:
        # Split substitutes member pBlocks with halves covering the identical
        # chunk sequence, so the concatenation can be cached forever.
        if self._chunks is None:
            out: List[int] = []
            for p in self.members():
                out.extend(p.chunks)
            self._chunks = out
        return self._chunks

    @property
    def extents(self) -> List[Extent]:
        if self._extents is None:
            self._extents = pack_extent_runs(p.chunks for p in self.members())
        return self._extents

    def __repr__(self):
        return (
            f"SBlock(id={self.sid}, size={self.size >> 20}MB, "
            f"n_p={self.n_members}, active={self.active})"
        )


def _key(block) -> int:
    return block.pid if isinstance(block, PBlock) else block.sid


def _count_entry_sids(counter: dict, entries: List[tuple]) -> None:
    """Count every referencing block of ``entries``' members into ``counter``."""
    _count_elements(
        counter, chain.from_iterable(map(_get_sb_refs, map(_get_block, entries)))
    )


def _merge_id_parts(parts_s: List, parts_c: List):
    """Sum parallel ``(ids, counts)`` array parts into one ascending
    unique pair.

    Sort-based: O(m log m) in the total part length m — and effectively
    O(m), since each part arrives ascending and the stable sort is a
    run-merge — **independent of the slot-table size**. (The obvious
    ``bincount`` + ``nonzero`` merge is O(table) per call, which comes to
    dominate the take tail once the table outgrows the per-take working
    set — exactly what happens over a long serving replay.) Duplicate ids
    within or across parts sum exactly; int64 throughout. Callers
    guarantee at least one non-empty part.
    """
    s = np.concatenate(parts_s)
    c = np.concatenate(parts_c)
    order = s.argsort(kind="stable")
    s = s[order]
    c = c[order]
    lead = np.empty(s.size, dtype=bool)
    lead[0] = True
    np.not_equal(s[1:], s[:-1], out=lead[1:])
    idx = lead.nonzero()[0]
    if idx.size == s.size:  # no duplicates anywhere: already reduced
        return s, c
    return s[idx], np.add.reduceat(c, idx)


class _VecCore:
    """Flat-array state for the vectorized take/free core (round 5).

    Two dense integer id spaces, managed with free lists so arrays stay
    O(live blocks), not O(creations):

      * **sBlock slots** index three parallel structures: ``sb_active``
        (int64 — the reconciled active-member count, the array analogue of
        ``SBlock.active_members``, which goes *stale* in vectorized mode),
        ``sb_alive`` (bool — live vs destroyed, the purge mask), and
        ``sb_by_slot`` (slot -> SBlock, for resolving zero-crossings back
        to objects).
      * **pBlock slots** are a plain dense id space (no arrays index them
        today); they exist so every block has a stable small-int identity
        for edge arrays and invariant checks.

    Slot recycling safety: cached segment/plan ref arrays may name a slot
    long after its block was destroyed (they are purged lazily against
    ``sb_alive``). A destroyed slot is therefore **quarantined** — not
    returned to the free list — until ``compact_sb()``, which the
    allocator calls only from ``_compact_dead_log`` after dropping every
    cached array that could still name an old slot. Between compactions a
    quarantined slot stays dead in ``sb_alive``, so aliveness masks purge
    it from any cache; after a compaction no cache names it at all. That
    two-phase release is what makes fancy-index scatter (which requires
    unique indices) sound against recycled ids.

    ``deaths`` is a monotone destroy counter used as a cache version stamp
    (``_Seg.ref_mark`` / ``SBlock._refs_mark``): unlike the dead-block
    *log* it is never reset, so stale marks are never ambiguous.
    """

    INITIAL_SLOTS = 64

    __slots__ = (
        "sb_active", "sb_alive", "sb_by_slot", "deaths",
        "counters", "_sb_free", "_sb_quarantine", "_pb_free", "_pb_next",
    )

    def __init__(self, counters: Dict[str, int]):
        n = self.INITIAL_SLOTS
        self.sb_active = np.zeros(n, dtype=np.int64)
        self.sb_alive = np.zeros(n, dtype=bool)
        self.sb_by_slot: List[Optional["SBlock"]] = [None] * n
        self.deaths = 0
        self.counters = counters
        self._sb_free = list(range(n - 1, -1, -1))  # pop() hands out ascending
        self._sb_quarantine: List[int] = []
        self._pb_free: List[int] = []
        self._pb_next = 0

    def acquire_sb(self, s: "SBlock") -> int:
        free = self._sb_free
        if not free:
            self._grow()
            free = self._sb_free
        slot = free.pop()
        self.sb_alive[slot] = True
        self.sb_active[slot] = 0
        self.sb_by_slot[slot] = s
        return slot

    def _grow(self) -> None:
        n = len(self.sb_by_slot)
        n2 = 2 * n
        grown = np.zeros(n2, dtype=np.int64)
        grown[:n] = self.sb_active
        self.sb_active = grown
        alive = np.zeros(n2, dtype=bool)
        alive[:n] = self.sb_alive
        self.sb_alive = alive
        self.sb_by_slot.extend([None] * n)
        self._sb_free.extend(range(n2 - 1, n - 1, -1))
        self.counters["slot_grows"] += 1

    def release_sb(self, slot: int) -> None:
        """Destroy-time release: dead immediately, recyclable only after
        the next ``compact_sb`` (see the quarantine rule above)."""
        self.sb_alive[slot] = False
        self.sb_by_slot[slot] = None
        self._sb_quarantine.append(slot)
        self.deaths += 1

    def compact_sb(self) -> None:
        q = self._sb_quarantine
        if q:
            self._sb_free.extend(q)
            self._sb_quarantine = []
            self.counters["dead_compactions"] += 1

    def acquire_pb(self) -> int:
        free = self._pb_free
        if free:
            return free.pop()
        slot = self._pb_next
        self._pb_next = slot + 1
        return slot

    def release_pb(self, slot: int) -> None:
        self._pb_free.append(slot)


#: ``GMLakeAllocator(va_budget=...)`` policy tiers: StitchFree VA budget as
#: a multiple of device capacity. ``"paper"`` is the default 4x (paper
#: §4.2.3); ``"tight"`` caps stitched VA at 1x capacity (lowest peak VA,
#: most destroy/remap churn); ``"speed"`` disables StitchFree entirely
#: (None -> unbounded: fewest device calls, highest peak VA). Tiers other
#: than the default change *eviction policy* — behaviour is NOT
#: bit-identical — so their trade-off is refereed by the load-independent
#: modeled device cost (``model_cost_per_event``), never by wall time.
VA_BUDGET_TIERS: Dict[str, Optional[float]] = {
    "paper": 4.0,
    "tight": 1.0,
    "speed": None,
}


class _IndexedPool:
    """Pool of *inactive* blocks indexed by size.

    Selection and iteration order is identical to a single (size, id)-sorted
    list — S1 exact match, S2 best-fit, S3 largest-first — but add/remove only
    touch one per-size bucket (typically a handful of blocks) instead of
    shifting a pool-wide array, and the byte total is a running counter.
    Block sizes are chunk multiples, so the number of distinct sizes is small
    compared to the number of blocks; the `_sizes` index only changes when a
    bucket is created or emptied.

    Inserts are **lazily settled**: loose entries land in a per-size pending
    list (one append) and whole freed-plan slices arrive as frozen ``_Seg``
    segments (one list append each, round 4); both are merged into the
    sorted bucket only when an *ordered* query actually reaches that size.
    Byte/count totals update at insert time, so the O(1) S3-vs-S4 decision
    never waits on a settle, and sizes the candidate walk never descends to
    are never sorted at all — which is most of them, since the walk stops at
    coverage. Settling is timing-transparent: every ordered read sees
    exactly the bucket an eager insert would have produced. Settling kills
    the merged segments (their slices stop being identifiable), which is
    what keeps frozen-plan reuse trivially safe.
    """

    __slots__ = ("_buckets", "_loose", "_segs", "_sizes", "_count", "bytes")

    def __init__(self):
        self._buckets: Dict[int, List[tuple]] = {}  # size -> [(id, block)] asc
        self._loose: Dict[int, List[tuple]] = {}  # size -> unsorted inserts
        self._segs: Dict[int, List[_Seg]] = {}  # size -> frozen slices
        self._sizes: List[int] = []  # ascending distinct sizes
        self._count = 0
        self.bytes = 0  # running sum of member sizes

    def __len__(self):
        return self._count

    def __iter__(self):
        for size in self._sizes:
            yield from map(_get_block, self._settled(size))

    def _settled(self, size: int) -> List[tuple]:
        """The sorted bucket for ``size``, merging loose runs and segments.

        Merged segments die (``refs = None``): their entries now belong to
        the settled bucket and can be cherry-picked, so any cached plan
        referencing them must fall back to the recounting path.
        """
        bucket = self._buckets[size]
        loose = self._loose.pop(size, None)
        segs = self._segs.pop(size, None)
        if loose is None and segs is None:
            return bucket
        if loose is not None:
            bucket.extend(loose)
        if segs is not None:
            for seg in segs:
                bucket.extend(seg.entries)
                seg.gen += 1  # broken up: cached plan stamps go stale
        bucket.sort()
        return bucket

    def _ensure_size(self, size: int) -> None:
        if size not in self._buckets:
            self._buckets[size] = []
            insort(self._sizes, size)

    def _drop_size_if_empty(self, size: int) -> None:
        if not self._buckets[size] and size not in self._loose and size not in self._segs:
            del self._buckets[size]
            self._sizes.pop(bisect_left(self._sizes, size))

    def add(self, block) -> None:
        size = block.size
        self._ensure_size(size)
        loose = self._loose.get(size)
        if loose is None:
            self._loose[size] = [(_key(block), block)]
        else:
            loose.append((_key(block), block))
        self._count += 1
        self.bytes += size

    def add_seg(self, seg: _Seg) -> None:
        """Queue one frozen plan slice for a size bucket: a single append."""
        size = seg.size
        self._ensure_size(size)
        segs = self._segs.get(size)
        if segs is None:
            self._segs[size] = [seg]
        else:
            segs.append(seg)
        n = len(seg.entries)
        self._count += n
        self.bytes += size * n

    def remove_seg(self, seg: _Seg) -> None:
        """Remove one still-frozen pooled segment wholesale (plan reuse)."""
        size = seg.size
        segs = self._segs[size]
        segs.remove(seg)
        if not segs:
            del self._segs[size]
        n = len(seg.entries)
        self._count -= n
        self.bytes -= size * n
        self._drop_size_if_empty(size)

    def remove(self, block) -> None:
        size = block.size
        bucket = self._settled(size)
        if len(bucket) == 1:
            assert bucket[0][1] is block, "pool corruption"
            del self._buckets[size]
            self._sizes.pop(bisect_left(self._sizes, size))
        else:
            i = bisect_left(bucket, (_key(block),))
            assert i < len(bucket) and bucket[i][1] is block, "pool corruption"
            bucket.pop(i)
        self._count -= 1
        self.bytes -= size

    def remove_batch(self, size: int, ids: set) -> None:
        """Remove the entries with the given ids from one size bucket.

        Removing a few ids from a big bucket bisects them out; removing a
        large share rebuilds the bucket with one filter pass.
        """
        bucket = self._settled(size)
        k = len(ids)
        if k == len(bucket):  # ids can only name present entries
            del self._buckets[size]
            self._sizes.pop(bisect_left(self._sizes, size))
        elif k <= 16 and k * 8 < len(bucket):
            for pid in ids:
                i = bisect_left(bucket, (pid,))
                assert bucket[i][0] == pid, "pool corruption"
                bucket.pop(i)
        else:
            kept = [e for e in bucket if e[0] not in ids]
            assert len(kept) == len(bucket) - k, "pool corruption"
            self._buckets[size] = kept
        self._count -= k
        self.bytes -= size * k

    def exact(self, size: int):
        if size not in self._buckets:
            return None
        return self._settled(size)[0][1]

    def best_fit_at_least(self, size: int):
        """Smallest block with block.size >= size."""
        i = bisect_left(self._sizes, size)
        if i < len(self._sizes):
            return self._settled(self._sizes[i])[0][1]
        return None


class _InactiveSBlocks(_IndexedPool):
    """The inactive-sBlock pool, with **lazy delisting** (round 4).

    On the stitch-heavy traces, every take re-activates tens of sBlocks
    whose members it touches and the paired free drops them back — the
    eager scheme paid a bucket remove + insert (plus a heap push) per
    bounce. Here re-activation leaves the entry in place (``pool_listed``
    stays set on the block); a stale entry — one whose block is currently
    active — is filtered out at ``exact()`` read time, and an inactive
    block is (re-)listed only if its flag is clear. Since ``exact`` is the
    only ordered read on the hot path, a block bouncing between active and
    inactive costs pure integer refcount updates. Selection is unchanged:
    ``exact`` still returns the lowest-sid *truly inactive* block of the
    size, exactly what the eager pool would have held. ``sweep()`` restores
    the eager representation for iteration/invariant checks.

    The staleness filter reads the reconciled active-member count through
    ``active_of`` (round 5): the object path reads
    ``SBlock.active_members``, the vectorized core reads its
    ``sb_active`` slot — the attribute goes stale in that mode.
    """

    __slots__ = ("_active_of",)

    def __init__(self, active_of=_get_active_members):
        super().__init__()
        self._active_of = active_of

    def exact(self, size: int):
        if size not in self._buckets:
            return None
        bucket = self._settled(size)
        active_of = self._active_of
        i = 0
        n = len(bucket)
        while i < n:
            s = bucket[i][1]
            if active_of(s) == 0:
                break
            s.pool_listed = False  # stale: delist lazily
            i += 1
        if i:
            del bucket[:i]
            self._count -= i
            self.bytes -= size * i
        if not bucket:
            del self._buckets[size]
            self._sizes.pop(bisect_left(self._sizes, size))
            return None
        return bucket[0][1]

    def sweep(self) -> None:
        """Drop every stale entry: the pool then holds exactly the inactive
        set, as the eager scheme would (iteration/invariant paths only)."""
        active_of = self._active_of
        for size in list(self._sizes):
            bucket = self._settled(size)
            kept = []
            for e in bucket:
                s = e[1]
                if active_of(s) == 0:
                    kept.append(e)
                else:
                    s.pool_listed = False
                    self._count -= 1
                    self.bytes -= size
            if kept:
                self._buckets[size] = kept
            else:
                del self._buckets[size]
                self._sizes.pop(bisect_left(self._sizes, size))


class _PartitionedPool:
    """Inactive pBlock pool split at the fragmentation limit (paper §4.2.3).

    Blocks >= the limit are legal stitch sources ("main"), blocks below it
    are not ("sub"). Keeping them in separate indexed pools means the S3/S4
    candidate scan never even sees sub-limit blocks, and the running
    ``main.bytes`` total answers "can the pool cover this request at all?"
    in O(1). A block's
    partition is a pure function of its size, so exact/best-fit routing stays
    order-identical to one combined (size, id)-sorted pool.
    """

    __slots__ = ("frag_limit", "main", "sub")

    def __init__(self, frag_limit: int):
        self.frag_limit = frag_limit
        self.main = _IndexedPool()  # size >= frag_limit: stitch sources
        self.sub = _IndexedPool()  # size < frag_limit: reuse/split only

    def _pool_for(self, size: int) -> _IndexedPool:
        return self.sub if size < self.frag_limit else self.main

    def __len__(self):
        return len(self.main) + len(self.sub)

    def __iter__(self):
        # ascending (size, id): every sub size < frag_limit <= every main size
        return chain(iter(self.sub), iter(self.main))

    def add(self, block) -> None:
        self._pool_for(block.size).add(block)

    def add_seg(self, seg: _Seg) -> None:
        self._pool_for(seg.size).add_seg(seg)

    def remove_seg(self, seg: _Seg) -> None:
        self._pool_for(seg.size).remove_seg(seg)

    def remove(self, block) -> None:
        self._pool_for(block.size).remove(block)

    def exact(self, size: int):
        return self._pool_for(size).exact(size)

    def best_fit_at_least(self, size: int):
        if size < self.frag_limit:
            blk = self.sub.best_fit_at_least(size)
            if blk is not None:  # any sub hit is smaller than every main block
                return blk
        return self.main.best_fit_at_least(size)

    @property
    def bytes(self) -> int:
        return self.main.bytes + self.sub.bytes


@register(
    "gmlake",
    AllocatorCapabilities(
        caching=True,
        stitching=True,
        state_counts=True,
        releases_cached=True,
        recovery=True,
    ),
)
class GMLakeAllocator:
    """The paper's allocator. Drop-in interchangeable with CachingAllocator.

    Public surface: ``malloc``/``free`` (paper: Alloc + BestFit / Update),
    ``reserved_bytes``, ``state_counts`` (S1–S5 tallies of Algorithm 1),
    ``stats`` (AllocatorStats), ``check_invariants`` (debug/test).

    Deferred-free contract: ``free`` of a stitched block is O(1) — it bumps
    the sBlock's activation generation and queues the block. The structural
    pool work is applied by ``_reconcile`` *before any pool read* (entry of
    ``_malloc_vms``, the over-budget branch of a free, and
    ``check_invariants``), so every BestFit query observes exactly the state
    an eager implementation would have. Reconciliation timing is therefore
    unobservable, which is what keeps replay digests bit-identical.

    ``plan_identity=False`` force-disables the round-4 fast paths (frozen
    segment Counters, wholesale segment reuse, cached-plan re-activation):
    every consumption re-counts membership from the sid arrays. Behaviour
    is bit-identical either way — ``tests/test_plan_identity.py`` pins it.

    ``vectorized`` selects the round-5 flat-array refcount core (default:
    on when numpy is importable; requesting it without numpy falls back to
    the object path and counts a ``numpy_fallback``). Behaviour is
    bit-identical either way — ``tests/test_vectorized_core.py`` pins it.

    ``va_budget`` is the documented StitchFree policy knob: a tier name
    from ``VA_BUDGET_TIERS`` (``"paper"``/``"tight"``/``"speed"``), a float
    multiple of device capacity, or an absolute byte count (int). The
    legacy ``sblock_va_budget`` (absolute bytes) wins when both are given.
    Non-default tiers trade peak stitched VA (``peak_sblock_va``) against
    modeled device cost — see ``VA_BUDGET_TIERS``.
    """

    name = "gmlake"

    #: The paper quotes 128 MB as an example fragmentation limit (§4.2.3) and
    #: notes the hyper-parameters are "empirically configured ... through best
    #: practices" (§5.1). On our workload suite 8 MB is the empirical optimum
    #: (see EXPERIMENTS.md §Allocator); 128 MB remains available as
    #: ``chunks.DEFAULT_FRAG_LIMIT``.
    TUNED_FRAG_LIMIT = 8 * 1024 * 1024

    #: Destroyed-sBlock shells kept for recycling (round 4).
    MAX_SHELLS = 64

    #: Destroyed-block log length that triggers compaction (drop cached
    #: plans, clear the log) so memory stays O(live), not O(destroys).
    DEAD_LOG_LIMIT = 4096

    def __init__(
        self,
        device: VMMDevice,
        frag_limit: int = TUNED_FRAG_LIMIT,
        sblock_va_budget: Optional[int] = None,
        record_timeline: bool = False,
        plan_identity: bool = True,
        recovery: Optional[bool] = None,
        deferred_unmap: Optional[bool] = None,
        vectorized: Optional[bool] = None,
        va_budget=None,
    ):
        self.device = device
        self.frag_limit = frag_limit
        # paper §4.2.3: VA for stitched blocks is capped; LRU StitchFree past
        # it. Resolution order: legacy absolute bytes, then the policy knob
        # (tier name / capacity multiple / absolute bytes), then the default
        # "paper" tier (4x capacity).
        self.sblock_va_budget = self._resolve_va_budget(sblock_va_budget, va_budget)
        self.plan_identity = plan_identity
        self.stats = AllocatorStats(record_timeline=record_timeline)
        self.state_counts: Dict[str, int] = {f"S{i}": 0 for i in range(1, 6)}
        #: round-4 fast-path hit counters (diagnostics only; not digest
        #: material). Shared into ``stats.counters`` for the profile harness.
        self.hotspots: Dict[str, int] = {
            "seg_reuse": 0, "seg_recount": 0, "hold_fast": 0, "hold_slow": 0,
            "shell_reuse": 0,
        }
        self.stats.counters = self.hotspots

        #: round-5 vectorized-core observability (diagnostics only; never
        #: digest material). Surfaced through ``ReplayResult.vec_counters``
        #: and ``ServeEngine.memory_report()`` exactly like
        #: ``elastic_counters`` / recovery summaries — no side channels.
        self.vec_counters: Dict[str, int] = {
            "enabled": 0,
            "numpy_fallback": 0,  # vectorized requested but numpy missing
            "seg_cache_builds": 0,  # edge arrays built from object lists
            "seg_cache_appends": 0,  # owner-append updates of cached arrays
            "ref_purges": 0,  # aliveness-mask compactions of cached arrays
            "slot_grows": 0,  # slot-table doublings
            "dead_compactions": 0,  # quarantined-slot recycles
        }
        if vectorized is None:
            self.vectorized = np is not None
        else:
            self.vectorized = bool(vectorized) and np is not None
            if vectorized and np is None:
                self.vec_counters["numpy_fallback"] = 1
        if self.vectorized:
            self.vec_counters["enabled"] = 1
            self._vec_core = _VecCore(self.vec_counters)
            # mode binding: the refcount passes are bound per instance so
            # the hot path never re-tests the mode (same pattern as
            # AllocatorStats.__post_init__'s timeline-free fast variants)
            self._apply_activation = self._apply_activation_vec
            self._refs_decrement = self._refs_decrement_vec
            self._purge_refs = self._purge_refs_vec
            self._activate_p = self._activate_p_vec
            self._deactivate_p = self._deactivate_p_vec
            self._active_of = self._active_of_vec
        else:
            self._vec_core = None
        self.stats.vec_counters = self.vec_counters
        #: high-water mark of stitched VA (the va_budget trade-off metric)
        self.peak_sblock_va = 0

        self._inactive_p = _PartitionedPool(frag_limit)
        self._inactive_s = _InactiveSBlocks(self._active_of)
        self._pblocks: Dict[int, PBlock] = {}  # registry of all live pBlocks
        self._sblocks: Dict[int, SBlock] = {}  # registry of all live sBlocks
        # StitchFree LRU: lazy-invalidation min-heap of (last_use, sid).
        # Entries are pushed whenever an sBlock becomes inactive (or its
        # last_use is refreshed while inactive); stale entries are skipped at
        # pop time, so eviction is O(evicted * log n) instead of a full sort.
        # (last_use, sid) matches the seed's stable sort of the append-only
        # sBlock list: sids are monotone in creation order.
        self._lru_heap: List[Tuple[int, int]] = []
        # sBlocks freed since the last reconcile: their generation is already
        # bumped (members read as inactive) but pools/refcounts are stale.
        self._pending_frees: List[SBlock] = []
        self._shells: List[SBlock] = []  # recycled sBlock shells
        # append-only log of destroyed sBlocks; cached plan Counters are
        # purged lazily against it (see SBlock._refs_mark / _purge_refs)
        self._dead_refs: List[SBlock] = []
        self._sblock_va_bytes = 0
        self._chunk_bytes = 0  # physical chunks created (reserved by VMS pool)
        self._tick = 0

        # staged OOM recovery (auto-on under a fault-injecting device) and
        # deferred (stream-ordered) physical unmap, which follows recovery
        # unless set explicitly; the unmap queue holds member counts of
        # destroyed sBlocks whose physical unmap is pending a safe point
        self._recovery_on = recovery_enabled(device, recovery)
        self._recovery_cfg = RecoveryConfig()
        self.event_log = AllocatorEventLog()
        self._deferred_unmap = (
            self._recovery_on if deferred_unmap is None else bool(deferred_unmap)
        )
        self._unmap_queue: List[int] = []

        # requests < 2 MB use the classic splitting pool (paper §3.1); it
        # shares this allocator's event log so one replay yields one stream
        self._small = CachingAllocator(
            device, recovery=self._recovery_on, event_log=self.event_log
        )

    def _resolve_va_budget(self, sblock_va_budget, va_budget):
        """Resolve the StitchFree VA budget from the two knobs.

        ``sblock_va_budget`` (legacy, absolute bytes) wins when given.
        ``va_budget`` accepts a tier name from ``VA_BUDGET_TIERS``, a float
        (multiple of device capacity) or an int (absolute bytes); the
        ``"speed"`` tier maps to +inf (StitchFree never fires).
        """
        if sblock_va_budget is not None:
            return sblock_va_budget
        capacity = self.device.capacity_bytes
        if va_budget is None:
            return 4 * capacity
        if isinstance(va_budget, str):
            try:
                mult = VA_BUDGET_TIERS[va_budget]
            except KeyError:
                raise ValueError(
                    f"unknown va_budget tier {va_budget!r}; "
                    f"expected one of {sorted(VA_BUDGET_TIERS)}, "
                    "a float capacity multiple, or absolute bytes"
                ) from None
            return float("inf") if mult is None else int(mult * capacity)
        if isinstance(va_budget, float):
            return int(va_budget * capacity)
        return int(va_budget)

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------
    @property
    def reserved_bytes(self) -> int:
        """Physical bytes held (VMS chunks + small-pool segments). O(1)."""
        return self._chunk_bytes + self._small.reserved_bytes

    def _note_sblock_va(self, delta: int) -> None:
        """Charge stitched-VA growth and track the high-water mark."""
        va = self._sblock_va_bytes + delta
        self._sblock_va_bytes = va
        if va > self.peak_sblock_va:
            self.peak_sblock_va = va

    # ------------------------------------------------------------------
    # activity accessors (mode-bound, round 5)
    # ------------------------------------------------------------------
    def _active_of(self, s: SBlock) -> int:
        """Reconciled active-member count (object path: the attribute)."""
        return s.active_members

    def _active_of_vec(self, s: SBlock) -> int:
        """Reconciled active-member count (vectorized: the slot array —
        ``active_members`` is stale in this mode)."""
        return int(self._vec_core.sb_active[s.slot])

    # ------------------------------------------------------------------
    # activity transitions
    # ------------------------------------------------------------------
    def _activate_p(self, p: PBlock) -> None:
        """Inactive -> directly active: leave the pool, bump member refcounts.

        Single-block handout (S1 pBlock / S2): O(log bucket + |p.sb_refs|).
        """
        assert not p.active
        self._inactive_p.remove(p)
        p.direct = True
        for s in p.sb_refs:
            s.active_members += 1  # re-listing is lazy: exact() filters

    def _deactivate_p(self, p: PBlock) -> None:
        """Directly active -> inactive. The single-block inverse.

        Correct with frees pending: refcount decrements commute with the
        deferred ones, and a zero-crossing pushed here or at reconcile
        carries the same (last_use, sid) either way.
        """
        assert p.direct
        p.direct = False
        self._inactive_p.add(p)
        heap = self._lru_heap
        inactive_s = self._inactive_s
        for s in p.sb_refs:
            m = s.active_members - 1
            s.active_members = m
            assert m >= 0
            if m == 0:
                if s.heap_lu != s.last_use:
                    s.heap_lu = s.last_use
                    heappush(heap, (s.last_use, s.sid))
                if not s.pool_listed:
                    s.pool_listed = True
                    inactive_s.add(s)

    def _activate_p_vec(self, p: PBlock) -> None:
        """``_activate_p`` against the slot array (vectorized core).

        ``sb_refs`` stays a tiny object list (~10 entries) in both modes —
        the single-block transitions never had an array-shaped cost; only
        the batched passes did.
        """
        assert not p.active
        self._inactive_p.remove(p)
        p.direct = True
        act = self._vec_core.sb_active
        for s in p.sb_refs:
            act[s.slot] += 1

    def _deactivate_p_vec(self, p: PBlock) -> None:
        assert p.direct
        p.direct = False
        self._inactive_p.add(p)
        heap = self._lru_heap
        inactive_s = self._inactive_s
        act = self._vec_core.sb_active
        for s in p.sb_refs:
            slot = s.slot
            m = int(act[slot]) - 1
            act[slot] = m
            assert m >= 0
            if m == 0:
                if s.heap_lu != s.last_use:
                    s.heap_lu = s.last_use
                    heappush(heap, (s.last_use, s.sid))
                if not s.pool_listed:
                    s.pool_listed = True
                    inactive_s.add(s)

    def _purge_refs(self, s: SBlock) -> None:
        """Drop destroyed sBlocks from a cached plan's refcount Counter.

        Destruction removes the dead block from every member's ``sb_refs``;
        a reconciled block's cached ``_refs`` Counter froze those counts, so
        before the S1 fast path trusts it, the dead-block log is replayed
        from ``_refs_mark`` (the destroy-dirty watermark set at reconcile).
        O(destroys since the block was reconciled) — typically zero or one.
        """
        dead = self._dead_refs
        n = len(dead)
        mark = s._refs_mark
        if mark < n:
            refs = s._refs
            for r in dead[mark:]:
                refs.pop(r, None)
            s._refs_mark = n

    def _purge_refs_vec(self, s: SBlock) -> None:
        """Vectorized ``_purge_refs``: one aliveness mask over the cached
        ``(ref_sids, ref_counts)`` plan arrays instead of a log replay —
        destroyed slots stay dead in ``sb_alive`` until every cache has had
        a chance to drop them (the quarantine rule), so masking is exact at
        any time. ``_refs_mark`` holds the monotone ``deaths`` stamp."""
        core = self._vec_core
        deaths = core.deaths
        if s._refs_mark != deaths:
            sids, counts = s._refs
            if sids.size:
                keep = core.sb_alive[sids]
                if not keep.all():
                    s._refs = (sids[keep], counts[keep])
                    core.counters["ref_purges"] += 1
            s._refs_mark = deaths

    # ------------------------------------------------------------------
    # vectorized membership counting (round 5)
    # ------------------------------------------------------------------
    def _seg_refs(self, seg: _Seg):
        """The segment's aggregated membership refcounts as parallel arrays
        ``(ref_sids, ref_counts)`` — slot ids of referencing sBlocks and how
        many of this slice's members each references.

        Checker/introspection surface — the hot take path counts raw
        edges directly (see ``_count_segs_refs`` for why). Cache hit:
        fold any buffered owner appends, then reuse verbatim. The
        returned arrays may still name slots destroyed since the cache
        was built — destroys never walk the caches; consumers mask
        against ``sb_alive`` at the point of use (the invariant checker
        filters before comparing). Miss: one C-level counting pass over
        the members' ``sb_refs`` chains (the same ``_count_elements``
        machinery as the object path) feeds two small ``fromiter`` calls
        — the arrays built are sized by *unique referencing blocks*,
        never by raw edges, and a fresh build is alive-only by
        construction (``_destroy_sblock`` scrubs ``sb_refs`` eagerly).
        """
        sids = seg.ref_sids
        if sids is not None:
            extra = seg.ref_extra
            if extra is not None:
                # fold buffered owner appends (same end-of-array order an
                # eager per-append extension would have produced)
                n = sids.size
                k = len(extra)
                folded_s = np.empty(n + k, dtype=np.int64)
                folded_c = np.empty(n + k, dtype=np.int64)
                folded_s[:n] = sids
                folded_c[:n] = seg.ref_counts
                for i, (sl, c) in enumerate(extra, n):
                    folded_s[i] = sl
                    folded_c[i] = c
                sids = folded_s
                seg.ref_sids = folded_s
                seg.ref_counts = folded_c
                seg.ref_extra = None
            return sids, seg.ref_counts
        d: Dict[SBlock, int] = {}
        _count_elements(
            d,
            chain.from_iterable(e[1].sb_refs for e in seg.entries),
        )
        n = len(d)
        if n:
            sids = np.fromiter(map(_get_slot, d.keys()), np.int64, count=n)
            counts = np.fromiter(d.values(), np.int64, count=n)
            # slot order (ascending) — the same order the merge output has
            # (nonzero of a slot-indexed accumulator), so downstream
            # ordering never depends on which path produced the arrays
            order = np.argsort(sids)
            sids = sids[order]
            counts = counts[order]
        else:
            sids = _EMPTY_I64
            counts = _EMPTY_I64
        seg.ref_sids = sids
        seg.ref_counts = counts
        self._vec_core.counters["seg_cache_builds"] += 1
        return sids, counts

    def _seg_edges(self, seg: _Seg):
        """The slice's raw pBlock→sBlock membership edges in CSR form
        (``edge_sid``/``edge_ptr``) — materialized on demand and cached.

        The hot path only ever needs the aggregated ``(ref_sids,
        ref_counts)`` form, so the per-edge arrays are built lazily (the
        invariant checker cross-validates them against the aggregate;
        kernels/debugging can walk them). Every cache-invalidation site
        drops both forms together, but destroys do NOT walk caches — a
        cached CSR may predate ``sb_refs`` scrubbing. Callers needing an
        authoritative edge list must drop ``edge_sid``/``edge_ptr`` first
        (the invariant checker does).
        """
        es = seg.edge_sid
        if es is not None:
            return es, seg.edge_ptr
        edges: List[SBlock] = []
        ptr = [0]
        pa = ptr.append
        for e in seg.entries:
            edges += e[1].sb_refs
            pa(len(edges))
        es = np.fromiter(map(_get_slot, edges), np.int32, count=len(edges))
        seg.edge_sid = es
        seg.edge_ptr = np.asarray(ptr, dtype=np.int32)
        return es, seg.edge_ptr

    def _count_segs_refs(self, segs: List[_Seg]):
        """The take tail's membership count, vectorized core: ONE C-level
        counting pass over the candidate set's raw edges, converted once
        into the ``(sids, counts)`` array pair that drives every
        downstream array pass (activation scatter, reconcile decrement,
        aliveness masking).

        Deliberately the same counting *kernel* as the object path
        (``_count_take_refs``). A per-segment cached-aggregate merge was
        built, measured and rejected for this spot: at serving scale a
        take's candidate set is ~10 slices / ~1k edges compressing to
        ~125 unique referencing blocks, and one ``_count_elements`` walk
        at tens of ns/edge beats any numpy merge whose per-op constants
        are ~1-2 µs — the measured crossover sits near ~5k edges per
        take, which the serving replay never approaches (BENCHMARKS.md,
        round 5). The arrays win where state is long-lived and batched —
        the refcount pair, plan purges, the destroy sweep — so the count
        pass feeds them without itself merging arrays. Fresh counts are
        alive-only by construction (``_destroy_sblock`` scrubs
        ``sb_refs`` eagerly), so no aliveness mask is needed; the output
        is deliberately unsorted (no consumer is order-sensitive). The
        per-segment aggregate/CSR caches remain the invariant checker's
        and introspection's domain (``_seg_refs`` / ``_seg_edges``).
        """
        edges: List[SBlock] = []
        for seg in segs:
            for e in seg.entries:
                edges += e[1].sb_refs
        d: Dict[SBlock, int] = {}
        _count_elements(d, edges)
        n = len(d)
        if not n:
            return (_EMPTY_I64, _EMPTY_I64)
        return (
            np.fromiter(map(_get_slot, d.keys()), np.int64, count=n),
            np.fromiter(d.values(), np.int64, count=n),
        )

    def _hold_sblock(self, s: SBlock) -> None:
        """Hand out an existing inactive sBlock (S1).

        Fast path (plan-identity reuse, round 4): if the block's cached free
        plan — the very segments its last free re-inserted into the pool —
        is still entirely frozen and pooled, re-activating it is one
        ``remove_seg`` per size plus a stamping walk: no candidate scan, no
        bucket filtering, no membership recount (each segment's Counter is
        exact by the frozen-slice invariant once the dead-sid log is
        replayed). Slow path: the round-2 scheme — one generation bump, one
        stamp per member, one bucket filter per member size, one refcount
        pass per size — which also rebuilds fresh frozen segments so the
        next cycle is fast again.
        """
        s.gen += 1
        s.held = True
        # the selected block leaves the inactive pool eagerly (it is being
        # handed out); every *other* re-activated sBlock is delisted lazily
        self._inactive_s.remove(s)
        s.pool_listed = False
        gen = s.gen
        plan = s._plan
        if plan is not None and self.plan_identity:
            members = s.members()  # resolves splits (which also bump seg gens)
            if all(
                seg.gen == g and seg.owner is None for seg, g in plan
            ) and sum(len(seg.entries) for seg, _g in plan) == len(members):
                # every slice of the cached plan survived untouched: the pool
                # still holds exactly this block's members, in these slices,
                # and the frozen refcount Counter is exact modulo destroyed
                # blocks — which the dead-log replay removes
                self._purge_refs(s)
                remove_seg = self._inactive_p.remove_seg
                for seg, _g in plan:
                    remove_seg(seg)
                    seg.owner = s
                for p in members:
                    p.holder = s
                    p.holder_gen = gen
                self._apply_activation(s._refs)  # includes s: already delisted
                self.hotspots["hold_fast"] += 1
                return
        self.hotspots["hold_slow"] += 1
        pools = (self._inactive_p.sub, self._inactive_p.main)
        limit = self.frag_limit
        by_size: Dict[int, list] = {}
        for p in s.members():
            p.holder = s
            p.holder_gen = gen
            entries = by_size.get(p.size)
            if entries is None:
                by_size[p.size] = [(p.pid, p)]
            else:
                entries.append((p.pid, p))
        new_plan: List[Tuple[_Seg, int]] = []
        if self.vectorized:
            segs: List[_Seg] = []
            for size, entries in by_size.items():
                pools[size >= limit].remove_batch(size, {e[0] for e in entries})
                seg = _Seg(size, entries)
                seg.owner = s
                new_plan.append((seg, 0))
                segs.append(seg)
            # one C counting pass over the fresh segments, converted once
            # into the array pair the vectorized refcount passes consume
            refs = self._count_segs_refs(segs)
        else:
            refs: Dict[SBlock, int] = {}
            for size, entries in by_size.items():
                pools[size >= limit].remove_batch(size, {e[0] for e in entries})
                _count_entry_sids(refs, entries)
                seg = _Seg(size, entries)
                seg.owner = s
                new_plan.append((seg, 0))
        self._apply_activation(refs)
        s._plan = new_plan
        s._refs = refs

    def _apply_activation(self, refs: Dict["SBlock", int]) -> None:
        """Apply aggregated +delta membership refcounts (activation side).

        ``refs`` maps referencing sBlock -> count (objects are the Counter
        keys, so no registry resolution happens here at all). Re-activated
        blocks are *not* removed from the inactive pool — delisting is lazy
        (see ``_InactiveSBlocks``) — so this is a pure integer pass.
        """
        for s, d in refs.items():
            s.active_members += d

    def _apply_activation_vec(self, refs) -> None:
        """Vectorized ``_apply_activation``: ``refs`` is the plan's
        ``(sids, counts)`` array pair; slot ids are unique within a plan,
        so one fancy-index scatter-add applies the whole batch."""
        sids, counts = refs
        if sids.size:
            self._vec_core.sb_active[sids] += counts

    def _refs_decrement(self, refs, zeros_append) -> None:
        """Apply a freed plan's refcount decrements (object path).

        Collects blocks whose reconciled count crossed zero into ``zeros``
        via ``zeros_append`` — the caller does the heap/pool listing, which
        is shared between both modes. Counts only shrink during a reconcile
        batch, so each block crosses zero at most once across the batch and
        the collected order equals the crossing order.
        """
        for r, d in refs.items():
            m = r.active_members - d
            r.active_members = m
            assert m >= 0
            if m == 0:
                zeros_append(r)

    def _refs_decrement_vec(self, refs, zeros_append) -> None:
        """Vectorized ``_refs_decrement``: one gather, one subtract, one
        scatter over the slot array; only zero-crossings come back to the
        object world (via ``sb_by_slot``) for LRU/pool listing. The object
        path's per-entry non-negativity assert is covered globally by the
        invariant checker ("slot activity drifted"), so the hot path
        carries no reduction."""
        sids, counts = refs
        if not sids.size:
            return
        act = self._vec_core.sb_active
        rem = act[sids] - counts
        act[sids] = rem
        zero = (rem == 0).nonzero()[0]
        if zero.size:
            by_slot = self._vec_core.sb_by_slot
            for slot in sids[zero].tolist():
                zeros_append(by_slot[slot])

    def _reconcile(self) -> None:
        """Apply all deferred sBlock frees in one batched pass.

        Cost: O(plan segments + distinct referencing sBlocks) across *all*
        pending frees — the per-member work was already paid once at
        handout, when the free plan's segments were frozen: re-inserting a
        plan is one ``add_seg`` append per size (round 4; no bucket merging
        or sorting at all — a settle, if one ever happens, timsort-gallops
        the sorted runs then). Pool contents, byte totals, inactive-sBlock
        set and LRU entries end up exactly as if each free had been applied
        eagerly at its own tick (counts only shrink here, so zero-crossings
        are batch-order independent; heap entries are (last_use, sid)
        values fixed at free time; segment appends commute with interleaved
        single-block frees because ordered reads settle to one id-sorted
        bucket either way). The plan stays cached on the block afterwards —
        ``_hold_sblock`` re-activates it wholesale if it survives frozen.
        """
        pending = self._pending_frees
        if not pending:
            return
        self._pending_frees = []
        main = self._inactive_p.main
        sub = self._inactive_p.sub
        limit = self.frag_limit
        heap = self._lru_heap
        inactive_s_add = self._inactive_s.add
        # the cache-freshness stamp written to each reconciled plan: the
        # dead-log position (object path) or the monotone destroy counter
        # (vectorized path — see _VecCore.deaths)
        if self.vectorized:
            dead_mark = self._vec_core.deaths
        else:
            dead_mark = len(self._dead_refs)
        refs_decrement = self._refs_decrement
        zeros: List[SBlock] = []
        zeros_append = zeros.append
        for s in pending:
            for seg, _g in s._plan:
                seg.owner = None
                size = seg.size
                pool = main if size >= limit else sub
                if size not in pool._buckets:
                    pool._buckets[size] = []
                    insort(pool._sizes, size)
                segs = pool._segs.get(size)
                if segs is None:
                    pool._segs[size] = [seg]
                else:
                    segs.append(seg)
                n = len(seg.entries)
                pool._count += n
                pool.bytes += size * n
            s._refs_mark = dead_mark  # refs cached for plan-identity re-holds
            # decrement from the plan's frozen refcounts (Counter keyed by
            # the referencing sBlocks themselves, or the slot-array pair):
            # counts only shrink, so zero-crossings are batch-order
            # independent and land on whichever decrement is last
            refs_decrement(s._refs, zeros_append)
        for r in zeros:
            if r.heap_lu != r.last_use:
                r.heap_lu = r.last_use
                heappush(heap, (r.last_use, r.sid))
            if not r.pool_listed:
                r.pool_listed = True
                inactive_s_add(r)
        # lazy invalidation leaves stale entries behind; when they outnumber
        # the live ones, rebuild from the inactive set (one valid entry per
        # inactive sBlock) so heap memory stays O(inactive), not O(frees)
        if len(heap) > 64 + 4 * len(self._inactive_s):
            self._compact_lru_heap()

    # ------------------------------------------------------------------
    # primitive operations: Alloc / Split / Stitch / StitchFree
    # ------------------------------------------------------------------
    def _alloc_new(self, size: int) -> PBlock:
        """Paper's Alloc: the only creator of physical chunks."""
        chunks = self.device.vmm_alloc(size)
        p = PBlock(chunks)
        self._pblocks[p.pid] = p
        self._chunk_bytes += p.size
        p.direct = True  # handed out or immediately stitched by the caller
        if self.vectorized:
            p.slot = self._vec_core.acquire_pb()
        return p

    def _split_parts(self, p: PBlock, first_size: int) -> Tuple[PBlock, PBlock]:
        """The Split core: divide ``p`` and re-map, no pool bookkeeping.

        sBlocks referencing the old pBlock see the two halves in its place
        (chunk coverage identical) — the paper's "new pBlocks replace the
        predecessor" without invalidating the stitched pattern tape. The
        substitution is **deferred** (round 4): the parent records
        ``split_into = (a, b)`` and both halves inherit its membership
        array (two C-level list copies); referencing sBlocks expand the
        link lazily inside ``members()``. Chunk slicing is O(1) —
        ``ChunkRun`` views share the parent's chunk storage.
        """
        assert not p.active and 0 < first_size < p.size
        assert first_size % CHUNK_SIZE == 0
        k = first_size // CHUNK_SIZE
        del self._pblocks[p.pid]
        chunks = p.chunks
        a = PBlock(chunks[:k])
        b = PBlock(chunks[k:])
        self._pblocks[a.pid] = a
        self._pblocks[b.pid] = b
        if self.vectorized:
            core = self._vec_core
            core.release_pb(p.slot)  # pb slots have no caches: recycle now
            a.slot = core.acquire_pb()
            b.slot = core.acquire_pb()
        # two new VA reservations + remap (charged to the device model)
        self.device.vmm_split_remap(k, len(b.chunks))
        refs = p.sb_refs
        if refs:
            a.sb_refs = refs.copy()
            b.sb_refs = refs.copy()
            refs.clear()
        p.split_into = (a, b)
        return a, b

    def _split(self, p: PBlock, first_size: int) -> Tuple[PBlock, PBlock]:
        """Paper's Split over a *pooled* pBlock: both halves re-pooled.

        The S3 completing-bucket split uses ``_split_parts`` directly — its
        parent is already in hand and the first half joins the stitch, so
        round-tripping either through the pool (a bucket settle + sort per
        split) would be pure churn.
        """
        self._inactive_p.remove(p)
        a, b = self._split_parts(p, first_size)
        self._inactive_p.add(a)
        self._inactive_p.add(b)
        return a, b

    def _stitch(
        self,
        pblocks: List[PBlock],
        total_size: Optional[int] = None,
        active_members: Optional[int] = None,
    ) -> SBlock:
        """Paper's Stitch, non-held form: the S2 opportunistic stitch whose
        members keep their own state. Held stitches (S3/S4) go through
        ``_stitch_plan``. Re-maps, no Create."""
        if total_size is None:
            total_size = sum(p.size for p in pblocks)
        n = total_size // CHUNK_SIZE  # == total member chunk count
        self.device.vmm_map_existing(n)
        s = SBlock(
            pblocks, tick=self._tick, size=total_size,
            active_members=active_members,
        )
        self._sblocks[s.sid] = s
        if self.vectorized:
            # the constructor already appended s to each member's sb_refs;
            # mirror the freshly computed count into the slot array (the
            # attribute goes stale from here on)
            s.slot = self._vec_core.acquire_sb(s)
            self._vec_core.sb_active[s.slot] = s.active_members
        self._note_sblock_va(s.size)
        if self._active_of(s) == 0:
            s.pool_listed = True
            s.heap_lu = s.last_use
            self._inactive_s.add(s)
            heappush(self._lru_heap, (s.last_use, s.sid))
        self._maybe_stitch_free()
        return s

    def _stitch_plan(
        self,
        plan: Dict[int, _Seg],
        total_size: int,
        refs: Dict["SBlock", int],
        members: List[PBlock],
    ) -> SBlock:
        """Stitch and hand out the take pass's segments (S3/S4).

        One fused walk stamps every member with the new block's generation
        and appends the new block to its membership array; the take pass's
        refcount Counter plus this block's own entry is frozen as the free
        plan for the eventual ``free``/``_reconcile``, and the segments
        (with their generation stamps) as the reusable frozen slices for
        the next cycle. Recycles a destroyed shell when one is available;
        shell generations continue monotonically so stale holder stamps
        from a previous life can never match.
        """
        self.device.vmm_map_existing(total_size // CHUNK_SIZE)
        shells = self._shells
        if shells:
            s = shells.pop()
            gen = s.gen + 1  # strictly above every stamp of the prior life
            self.hotspots["shell_reuse"] += 1
        else:
            s = SBlock.__new__(SBlock)
            gen = 1
        sid = next(_ids)
        n_members = len(members)
        s.sid = sid
        s.size = total_size
        s.n_members = n_members
        s.active_members = n_members
        s.gen = gen
        s.held = True
        s.va = 0
        s.last_use = self._tick
        s.pool_listed = False
        s.heap_lu = None
        s._refs_mark = 0
        s._chunks = None
        s._extents = None
        plan_list: List[Tuple[_Seg, int]] = []
        if self.vectorized:
            core = self._vec_core
            slot = core.acquire_sb(s)
            s.slot = slot
            core.sb_active[slot] = n_members
            appends = 0
            for seg in plan.values():
                seg.owner = s
                plan_list.append((seg, seg.gen))
                if seg.ref_sids is not None:
                    # owner append: every member of this slice gains one
                    # edge to the new block — the aggregate extends by one
                    # (slot, len(entries)) entry (the slot is fresh, so
                    # uniqueness holds). Array extension per append is the
                    # hottest numpy cost in the whole cycle, so the entry
                    # goes on a plain list folded into the arrays at the
                    # next read (``_seg_refs``); the raw CSR would need
                    # per-member interleaving, so it is dropped instead
                    extra = seg.ref_extra
                    if extra is None:
                        seg.ref_extra = [(slot, len(seg.entries))]
                    else:
                        extra.append((slot, len(seg.entries)))
                    seg.edge_sid = None
                    seg.edge_ptr = None
                    appends += 1
            if appends:
                core.counters["seg_cache_appends"] += appends
            sids, counts = refs
            n = sids.size
            rs = np.empty(n + 1, dtype=np.int64)
            rc = np.empty(n + 1, dtype=np.int64)
            rs[:n] = sids
            rc[:n] = counts
            rs[n] = slot
            rc[n] = n_members
            s._refs = (rs, rc)
        else:
            for seg in plan.values():
                seg.owner = s
                plan_list.append((seg, seg.gen))
            refs[s] = n_members
            s._refs = refs
        for p in members:
            p.holder = s
            p.holder_gen = gen
            p.sb_refs.append(s)
        s._plan = plan_list
        s._members = members
        self._sblocks[sid] = s
        self._note_sblock_va(total_size)
        self._maybe_stitch_free()
        return s

    def _maybe_stitch_free(self) -> None:
        """Paper's StitchFree: LRU-evict inactive sBlocks past the VA budget.

        O(evicted * (log heap + members)); callers guarantee pending frees
        are reconciled before eviction runs (so ``active_members`` is exact).
        """
        if self._sblock_va_bytes <= self.sblock_va_budget:
            return
        heap = self._lru_heap
        sblocks = self._sblocks
        active_of = self._active_of
        while self._sblock_va_bytes > self.sblock_va_budget and heap:
            last_use, sid = heappop(heap)
            s = sblocks.get(sid)
            if s is None:
                continue  # stale entry: block destroyed
            if s.heap_lu == last_use:
                s.heap_lu = None  # its live entry just left the heap
            if active_of(s) > 0 or s.last_use != last_use:
                continue  # stale entry: re-activated or refreshed
            self._destroy_sblock(s)

    def _destroy_sblock(self, s: SBlock) -> None:
        """Unmap and forget an sBlock; eagerly drop every back-reference.

        Only fully-inactive sBlocks are ever destroyed, and an inactive
        sBlock cannot share a member with a *held* one (the shared member
        would make it active) — so no held block's free plan can reference
        this block, and the membership drop is a pure discard sweep, run as
        one C-level map. Pooled frozen segments cache membership counts;
        the dead block is appended to the dead-block log and purged from
        each cached plan's Counter lazily, right before it is next trusted
        (``_purge_refs``). Stale ``holder`` pointers at this block are left
        in place: the generation test reads them as inactive forever (the
        block's gen was bumped at its final free and only grows, even
        across shell recycling). The shell itself parks on the free list
        for ``_stitch_plan`` to reuse.
        """
        if s.pool_listed:
            self._inactive_s.remove(s)
            s.pool_listed = False
        del self._sblocks[s.sid]
        self._sblock_va_bytes -= s.size
        members = s.members()  # resolves deferred splits; freshens n_members
        deque(
            map(list.remove, map(_get_sb_refs, members), repeat(s)),
            maxlen=0,
        )
        if self.vectorized:
            # dead in sb_alive immediately (purge masks see it); the slot
            # itself is quarantined until the next dead-log compaction, when
            # no cached array can name it anymore
            self._vec_core.release_sb(s.slot)
        self._dead_refs.append(s)
        if len(self._dead_refs) > self.DEAD_LOG_LIMIT:
            self._compact_dead_log()
        if self._deferred_unmap:
            # stream-ordered reclamation: the physical unmap leaves the
            # allocation path and waits on the drain queue for a safe point
            self._unmap_queue.append(s.n_members)
        else:
            self.device.cu_mem_unmap(s.n_members)
            self.device.cu_mem_address_free()
        shells = self._shells
        if len(shells) < self.MAX_SHELLS:
            s._members = None
            s._plan = None
            s._refs = None
            s._chunks = None
            s._extents = None
            shells.append(s)

    def _compact_dead_log(self) -> None:
        """Reset the destroyed-block log so memory stays O(live), not
        O(destroys).

        The log exists only so *cached* (inactive, reconciled) plans can
        replay destroys into their frozen Counters before the S1 fast path
        trusts them. Dropping every inactive block's cached plan makes the
        whole log dead weight: held/pending plans never contain dead
        entries (their referencing blocks are active, hence undestroyable)
        and get a fresh ``_refs_mark`` at their next reconcile, so the log
        can be cleared outright. Cost: O(live sBlocks), amortized over the
        4096 destroys that filled the log; the only effect on behaviour is
        that the next re-hold of an affected block takes the slow path
        once — which rebuilds the cache.
        """
        pending = self._pending_frees
        if self.vectorized:
            # Quarantined slots are about to be recycled, so every cached
            # segment array that could still name one must go: pooled
            # frozen segments, plus the plan segments of held/pending
            # blocks (their plan-level refs are safe — a held plan's
            # referencing blocks are active, hence undestroyable — but a
            # seg cache may predate the hold). Dropping a cache only costs
            # a rebuild on its next use.
            for pool in (self._inactive_p.main, self._inactive_p.sub):
                for segs in pool._segs.values():
                    for seg in segs:
                        seg.ref_sids = None
                        seg.ref_counts = None
                        seg.edge_sid = None
                        seg.edge_ptr = None
                        seg.ref_extra = None
            for s in self._sblocks.values():
                if s._plan is not None:
                    for seg, _g in s._plan:
                        seg.ref_sids = None
                        seg.ref_counts = None
                        seg.edge_sid = None
                        seg.edge_ptr = None
                        seg.ref_extra = None
        for s in self._sblocks.values():
            if s._plan is not None and not s.held and s not in pending:
                s._plan = None
                s._refs = None
        self._dead_refs.clear()
        if self.vectorized:
            self._vec_core.compact_sb()

    def _compact_lru_heap(self) -> None:
        self._inactive_s.sweep()  # iteration must see only truly-inactive
        for s in self._sblocks.values():
            s.heap_lu = None
        heap = []
        for s in self._inactive_s:
            s.heap_lu = s.last_use
            heap.append((s.last_use, s.sid))
        heapify(heap)
        self._lru_heap = heap

    # ------------------------------------------------------------------
    # BestFit — Algorithm 1
    # ------------------------------------------------------------------
    def _best_fit(self, bsize: int, ignore_frag_limit: bool = False):
        """Classify the request: returns (state, block, available bytes).

        States 1..4 per Algorithm 1. ``block`` is the S1/S2 hit (None for
        S3/S4 — candidates are taken lazily by ``_take_stitch_candidates``
        so the walk and the handout are one pass). The S3-vs-S4 decision
        reads one running byte counter; no block is touched.
        """
        # S1: exact match over inactive sBlocks U pBlocks (the only state in
        # which an sBlock may be assigned).
        blk = self._inactive_p.exact(bsize)
        if blk is None:
            blk = self._inactive_s.exact(bsize)
        if blk is not None:
            return 1, blk, bsize

        # S2: single best-fit pBlock >= bsize.
        single = self._inactive_p.best_fit_at_least(bsize)
        if single is not None:
            return 2, single, single.size

        # S3/S4: decided by the running byte totals alone. Blocks below the
        # frag limit are not stitch sources (paper §4.2.3), which the
        # partitioned pool encodes structurally.
        avail = (
            self._inactive_p.bytes if ignore_frag_limit else self._inactive_p.main.bytes
        )
        return (3 if avail >= bsize else 4), None, avail

    def _take_stitch_candidates(
        self, bsize: int, include_sub: bool
    ) -> Tuple[Dict[int, _Seg], int, Dict['SBlock', int], List[PBlock]]:
        """Remove and return the S3 candidate set, largest blocks first.

        Walks pool buckets largest-size-first, returning the candidates as
        per-size segments (``plan``) plus the aggregated membership
        refcount Counter and the member count. A bucket consumed whole
        never needs sorting at all (blocks of one size are interchangeable
        for everything the digests pin — only the intra-stitch chunk layout
        differs, which nothing downstream reads); when the whole bucket is
        exactly one frozen segment, the slice object is moved into the new
        plan wholesale — no per-member list building (plan identity,
        round 4). The completing bucket selects its k highest ids with one
        sort over base-tail + unsettled inserts and, when the settled base
        was exhausted, leaves the sorted remainder as the new settled
        bucket — the per-size cursor consecutive same-size takes slice
        without re-sorting. Candidate *selection* — the chosen id set and
        the identity of the block that gets split — is exactly the
        id-ordered scheme's. Membership refcounts for the whole candidate
        set are counted in ONE C-level pass at the end and become the new
        block's frozen free plan. The completing block is split first when
        it would overshoot (and is at/above the frag limit), exactly as
        the per-candidate scheme did.
        """
        pool_main = self._inactive_p.main
        pools = (pool_main, self._inactive_p.sub) if include_sub else (pool_main,)
        plan: Dict[int, _Seg] = {}
        hotspots = self.hotspots
        vec = self.vectorized
        total = 0
        split_last: Optional[PBlock] = None
        keep = 0
        done = False
        for pool in pools:
            sizes = pool._sizes
            buckets = pool._buckets
            loose_map = pool._loose
            segs_map = pool._segs
            for si in range(len(sizes) - 1, -1, -1):
                size = sizes[si]
                bucket = buckets[size]
                loose = loose_map.pop(size, None)
                segs = segs_map.pop(size, None)
                n = len(bucket)
                if loose is not None:
                    n += len(loose)
                if segs is not None:
                    for g in segs:
                        n += len(g.entries)
                k = -(-(bsize - total) // size)  # blocks of `size` still needed
                if k > n:  # take the whole bucket: no order needed
                    del buckets[size]
                    sizes.pop(si)
                    pool._count -= n
                    pool.bytes -= size * n
                    total += size * n
                    if segs is not None and not bucket and loose is None and len(segs) == 1:
                        # plan identity: the bucket is exactly one frozen
                        # slice — the list object moves into the new plan
                        seg = segs[0]
                        seg.gen += 1  # consumed: prior plan stamps go stale
                        hotspots["seg_reuse"] += 1
                    else:
                        entries = bucket  # the take owns the base: reuse it
                        if loose is not None:
                            entries.extend(loose)
                        if segs is not None:
                            for g in segs:
                                g.gen += 1
                                entries.extend(g.entries)
                        seg = _Seg(size, entries)
                        hotspots["seg_recount"] += 1
                    plan[size] = seg
                    continue
                # This bucket completes the request: its k highest ids win.
                # The winners can only be the sorted base's last k entries or
                # unsettled inserts, so selection is O(k + inserts + sort) —
                # the settled bucket body is never scanned or re-sorted.
                unsettled = loose if loose is not None else []
                if segs is not None:
                    for g in segs:
                        g.gen += 1  # partial consumption breaks the slices
                        unsettled.extend(g.entries)
                cand = bucket[-k:] + unsettled if unsettled else bucket[-k:]
                del bucket[-k:]
                if unsettled:
                    cand.sort()
                top = cand[-k:]  # ascending; top[0] is the lowest winner
                rest = cand[:-k]  # candidate-window losers
                overshoot = total + size * k - bsize
                extra_removed = 0
                if overshoot and size >= self.frag_limit:
                    # the completing block — the lowest winner — is split to
                    # fit after the walk: the first half joins the stitch,
                    # the remainder half is pooled. The parent leaves the
                    # pool here, with no re-pool round trip.
                    split_last = top[0][1]
                    extra_removed = 1
                    taken = top[1:]
                    k -= 1
                    keep = size - overshoot
                    total = bsize - keep
                else:
                    taken = top
                    total += size * k
                if rest:
                    if bucket:
                        loose_map[size] = rest  # unsorted vs the settled base
                    else:
                        # the settled base is gone: the sorted remainder IS
                        # the settled bucket (per-size cursor) — consecutive
                        # same-size takes slice its tail with no sorting.
                        bucket.extend(rest)
                elif not bucket:
                    del buckets[size]
                    sizes.pop(si)
                if k:
                    plan[size] = _Seg(size, taken)
                pool._count -= k + extra_removed
                pool.bytes -= size * (k + extra_removed)
                done = True
                break
            if done:
                break
        else:
            raise AssertionError("pool byte counter out of sync with contents")
        if split_last is not None:
            a, b = self._split_parts(split_last, keep)
            self._inactive_p.add(b)
            entry = (a.pid, a)
            seg = plan.get(a.size)
            if seg is None:
                plan[a.size] = _Seg(a.size, [entry])
            else:
                seg.entries.append(entry)
                # the slice gained a member the caches never saw (the half
                # inherits its parent's membership). The per-edge CSR goes
                # stale either way, but the aggregate is patched in place
                # when present — each inherited referencing block counts
                # the half exactly once — instead of forcing a full
                # rebuild of a slice this very take just merged.
                seg.edge_sid = None
                seg.edge_ptr = None
                sids = seg.ref_sids
                if sids is None:
                    seg.ref_counts = None
                    seg.ref_extra = None
                elif a.sb_refs:
                    nh = len(a.sb_refs)
                    half_s = np.fromiter(
                        map(_get_slot, a.sb_refs), np.int64, count=nh
                    )
                    seg.ref_sids, seg.ref_counts = _merge_id_parts(
                        [sids, half_s],
                        [seg.ref_counts, np.ones(nh, dtype=np.int64)],
                    )
            total += keep
        # flatten the candidate set once — the take, the refcount pass and
        # the stitch all share this list. Both cores count the flat
        # membership edges in ONE aggregated C-level pass (the measured
        # optimum at serving scale — see _count_segs_refs); the vectorized
        # core then carries the result as a (sids, counts) array pair. The
        # counts become the new block's frozen free-plan refs, applied as
        # one batch.
        members: List[PBlock] = []
        ma = members.append
        for seg in plan.values():
            for e in seg.entries:
                ma(e[1])
        if vec:
            refs = self._count_segs_refs(list(plan.values()))
        else:
            refs = self._count_take_refs(plan.values())
        self._apply_activation(refs)
        return plan, total, refs, members

    def _count_take_refs(self, plan_segs) -> Dict["SBlock", int]:
        """The take tail's membership count pass, object path: flatten the
        candidate set's pBlock→sBlock edges once and count them in ONE
        C-level pass. Isolated as its own frame so the profile harness
        can compare it like-for-like against the vectorized merge
        (``_count_segs_refs`` + ``_merge_recount_cache``)."""
        edges: List[SBlock] = []
        for seg in plan_segs:
            for e in seg.entries:
                edges += e[1].sb_refs
        refs: Dict[SBlock, int] = {}
        _count_elements(refs, edges)
        return refs

    def _take_all(
        self, include_sub: bool, activate: bool = True
    ) -> Tuple[Dict[int, _Seg], int, Dict['SBlock', int], List[PBlock]]:
        """Drain the stitchable pool(s) for S4.

        ``activate`` applies the handout-side membership refcount bump —
        correct when the taken members are about to be stitched into a
        live block (S4). The recovery ladder's physical-reclaim rung takes
        the pools only to *destroy* the members; it must pass ``False`` or
        the referencing sBlocks' activity counters drift above the truth
        (the members never actually become active).
        """
        pool_main = self._inactive_p.main
        pools = (pool_main, self._inactive_p.sub) if include_sub else (pool_main,)
        plan: Dict[int, _Seg] = {}
        refs: Dict[SBlock, int] = {}
        members: List[PBlock] = []
        total = 0
        vec = self.vectorized
        for pool in pools:
            for size in reversed(pool._sizes):
                bucket = pool._settled(size)
                total += size * len(bucket)
                members += [e[1] for e in bucket]
                if not vec:
                    _count_entry_sids(refs, bucket)
                # main/sub sizes are disjoint partitions: no key collisions
                plan[size] = _Seg(size, bucket)
            pool._buckets = {}
            pool._loose.clear()
            pool._segs.clear()
            pool._sizes.clear()
            pool._count = 0
            pool.bytes = 0
        if vec:
            refs = self._count_segs_refs(list(plan.values()))
        if activate:
            self._apply_activation(refs)
        return plan, total, refs, members


    def malloc(self, size: int) -> Allocation:
        """Allocate ``size`` bytes (paper Fig. 9 / Algorithm 1).

        Requests under 2 MB go to the embedded splitting pool; everything
        else is chunk-rounded and served by BestFit. Raises ``AllocatorOOM``
        (state S5) only when the device truly cannot cover the request.
        """
        if size < SMALL_ALLOC_LIMIT:
            alloc = self._small.malloc(size)
            alloc.owner = self
            self.stats.on_alloc(alloc.block_size, self.reserved_bytes)
            return alloc

        self._tick += 1
        if self._pending_frees:
            self._reconcile()
        bsize = round_up(size, CHUNK_SIZE)
        try:
            block = self._malloc_vms(bsize)
        except DeviceOOM as e:
            if self._recovery_on:
                block = self._recover_vms(bsize, size)  # raises AllocatorOOM
            else:
                self.state_counts["S5"] += 1
                raise AllocatorOOM(
                    f"GMLake OOM for {size} bytes (reserved={self.reserved_bytes}, "
                    f"active={self.stats.active_bytes}, "
                    f"device_free={self.device.free_bytes})"
                ) from e
        if isinstance(block, SBlock):
            block.last_use = self._tick
        self.stats.on_alloc(block.size, self.reserved_bytes)
        return Allocation(req_size=size, block_size=block.size, block=block, owner=self)

    def _malloc_vms(self, bsize: int):
        state, blk, avail = self._best_fit(bsize)
        include_sub = False
        if state == 4:
            # If a fresh Alloc would not fit, first retry using every inactive
            # byte (ignore the frag limit), then drop cached small segments.
            if bsize - avail > self.device.free_bytes:
                state, blk, avail = self._best_fit(bsize, ignore_frag_limit=True)
                include_sub = True
                if state == 4:
                    # O(1) early-out: nothing cached means nothing to release
                    if (
                        bsize - avail > self.device.free_bytes
                        and self._small.cached_free_bytes()
                    ):
                        self._small.release_cached()
        self.state_counts[f"S{state}"] += 1

        if state == 1:
            if isinstance(blk, PBlock):
                self._activate_p(blk)
            else:
                self._hold_sblock(blk)
            return blk

        if state == 2:
            p = blk
            # paper §4.2.3: blocks below the frag limit are not split
            if p.size == bsize or p.size < self.frag_limit:
                self._activate_p(p)
                return p
            a, b = self._split(p, bsize)
            self._activate_p(a)
            # opportunistic stitch of the two halves preserves the original
            # size in the pattern tape (paper Fig. 9 state S2)
            self._stitch([a, b], total_size=p.size, active_members=1)
            return a

        if state == 3:
            plan, total, refs, members = self._take_stitch_candidates(
                bsize, include_sub
            )
            if len(members) == 1:  # degenerate after split: plain pBlock handout
                p = members[0]
                p.direct = True
                return p
            return self._stitch_plan(plan, total, refs, members)

        # state == 4: insufficient inactive blocks -> Alloc new physical memory
        new_p = self._alloc_new(bsize - avail)  # raises DeviceOOM -> S5 upstream
        if avail == 0:
            return new_p
        plan, total, refs, members = self._take_all(include_sub)
        assert total == avail, "pool byte counter out of sync with contents"
        new_p.direct = False  # joins the stitch as a generation-stamped member
        seg = plan.get(new_p.size)
        entry = (new_p.pid, new_p)
        if seg is None:
            plan[new_p.size] = _Seg(new_p.size, [entry])
        else:
            seg.entries.append(entry)
            # new_p has no referencing sBlocks yet, so the aggregated counts
            # would stay exact — but the raw CSR gains a member row, and a
            # half-valid cache is a trap: drop it all, S4 is rare
            seg.ref_sids = None
            seg.ref_counts = None
            seg.edge_sid = None
            seg.edge_ptr = None
            seg.ref_extra = None
        members.append(new_p)
        # new_p is fresh: its sb_refs are empty, no refs contribution
        return self._stitch_plan(plan, total + new_p.size, refs, members)

    # ------------------------------------------------------------------
    # deallocation: Update (no physical free)
    # ------------------------------------------------------------------
    def free(self, alloc: Allocation) -> None:
        """Paper's Update: flip state only, keep physical memory.

        pBlock frees apply eagerly (one block). sBlock frees are O(1): bump
        the activation generation — all member stamps go stale at once — and
        queue the block for the next batched reconcile. StitchFree still
        runs here when the VA budget is exceeded (reconciling first, so the
        eviction scan sees exact refcounts).
        """
        block = alloc.block
        if isinstance(block, PBlock):
            self._deactivate_p(block)
            if len(self._lru_heap) > 64 + 4 * len(self._inactive_s):
                self._compact_lru_heap()
        elif isinstance(block, SBlock):
            assert block.held, "double free of stitched block"
            # refresh last_use first so the LRU entry pushed at reconcile
            # already carries the post-free tick
            block.last_use = self._tick
            block.gen += 1
            block.held = False
            self._pending_frees.append(block)
            if self._sblock_va_bytes > self.sblock_va_budget:
                self._reconcile()  # budget may be enforceable only now
                self._maybe_stitch_free()
        else:  # small-pool block
            self._small.free(alloc)
            self.stats.on_free(alloc.block_size, self.reserved_bytes)
            return
        self.stats.on_free(alloc.block_size, self.reserved_bytes)

    def release_cached(self) -> int:
        """Release what can be released without breaking Update semantics.

        GMLake's chunks are deliberately never returned mid-run (paper:
        Update keeps physical memory; stitching re-purposes it), so the
        only releasable cache is the embedded small pool's fully-free
        segments. Also a safe point for the deferred-unmap drain (a no-op
        unless stream-ordered reclamation queued work). Returns bytes
        released.
        """
        self.drain_deferred_unmaps()
        return self._small.release_cached()

    # ------------------------------------------------------------------
    # staged OOM recovery + deferred (stream-ordered) reclamation
    # ------------------------------------------------------------------
    @property
    def pending_unmaps(self) -> int:
        """Queued physical unmaps awaiting a drain safe point."""
        return len(self._unmap_queue)

    def drain_deferred_unmaps(self) -> int:
        """Apply every queued physical unmap. Returns entries drained.

        Safe points: ``release_cached``, the recovery ladder's drain rung,
        or an explicit call between serving steps. Crash-consistent by
        construction: an entry is popped and charged atomically with
        respect to injected faults (``cu_mem_unmap``/``cu_mem_address_free``
        never fail in the device model — real streams retire unmaps
        asynchronously too), so every destroy is charged exactly once no
        matter when faults strike the allocation path.
        """
        q = self._unmap_queue
        if not q:
            return 0
        self._unmap_queue = []
        for n in q:
            self.device.cu_mem_unmap(n)
            self.device.cu_mem_address_free()
        return len(q)

    def _evict_stitchfree(self) -> int:
        """Recovery rung: StitchFree *every* inactive sBlock, budget or not.

        Frees stitched VA so its member pBlocks become plain pooled blocks
        that later rungs may physically reclaim. With deferred unmap on,
        the physical work queues for the next drain rung. Returns VA bytes
        evicted.
        """
        self._reconcile()
        self._inactive_s.sweep()
        freed = 0
        for s in list(self._inactive_s):
            freed += s.size
            self._destroy_sblock(s)
        return freed

    def _reclaim_physical(self) -> int:
        """Final reclamation rung: give pooled physical chunks back.

        Update semantics deliberately never release chunks mid-run, which
        is the right call under steady capacity — and exactly wrong after
        a capacity shrink (device loss / tenant pressure), when the device
        needs real pages back. After StitchFree eviction and a drain, every
        pooled inactive pBlock is referenced by no live sBlock (members of
        held blocks are active; pending frees were reconciled), so it can
        be unmapped, VA-freed and released. Returns bytes released.
        """
        self._evict_stitchfree()
        self.drain_deferred_unmaps()
        plan, total, refs, members = self._take_all(True, activate=False)
        del plan, total, refs  # handout bookkeeping; the blocks are doomed
        freed = 0
        for p in members:
            if p.sb_refs:
                # defensive: a still-referenced block goes back to the pool
                self._inactive_p.add(p)
                continue
            del self._pblocks[p.pid]
            if self.vectorized:
                self._vec_core.release_pb(p.slot)
            n = len(p.chunks)
            self.device.cu_mem_unmap(n)
            self.device.cu_mem_address_free()
            self.device.cu_mem_release(list(p.chunks))
            self._chunk_bytes -= p.size
            freed += p.size
        return freed

    def _recover_vms(self, bsize: int, req_size: int):
        """Walk the reclamation ladder for a failed VMS allocation.

        Rungs, cheapest first: drop small-pool cache, StitchFree-evict all
        inactive VA, drain deferred unmaps, return pooled physical chunks;
        then bounded backoff retries clear transient fault bursts. Raises
        ``AllocatorOOM`` (S5) when the ladder is exhausted.
        """
        stages = [
            ("release_small_cache", self._small.release_cached),
            ("evict_stitchfree", self._evict_stitchfree),
            ("drain_deferred_unmaps", self.drain_deferred_unmaps),
            ("reclaim_physical", self._reclaim_physical),
        ]
        try:
            return run_ladder(
                lambda: self._malloc_vms(bsize),
                stages,
                device=self.device,
                log=self.event_log,
                config=self._recovery_cfg,
                what=f"vms:{bsize}",
            )
        except DeviceOOM as e:
            self.state_counts["S5"] += 1
            raise AllocatorOOM(
                f"GMLake OOM for {req_size} bytes (reserved={self.reserved_bytes}, "
                f"active={self.stats.active_bytes}, "
                f"device_free={self.device.free_bytes})"
            ) from e

    # ------------------------------------------------------------------
    # debug / test support
    # ------------------------------------------------------------------
    def _refs_as_dict(self, refs) -> Dict[SBlock, int]:
        """Normalize a plan's frozen refcounts (Counter or array pair) to a
        plain ``{SBlock: count}`` dict for invariant comparison."""
        if not self.vectorized:
            return dict(refs)
        by_slot = self._vec_core.sb_by_slot
        sids, counts = refs
        return {
            by_slot[slot]: int(c)
            for slot, c in zip(sids.tolist(), counts.tolist())
        }

    def _check_vec_invariants(self) -> None:
        """Slot-table and cached-array invariants of the vectorized core."""
        core = self._vec_core
        # live sBlocks <-> slots: unique, alive, resolvable, exact counts
        slots_seen = set()
        for s in self._sblocks.values():
            slot = s.slot
            assert 0 <= slot < len(core.sb_by_slot), "sBlock slot out of range"
            assert slot not in slots_seen, "duplicate sBlock slot"
            slots_seen.add(slot)
            assert core.sb_alive[slot], "live sBlock with dead slot"
            assert core.sb_by_slot[slot] is s, "slot table points elsewhere"
            truth = sum(1 for p in s.members() if p.active)
            assert int(core.sb_active[slot]) == truth, "slot activity drifted"
        alive_slots = set(np.flatnonzero(core.sb_alive).tolist())
        assert alive_slots == slots_seen, "sb_alive disagrees with registry"
        # free / quarantined slots are disjoint from live and from each other
        free = set(core._sb_free)
        quarantined = set(core._sb_quarantine)
        assert len(free) == len(core._sb_free), "duplicate free slot"
        assert not (free & slots_seen), "live slot on the free list"
        assert not (quarantined & slots_seen), "live slot quarantined"
        assert not (free & quarantined), "slot both free and quarantined"
        # pBlock slots: dense, unique among live blocks
        pb_slots = [p.slot for p in self._pblocks.values()]
        assert all(sl >= 0 for sl in pb_slots), "unslotted live pBlock"
        assert len(set(pb_slots)) == len(pb_slots), "duplicate pBlock slot"
        # cached segment arrays: after an aliveness purge, the aggregate
        # must equal a fresh count of the slice's membership edges, and a
        # surviving CSR must aggregate to exactly that
        pool_segs = [
            seg
            for pool in (self._inactive_p.main, self._inactive_p.sub)
            for segs in pool._segs.values()
            for seg in segs
        ]
        # gen-stale plan segments (slice consumed by a later take) keep
        # whatever cache they had when the plan froze — harmless, because
        # the gen check rejects the plan before any cache read. Only
        # gen-valid segments must stay exact.
        plan_segs = [
            seg
            for s in self._sblocks.values()
            if s._plan is not None
            for seg, _g in s._plan
            if seg.gen == _g
        ]
        alive = core.sb_alive
        for seg in pool_segs + plan_segs:
            if seg.ref_sids is None:
                # a CSR never outlives its aggregate (every invalidation
                # site drops the pair together)
                assert seg.edge_sid is None and seg.edge_ptr is None
            # builds the aggregate on miss, folds buffered appends on hit
            # — the checker is what keeps the cache/fold/CSR machinery
            # exercised now that the hot take path counts edges directly
            sids, counts = self._seg_refs(seg)
            fresh: Dict[int, int] = {}
            for _pid, p in seg.entries:
                _count_elements(fresh, map(_get_slot, p.sb_refs))
            # cached arrays may still name destroyed slots (destroys never
            # walk the caches); mask-compact here — sound at any time, since
            # a dead slot stays quarantined until ``_compact_dead_log``
            # drops every cache — so the invariant is: the *alive* subset
            # must equal a fresh count
            if sids.size:
                keep = alive[sids]
                if not keep.all():
                    sids = sids[keep]
                    counts = counts[keep]
                    seg.ref_sids = sids
                    seg.ref_counts = counts
                    core.counters["ref_purges"] += 1
            cached = dict(zip(sids.tolist(), counts.tolist()))
            assert cached == fresh, "cached segment refcounts drifted"
            # materialize a *fresh* CSR (a cached one may predate destroys
            # — `sb_refs` scrubbing changes the edge list under it) and
            # cross-validate its layout and aggregation
            seg.edge_sid = None
            seg.edge_ptr = None
            edge_sid, ptr = self._seg_edges(seg)
            assert len(ptr) == len(seg.entries) + 1
            assert ptr[0] == 0 and ptr[-1] == len(edge_sid)
            csr: Dict[int, int] = {}
            _count_elements(csr, edge_sid.tolist())
            assert csr == fresh, "CSR edges disagree with aggregate"

    def check_invariants(self) -> None:
        """Validate every structural invariant (test/debug only; O(blocks)).

        Verifies the round-4 frozen-segment invariants first (a frozen
        segment's cached Counter must equal a fresh count of its members'
        sid arrays — the property that makes plan-identity reuse
        bit-identical), then reconciles pending frees and checks the
        classic pool/refcount/LRU invariants. Reconciliation timing is
        unobservable to callers, so this never perturbs replay behaviour
        (the settle it forces kills frozen segments, which only disables
        reuse — never changes outcomes).
        """
        # held / pending-free blocks: plans attached, owned, and exact
        for s in self._sblocks.values():
            if s.held or s in self._pending_frees:
                assert s._plan is not None, "held stitched block without a plan"
                members = s.members()
                plan_n = sum(len(seg.entries) for seg, _g in s._plan)
                assert plan_n == len(members)
                plan_pids = {e[0] for seg, _g in s._plan for e in seg.entries}
                assert plan_pids == {p.pid for p in members}
                truth: Dict[SBlock, int] = {}
                for seg, gen in s._plan:
                    assert seg.owner is s
                    assert seg.gen == gen, "plan generation drifted while held"
                    assert all(e[1].size == seg.size for e in seg.entries)
                    _count_entry_sids(truth, seg.entries)
                assert self._refs_as_dict(s._refs) == truth, (
                    "frozen plan refs drifted"
                )
        # inactive cached plans: when every generation still matches (the
        # S1 fast path would fire), the cached Counter must equal a fresh
        # count after the dead-log replay — the plan-identity soundness
        # property itself
        for s in self._sblocks.values():
            plan = s._plan
            if (
                plan is not None and not s.held
                and s not in self._pending_frees
                and all(seg.gen == g and seg.owner is None for seg, g in plan)
                and sum(len(seg.entries) for seg, _g in plan) == len(s.members())
            ):
                self._purge_refs(s)
                truth = {}
                for seg, _g in plan:
                    _count_entry_sids(truth, seg.entries)
                assert self._refs_as_dict(s._refs) == truth, (
                    "cached plan refs drifted"
                )
        # pooled frozen segments: unowned and sized right
        for pool in (self._inactive_p.main, self._inactive_p.sub, self._inactive_s):
            for size, segs in pool._segs.items():
                for seg in segs:
                    assert seg.size == size
                    assert seg.owner is None
                    for pid, p in seg.entries:
                        assert p.pid == pid and p.size == size
                        assert p.split_into is None, "split inside frozen slice"

        self._reconcile()
        self._inactive_s.sweep()  # drop lazily-delisted (stale) entries
        if self.vectorized:
            self._check_vec_invariants()
        seen_chunks: Dict[int, int] = {}
        inactive_ids = {p.pid for p in self._inactive_p}
        for p in self._pblocks.values():
            assert p.split_into is None, "split parent still registered"
            for c in p.chunks:
                assert c not in seen_chunks, f"chunk {c} owned by two pBlocks"
                seen_chunks[c] = p.pid
            # active blocks are never pooled; inactive blocks always are
            assert (p.pid in inactive_ids) == (not p.active)
        inactive_s_ids = {s.sid for s in self._inactive_s}
        lru_entries = set(self._lru_heap)
        for s in self._sblocks.values():
            members = s.members()
            assert s.size == sum(p.size for p in members)
            assert s.n_members == len(members)
            active_n = self._active_of(s)
            assert active_n == sum(1 for p in members if p.active)
            assert s.active == (active_n > 0)
            if s.held:  # held: every member stamped with the current gen
                assert all(
                    p.holder is s and p.holder_gen == s.gen for p in members
                )
            assert (s.sid in inactive_s_ids) == (not s.active)
            if not s.active:  # every inactive sBlock is reachable by StitchFree
                assert (s.last_use, s.sid) in lru_entries
            for p in members:
                assert s in p.sb_refs
                assert p.sb_refs.count(s) == 1
                assert p.pid in self._pblocks
        assert len(seen_chunks) * CHUNK_SIZE == self._chunk_bytes
        assert self._sblock_va_bytes == sum(s.size for s in self._sblocks.values())
        assert self.peak_sblock_va >= self._sblock_va_bytes
        # the drain queue only ever fills under stream-ordered reclamation
        assert self._deferred_unmap or not self._unmap_queue
        # partition routing + running byte counters
        for pool, below in ((self._inactive_p.sub, True), (self._inactive_p.main, False)):
            assert pool.bytes == sum(p.size for p in pool)
            assert len(pool) == sum(1 for _ in pool)
            for p in pool:
                assert (p.size < self.frag_limit) == below
        assert self._inactive_s.bytes == sum(s.size for s in self._inactive_s)
