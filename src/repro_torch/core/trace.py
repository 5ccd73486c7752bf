"""Allocation traces: recording, synthesis from model configs, and replay.

The paper evaluates allocators by running LLM fine-tuning under strategy
combinations (L = LoRA, R = recomputation, O = offload) on ZeRO-sharded
multi-GPU setups and measuring fragmentation. We reproduce that pipeline by
synthesising the *allocator-visible* event stream of one rank from first
principles (exact tensor inventory of the model config x the strategy's
lifetime rules), then replaying it through both allocators over the device
model. The serving engine and offload manager also emit real traces through
``TraceRecorder`` so framework-level behaviour can be replayed identically.

Structure of one synthetic training iteration (rank 0 of ``world`` GPUs):

  forward:   [ZeRO-3: all-gather full layer params (transient)]
             workspaces (sizes cycle across iterations -> irregularity)
             activations (full set, or checkpoint-only under R)
             logits at the end (large, short-lived)
  backward:  [ZeRO-3: re-gather params], recompute under R (re-alloc + free
             the intra-layer activations), transient full grads ->
             reduce-scattered shards (persist to step), LoRA keeps only
             adapter grads
  step:      [O: staging buffers for CPU<->GPU shard swaps], frees shards

This matches the paper's observation (Fig. 5): richer strategies => more
and smaller allocations => fragmentation for the splitting allocator.
"""

from __future__ import annotations

import itertools
import json
import random
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from ..alloc import registry as _registry
from ..alloc.caching_allocator import AllocatorOOM
from ..alloc.chunks import GB, MB, FaultInjector, FaultSchedule, VMMDevice
from ..alloc.metrics import ReplayResult

BF16 = 2
FP32 = 4


# ---------------------------------------------------------------------------
# events
# ---------------------------------------------------------------------------

ALLOC, FREE, MARK = "alloc", "free", "mark"

#: integer opcodes for the compiled event stream (see ``Trace.compiled``)
_OP_ALLOC, _OP_FREE, _OP_MARK = 0, 1, 2
_OP_CODES = {ALLOC: _OP_ALLOC, FREE: _OP_FREE, MARK: _OP_MARK}


@dataclass(frozen=True)
class TraceEvent:
    """One allocator-visible event: alloc(tid, size) / free(tid) / mark.

    ``mark`` events carry phase labels (iteration boundaries, "end") and are
    where replay snapshots the S1-S5 state counters for convergence plots
    (paper Fig. 14).
    """

    op: str
    tid: int
    size: int = 0
    label: str = ""
    #: multi-tenant serving provenance (empty outside serving recordings):
    #: which tenant issued the request and its SLO class name. Optional
    #: columns in the JSON form — absent entirely when every value is
    #: empty, so pre-multitenant recordings round-trip byte-identical.
    tenant: str = ""
    slo: str = ""


@dataclass
class Trace:
    """An ordered allocator event stream plus provenance metadata.

    Traces are the unit of evaluation: synthesised from model configs
    (``training_trace``/``inference_trace``) or recorded from the real
    framework components, then replayed through any allocator over the
    device model. ``compiled()`` caches the flat-array form the batched
    replay loop consumes.
    """

    events: List[TraceEvent] = field(default_factory=list)
    meta: Dict[str, object] = field(default_factory=dict)

    def __len__(self):
        return len(self.events)

    @property
    def n_allocs(self) -> int:
        return sum(1 for e in self.events if e.op == ALLOC)

    @property
    def mean_alloc_mb(self) -> float:
        sizes = [e.size for e in self.events if e.op == ALLOC]
        return (sum(sizes) / len(sizes) / MB) if sizes else 0.0

    def compiled(self) -> Tuple[List[int], List[int], List[int], List[str]]:
        """Event stream as parallel (ops, tids, sizes, labels) lists.

        Integer opcodes and flat lists replace per-event dataclass attribute
        lookups in the batched replay loop. The compilation is cached and
        invalidated if the trace grows (recorders append in place).
        """
        cached = getattr(self, "_compiled", None)
        if cached is not None and cached[4] == len(self.events):
            return cached[:4]
        ops: List[int] = []
        tids: List[int] = []
        sizes: List[int] = []
        labels: List[str] = []
        for e in self.events:
            ops.append(_OP_CODES[e.op])
            tids.append(e.tid)
            sizes.append(e.size)
            labels.append(e.label)
        self._compiled = (ops, tids, sizes, labels, len(self.events))
        return ops, tids, sizes, labels

    # -- persistence --------------------------------------------------------
    def to_jsonable(self) -> dict:
        """Columnar JSON form (compact, diff-friendly, replayable).

        Recorded engine traces are checked into the repo in this format so
        the golden/bench suites can replay real framework event streams
        without re-running the engine (or needing jax at test time).
        """
        ops, tids, sizes, labels = self.compiled()
        payload = {
            "format": "repro.trace.v1",
            "meta": self.meta,
            "ops": ops,
            "tids": tids,
            "sizes": sizes,
            "labels": labels,
        }
        # optional multi-tenant columns: only materialized when any event
        # carries them, so pre-multitenant files stay byte-identical
        if any(e.tenant or e.slo for e in self.events):
            payload["tenants"] = [e.tenant for e in self.events]
            payload["slos"] = [e.slo for e in self.events]
        return payload

    @classmethod
    def from_jsonable(cls, payload: dict) -> "Trace":
        if payload.get("format") != "repro.trace.v1":
            raise ValueError(f"not a repro trace payload: {payload.get('format')!r}")
        op_names = {v: k for k, v in _OP_CODES.items()}
        n = len(payload["ops"])
        tenants = payload.get("tenants", [""] * n)
        slos = payload.get("slos", [""] * n)
        events = [
            TraceEvent(op_names[op], tid, size, label, tenant, slo)
            for op, tid, size, label, tenant, slo in zip(
                payload["ops"], payload["tids"], payload["sizes"],
                payload["labels"], tenants, slos,
            )
        ]
        return cls(events=events, meta=dict(payload.get("meta", {})))

    def save(self, path: Union[str, "os.PathLike"]) -> None:
        with open(path, "w") as f:
            json.dump(self.to_jsonable(), f, separators=(",", ":"))
            f.write("\n")


def load_trace(path) -> Trace:
    """Load a checked-in ``Trace`` (see ``Trace.save``/``to_jsonable``)."""
    with open(path) as f:
        return Trace.from_jsonable(json.load(f))


class TraceRecorder:
    """Incremental trace builder used by the generators and by the real
    framework components (serving engine, offload manager)."""

    def __init__(self, **meta):
        self.trace = Trace(meta=dict(meta))
        self._next_tid = itertools.count()
        self.live: Dict[int, int] = {}
        self._ctx_tenant = ""
        self._ctx_slo = ""

    def set_context(self, tenant: str = "", slo: str = "") -> None:
        """Set the tenant/SLO stamped on subsequent allocs (serving uses
        this around KV-cache calls so deep allocation sites need no
        plumbing). Clear by calling with defaults."""
        self._ctx_tenant = tenant
        self._ctx_slo = slo

    def alloc(self, size: int, label: str = "") -> int:
        assert size > 0, f"alloc of size {size}"
        tid = next(self._next_tid)
        self.live[tid] = size
        self.trace.events.append(
            TraceEvent(
                ALLOC, tid, int(size), label, self._ctx_tenant, self._ctx_slo
            )
        )
        return tid

    def free(self, tid: int) -> None:
        del self.live[tid]
        self.trace.events.append(TraceEvent(FREE, tid))

    def mark(self, label: str) -> None:
        self.trace.events.append(TraceEvent(MARK, -1, 0, label))

    def free_all(self) -> None:
        for tid in list(self.live):
            self.free(tid)


# ---------------------------------------------------------------------------
# model descriptors (paper's benchmark table + hooks for assigned archs)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelDesc:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int

    @property
    def kv_dim(self) -> int:
        return self.d_model // self.n_heads * self.n_kv

    def layer_param_tensors(self) -> List[int]:
        """Per-layer weight tensor sizes in bytes (bf16)."""
        d, ff, kv = self.d_model, self.d_ff, self.kv_dim
        return [
            d * (d + 2 * kv) * BF16,  # fused qkv
            d * d * BF16,  # attn out proj
            d * ff * BF16,  # mlp up
            ff * d * BF16,  # mlp down
        ]

    @property
    def layer_param_bytes(self) -> int:
        return sum(self.layer_param_tensors())

    @property
    def embed_bytes(self) -> int:
        return self.vocab * self.d_model * BF16

    @property
    def param_bytes(self) -> int:
        return self.n_layers * self.layer_param_bytes + self.embed_bytes


#: The paper's Table 2 models (public configs).
PAPER_MODELS: Dict[str, ModelDesc] = {
    m.name: m
    for m in [
        ModelDesc("opt-1.3b", 24, 2048, 32, 32, 8192, 50272),
        ModelDesc("gpt2-1.5b", 48, 1600, 25, 25, 6400, 50257),
        ModelDesc("glm-10b", 48, 4096, 64, 64, 16384, 150528),
        ModelDesc("opt-13b", 40, 5120, 40, 40, 20480, 50272),
        ModelDesc("vicuna-13b", 40, 5120, 40, 40, 13824, 32000),
        ModelDesc("gpt-neox-20b", 44, 6144, 64, 64, 24576, 50432),
    ]
}


# ---------------------------------------------------------------------------
# synthetic fine-tuning trace generator
# ---------------------------------------------------------------------------

#: sequence-length bucket multipliers cycled across iterations. Fine-tuning
#: datasets are length-bucketed, so the token count per step cycles through a
#: small set of values; this is the "dynamicity" the paper blames for
#: fragmentation (§2.3) and its cycle length is why GMLake "converges after
#: ~4 iterations" (Fig. 14): after one full cycle every request size has been
#: seen and S1 always hits.
_SEQ_BUCKETS = (1.0, 0.625, 1.25, 0.8125)


def training_trace(
    model: ModelDesc,
    strategies: str = "",
    world: int = 1,
    batch: int = 8,
    seq: int = 2048,
    iters: int = 8,
    platform: str = "deepspeed",
    zero_stage: int = 3,
    lora_rank: int = 16,
    prefetch: int = 1,
    seed: int = 0,
) -> Trace:
    """Synthesise the rank-0 allocator event stream for one fine-tuning run.

    ``strategies``: subset of "LRO". ``platform``: deepspeed (per-param
    ZeRO-3 gathers, prefetch overlap) | fsdp (one flat gather per layer) |
    colossal (fixed 64 MB chunk gathers). ``world == 1`` disables
    sharding/gathers. ``prefetch``: how many upcoming layers' parameter
    gathers are held live simultaneously (DeepSpeed prefetching) — this
    makes frees non-LIFO, a key fragmentation driver.
    """
    L, R, O = "L" in strategies, "R" in strategies, "O" in strategies
    rng = random.Random(seed)
    rec = TraceRecorder(
        model=model.name, strategies=strategies, world=world, batch=batch,
        seq=seq, iters=iters, platform=platform,
    )
    d, ff, nl, v = model.d_model, model.d_ff, model.n_layers, model.vocab

    sharded = world > 1 and zero_stage >= 3
    shard = lambda b: max(b // world, 1)  # noqa: E731

    # persistent state: parameters (+ optimizer state unless offloaded/LoRA)
    for li in range(nl):
        for t in model.layer_param_tensors():
            rec.alloc(shard(t) if sharded else t, f"param.L{li}")
    rec.alloc(shard(model.embed_bytes) if sharded else model.embed_bytes, "embed")
    trainable_layer_tensors = (
        # LoRA adapters: rank decomposition per projection, tiny
        [2 * lora_rank * d * BF16] * 4 if L else model.layer_param_tensors()
    )
    if not O:  # optimizer states (m, v, master) live on GPU unless offloaded
        for li in range(nl):
            for t in trainable_layer_tensors:
                n_params = t // BF16
                opt = n_params * (FP32 * 3)
                rec.alloc(shard(opt) if sharded and not L else opt, f"opt.L{li}")

    def gathers_for_layer() -> List[int]:
        if not sharded:
            return []
        if platform == "fsdp":
            return [model.layer_param_bytes]
        if platform == "colossal":
            chunk = 64 * MB
            total = model.layer_param_bytes
            return [chunk] * (total // chunk) + ([total % chunk] if total % chunk else [])
        return list(model.layer_param_tensors())  # deepspeed: per-param

    def gather_window(order: Sequence[int], phase: str):
        """Yields per-layer gather tids, holding ``prefetch`` layers ahead
        live (DeepSpeed prefetching => non-LIFO frees)."""
        depth = (prefetch if platform == "deepspeed" else 0) if sharded else 0
        order = list(order)
        pending: List[List[int]] = []
        nxt = 0
        for j, li in enumerate(order):
            while nxt <= min(j + depth, len(order) - 1):
                lay = order[nxt]
                pending.append(
                    [rec.alloc(s, f"{phase}_gather.L{lay}") for s in gathers_for_layer()]
                )
                nxt += 1
            cur = pending.pop(0)
            yield li, cur
            for t in cur:
                rec.free(t)

    for it in range(iters):
        rec.mark(f"iter{it}")
        bucket = _SEQ_BUCKETS[it % len(_SEQ_BUCKETS)]
        seq_t = int(seq * bucket)
        act = batch * seq_t * d * BF16  # residual-stream activation
        act_ff = batch * seq_t * ff * BF16
        logits = batch * seq_t * v * BF16
        ws_sizes = [act, act // 2]

        # in-flight offload staging buffers: freed with a completion delay
        inflight: List[List[int]] = []

        def drain_inflight(completely: bool = False) -> None:
            while inflight and (completely or len(inflight) > 2):
                for t in inflight.pop(0):
                    rec.free(t)

        # ---------------- forward ----------------
        acts: List[List[int]] = []
        rec.alloc(act, "embed_out")
        fwd = gather_window(range(nl), "fwd") if sharded else ((li, []) for li in range(nl))
        for li, _g in fwd:
            ws = [rec.alloc(s, f"ws.L{li}") for s in rng.sample(ws_sizes, len(ws_sizes))]
            if R:
                acts.append([rec.alloc(act, f"ckpt.L{li}")])
            else:
                acts.append([
                    rec.alloc(act, f"attn_in.L{li}"),
                    rec.alloc(act, f"attn_out.L{li}"),
                    rec.alloc(act_ff, f"mlp_h.L{li}"),
                    rec.alloc(act, f"mlp_out.L{li}"),
                ])
            for t in ws:
                rec.free(t)
        lg = rec.alloc(logits, "logits")
        loss_ws = rec.alloc(logits // 2, "loss_ws")
        rec.free(loss_ws)

        # ---------------- backward ----------------
        dlg = rec.alloc(logits, "dlogits")
        rec.free(lg)
        dx = rec.alloc(act, "dact")
        rec.free(dlg)
        grad_shards: List[int] = []
        bwd = (
            gather_window(reversed(range(nl)), "bwd")
            if sharded
            else ((li, []) for li in reversed(range(nl)))
        )
        for li, _g in bwd:
            recomputed = []
            if R:  # re-run forward of the layer
                recomputed = [
                    rec.alloc(act, f"re.attn_in.L{li}"),
                    rec.alloc(act, f"re.attn_out.L{li}"),
                    rec.alloc(act_ff, f"re.mlp_h.L{li}"),
                    rec.alloc(act, f"re.mlp_out.L{li}"),
                ]
            ws = rec.alloc(act_ff, f"bwd_ws.L{li}")
            # parameter gradients
            if L:
                for t in trainable_layer_tensors:
                    grad_shards.append(rec.alloc(t, f"lora_grad.L{li}"))
            else:
                full = [rec.alloc(t, f"grad.L{li}") for t in model.layer_param_tensors()]
                if sharded:
                    for t, sz in zip(full, model.layer_param_tensors()):
                        grad_shards.append(rec.alloc(shard(sz), f"gshard.L{li}"))
                        rec.free(t)
                else:
                    grad_shards.extend(full)
                if O and not L:
                    # ZeRO-Offload: grad shards stream to CPU during backward;
                    # staging buffers complete asynchronously (delayed frees)
                    inflight.append(
                        [rec.alloc(shard(t) if sharded else t, f"grad_stage.L{li}")
                         for t in model.layer_param_tensors()]
                    )
                    drain_inflight()
            ndx = rec.alloc(act, f"dact.L{li}")
            rec.free(dx)
            dx = ndx
            rec.free(ws)
            for t in recomputed:
                rec.free(t)
            for t in acts[li]:
                rec.free(t)
        rec.free(dx)
        drain_inflight(completely=True)

        # ---------------- optimizer step ----------------
        if O:
            # updated parameters stream back from CPU: transient staging
            for li in range(nl):
                for t in trainable_layer_tensors:
                    inflight.append([rec.alloc(shard(t) if sharded and not L else t, f"p_stage.L{li}")])
                    drain_inflight()
            drain_inflight(completely=True)
        else:
            step_ws = rec.alloc(ws_sizes[0], "step_ws")
            rec.free(step_ws)
        for t in grad_shards:
            rec.free(t)

    rec.mark("end")
    return rec.trace


def inference_trace(
    model: ModelDesc,
    n_requests: int = 64,
    max_new: int = 128,
    batch: int = 8,
    seed: int = 0,
) -> Trace:
    """Continuous-batching KV-cache churn: variable-length sequences arrive,
    grow, and retire — the serving-side fragmentation workload."""
    rng = random.Random(seed)
    rec = TraceRecorder(model=model.name, kind="serve", n_requests=n_requests)
    per_tok = 2 * model.kv_dim * model.n_layers * BF16  # K+V per token
    live: List[Tuple[int, int]] = []  # (tid, remaining steps)
    for r in range(n_requests):
        prompt = rng.randint(64, 4096)
        kv = rec.alloc(prompt * per_tok, f"kv.r{r}")
        live.append((kv, rng.randint(8, max_new)))
        # decode steps: grow some sequences by reallocating their KV block
        step_done = []
        for i, (tid, rem) in enumerate(live):
            if rem <= 0:
                step_done.append(i)
                continue
            live[i] = (tid, rem - rng.randint(1, 8))
        for i in reversed(step_done):
            rec.free(live[i][0])
            live.pop(i)
        if len(live) > batch:  # retire oldest past batch budget
            tid, _ = live.pop(0)
            rec.free(tid)
    for tid, _ in live:
        rec.free(tid)
    return rec.trace


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------


def _resolve_allocator(
    allocator,
    trace=None,
    capacity_bytes: int = 80 * GB,
    record_timeline: bool = False,
    fault_schedule: Optional[FaultSchedule] = None,
    **alloc_kwargs,
):
    """Backend instance from a registry key or a protocol instance.

    This is what makes every replay entry point backend-generic: strings
    construct a fresh backend over a fresh device, instances pass through.
    Backends that plan from a profiled trace (``capabilities.planning`` /
    ``needs_prepare``) get their ``prepare(trace)`` pass here — outside
    the timed replay loop, matching their offline-profiling deployment.

    ``fault_schedule`` wraps the fresh device in a seed-scheduled
    ``FaultInjector`` (registry keys only — an instance already bound its
    device; wrap it yourself before constructing); backends auto-detect
    the injector and enable their recovery ladder.
    """
    if fault_schedule is not None:
        if not isinstance(allocator, str):
            raise ValueError(
                "fault_schedule requires a registry key (the injector wraps "
                "a fresh device); for an instance, construct it over "
                "FaultInjector(VMMDevice(...), schedule) yourself"
            )
        factory = lambda: FaultInjector(VMMDevice(capacity_bytes), fault_schedule)
    else:
        factory = lambda: VMMDevice(capacity_bytes)
    allocator = _registry.resolve(allocator, factory, record_timeline, **alloc_kwargs)
    if trace is not None and getattr(allocator, "needs_prepare", False):
        allocator.prepare(trace)
    return allocator


def _replay_result(allocator, wall, oom, oom_at) -> ReplayResult:
    event_log = getattr(allocator, "event_log", None)
    # vectorized-core observability (GMLake round 5), surfaced exactly like
    # recovery summaries: snapshot the backend's counter dict when present
    vec_counters = getattr(allocator, "vec_counters", None)
    hybrid_counters = getattr(allocator, "hybrid_counters", None)
    return ReplayResult(
        name=allocator.name,
        stats=allocator.stats,
        model_cost=allocator.device.ledger.total,
        wall_seconds=wall,
        oom=oom,
        oom_at_event=oom_at,
        state_counts=dict(getattr(allocator, "state_counts", {})) or None,
        recovery=event_log.summary() if event_log is not None and len(event_log) else None,
        vec_counters=dict(vec_counters) if vec_counters is not None else None,
        hybrid_counters=(
            dict(hybrid_counters) if hybrid_counters is not None else None
        ),
    )


def replay(
    trace: Trace,
    allocator,
    stop_on_oom: bool = True,
    check_invariants_every: int = 0,
    capacity_bytes: int = 80 * GB,
    fault_schedule: Optional[FaultSchedule] = None,
    **alloc_kwargs,
) -> ReplayResult:
    """Feed a trace through an allocator; returns metrics + cost + wall time.

    ``allocator`` is either a backend instance or a registry key
    (``"caching"``, ``"gmlake"``, ``"stalloc"``, ... — see
    ``repro.alloc.registry``); keys construct a fresh backend over a fresh
    ``VMMDevice(capacity_bytes)``. Planning backends are prepared on this
    trace before the loop starts, so profiling never pollutes
    ``wall_seconds``.

    The per-event loop is the measured host hot path (``wall_seconds``): the
    allocator methods are pre-bound, the OOM try/except wraps whole loop runs
    instead of single events, and the invariant-sampling branch lives in a
    separate loop variant so the common case pays nothing for it.

    ``check_invariants_every=n`` calls ``allocator.check_invariants()`` every
    n events. For GMLake this also forces a reconcile of deferred sBlock
    frees — which is timing-transparent by design, a property the golden
    tests pin by replaying at several cadences (see
    ``tests/test_golden_equivalence.py::test_reconcile_timing_is_unobservable``).

    ``fault_schedule`` replays under injected VMM faults (see
    ``FaultInjector``): transient failures and capacity shrinks surface as
    ``AllocatorOOM`` only when a backend's recovery ladder is exhausted.

    Extra keyword arguments are forwarded to the backend constructor when
    ``allocator`` is a registry key (e.g. ``vectorized=False`` or
    ``va_budget="tight"`` for gmlake's array-core / StitchFree knobs).
    """
    allocator = _resolve_allocator(
        allocator, trace, capacity_bytes, fault_schedule=fault_schedule,
        **alloc_kwargs,
    )
    live: Dict[int, object] = {}
    oom = False
    oom_at = None
    marks: List[Tuple[str, dict]] = []
    events = trace.events
    n = len(events)
    malloc = allocator.malloc
    free = allocator.free
    live_pop = live.pop
    # the S1-S5 counter dict never changes identity mid-replay: resolve it
    # once instead of a getattr per mark event (round 4)
    state_counts = getattr(allocator, "state_counts", None)
    check = check_invariants_every
    i = 0
    t0 = time.perf_counter()
    while i < n:
        try:
            if check:
                while i < n:
                    ev = events[i]
                    op = ev.op
                    if op == ALLOC:
                        live[ev.tid] = malloc(ev.size)
                    elif op == FREE:
                        alloc = live_pop(ev.tid, None)
                        if alloc is not None:  # may have been dropped after OOM
                            free(alloc)
                    else:
                        marks.append(
                            (ev.label, dict(state_counts) if state_counts else {})
                        )
                    if i % check == 0:
                        allocator.check_invariants()
                    i += 1
            else:
                while i < n:
                    ev = events[i]
                    op = ev.op
                    if op == ALLOC:
                        live[ev.tid] = malloc(ev.size)
                    elif op == FREE:
                        alloc = live_pop(ev.tid, None)
                        if alloc is not None:
                            free(alloc)
                    else:
                        marks.append(
                            (ev.label, dict(state_counts) if state_counts else {})
                        )
                    i += 1
        except AllocatorOOM:
            oom = True
            oom_at = i
            if stop_on_oom:
                break
            if check and i % check == 0:
                allocator.check_invariants()
            i += 1
    wall = time.perf_counter() - t0
    return _replay_result(allocator, wall, oom, oom_at), marks


def replay_batched(
    trace: Trace,
    allocator,
    stop_on_oom: bool = True,
    batch_size: int = 8192,
    capacity_bytes: int = 80 * GB,
    fault_schedule: Optional[FaultSchedule] = None,
    **alloc_kwargs,
) -> ReplayResult:
    """Replay over the pre-compiled event arrays in fixed-size batches.

    Semantically identical to ``replay`` (same ReplayResult, same marks,
    same registry-key-or-instance ``allocator``); the win is mechanical:
    ``Trace.compiled()`` amortizes event decoding across replays, integer
    opcodes replace string compares, and the exception scope is one batch
    rather than one event. Stats stay exact — ``AllocatorStats`` binds its
    no-timeline fast path at construction when ``record_timeline`` is off,
    which is what makes the per-event accounting cheap enough here.

    Extra keyword arguments are forwarded to the backend constructor when
    ``allocator`` is a registry key, as in ``replay``.
    """
    allocator = _resolve_allocator(
        allocator, trace, capacity_bytes, fault_schedule=fault_schedule,
        **alloc_kwargs,
    )
    ops, tids, sizes, labels = trace.compiled()
    live: Dict[int, object] = {}
    oom = False
    oom_at = None
    marks: List[Tuple[str, dict]] = []
    n = len(ops)
    malloc = allocator.malloc
    free = allocator.free
    live_pop = live.pop
    state_counts = getattr(allocator, "state_counts", None)
    i = 0
    stop = False
    t0 = time.perf_counter()
    while i < n and not stop:
        end = i + batch_size
        if end > n:
            end = n
        try:
            while i < end:
                op = ops[i]
                if op == _OP_ALLOC:
                    live[tids[i]] = malloc(sizes[i])
                elif op == _OP_FREE:
                    alloc = live_pop(tids[i], None)
                    if alloc is not None:
                        free(alloc)
                else:
                    marks.append(
                        (labels[i], dict(state_counts) if state_counts else {})
                    )
                i += 1
        except AllocatorOOM:
            oom = True
            oom_at = i
            if stop_on_oom:
                stop = True
            else:
                i += 1
    wall = time.perf_counter() - t0
    return _replay_result(allocator, wall, oom, oom_at), marks


def run_workload(
    trace: Trace,
    allocator,
    capacity_bytes: int = 80 * GB,
    record_timeline: bool = False,
    fault_schedule: Optional[FaultSchedule] = None,
    **alloc_kwargs,
) -> ReplayResult:
    """Convenience: fresh device + backend, replay, return result.

    ``allocator`` is any registered backend key (``repro.alloc.registry``)
    or an already-constructed protocol instance.
    """
    allocator = _resolve_allocator(
        allocator,
        trace,
        capacity_bytes,
        record_timeline,
        fault_schedule=fault_schedule,
        **alloc_kwargs,
    )
    result, _ = replay(trace, allocator)
    return result
