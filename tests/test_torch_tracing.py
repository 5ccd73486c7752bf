"""The port's tracer (``repro_torch.utils.tracing``) and the spans and
counters placed in the engine, the model API, the blocked attention, the
KV lake and the train step.

CPU tests, except the last two, which need a CUDA card (``card`` marker;
``PYTHONPATH=src python -m pytest -m card tests/test_torch_tracing.py`` on
a CUDA host): a graph replay's phase events and the wait tracing adds.
No JAX here, so the card tests run where JAX is not installed.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from repro_torch.configs import get_arch
from repro_torch.core.kvcache import KVCacheConfig, StitchedKVCache
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve.engine import EngineConfig, ServeEngine
from repro_torch.train import optimizer as opt
from repro_torch.train.graph import GraphedStep
from repro_torch.train.step import init_state, make_train_step
from repro_torch.tree import leaves
from repro_torch.utils import tracing

SMOKE = get_arch("smollm-135m").smoke


@pytest.fixture(autouse=True)
def fresh_record():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def params():
    return T.init_params(SMOKE, torch.Generator().manual_seed(0), device="cpu")


def serve(params, traced: bool, max_batch=3):
    """A smoke engine over seven requests, three of them admitted in one
    step, run to completion; returns the engine."""
    eng = ServeEngine(SMOKE, params, EngineConfig(max_batch=max_batch, max_len=96,
                                                  n_chunks=64, device="cpu"))
    rng = np.random.default_rng(5)
    for i in range(7):
        eng.submit(rng.integers(0, SMOKE.vocab, size=9 + 7 * i), max_new=2 + i % 4)
    if traced:
        tracing.enable()
    try:
        eng.run_to_completion()
    finally:
        tracing.disable()
    return eng


def names_of(snap):
    return [s.name for s in snap["spans"]]


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------


def test_nesting_parent_index_and_self_time():
    tracing.enable()
    with tracing.span("a", req=7):
        with tracing.span("b"):
            torch.ones(64).sum()
        with tracing.span("b"):
            with tracing.span("c", req=7):
                pass
    snap = tracing.snapshot()
    spans = snap["spans"]
    assert names_of(snap) == ["b", "c", "b", "a"]  # in the order they close
    a = spans[-1]
    assert (a.index, a.parent, a.req) == (0, -1, 7)
    assert spans[0].parent == 0 and spans[2].parent == 0
    assert spans[1].parent == spans[2].index and spans[1].req == 7
    assert all(s.start_ns <= s.end_ns for s in spans)
    n = snap["names"]
    assert n["b"]["count"] == 2 and n["a"]["count"] == 1
    children = sum((s.end_ns - s.start_ns) for s in (spans[0], spans[2]))
    assert n["a"]["self_ms"] == pytest.approx((a.end_ns - a.start_ns - children) / 1e6)
    assert n["a"]["total_ms"] == pytest.approx((a.end_ns - a.start_ns) / 1e6)
    c = spans[1]
    assert n["b"]["self_ms"] == pytest.approx(
        n["b"]["total_ms"] - (c.end_ns - c.start_ns) / 1e6)
    assert n["a"]["device_ms"] == 0.0


def test_nothing_is_recorded_while_off():
    assert not tracing.on()
    assert tracing.span("x") is tracing.span("y")  # one shared object: no allocation
    with tracing.span("x"):
        tracing.count("k", 3)
    snap = tracing.snapshot()
    assert snap == {"names": {}, "counters": {}, "spans": []}


def test_the_ring_is_bounded_and_totals_stay_exact(monkeypatch):
    monkeypatch.setattr(tracing, "RING", 16)
    tracing.reset()
    tracing.enable()
    for i in range(100):
        with tracing.span("s", req=i):
            tracing.count("n")
    snap = tracing.snapshot()
    assert [s.req for s in snap["spans"]] == list(range(84, 100))
    assert snap["names"]["s"]["count"] == 100
    assert snap["counters"] == {"n": 100}
    assert snap["names"]["s"]["total_ms"] >= sum(
        (s.end_ns - s.start_ns) for s in snap["spans"]) / 1e6


def test_missing_profiler_hooks_warn(monkeypatch):
    """Where torch lacks the hooks the tracer follows sessions by, importing
    it warns, so metrics that read nothing have a visible cause."""
    monkeypatch.delattr(tracing._profiler, "_run_on_profiler_start")
    with pytest.warns(RuntimeWarning, match="profiler sessions will not turn tracing on"):
        tracing._follow_the_profiler()


def test_each_profiler_session_starts_a_fresh_record():
    from torch.profiler import ProfilerActivity, profile

    with tracing.span("before"):  # off: not recorded
        pass
    for name in ("first", "second"):
        with profile(activities=[ProfilerActivity.CPU]):
            assert tracing.on()
            with tracing.span(name):
                tracing.count(name)
        assert not tracing.on()
        with tracing.span("after"):  # off again
            pass
        snap = tracing.snapshot()
        assert names_of(snap) == [name] and snap["counters"] == {name: 1}
    tracing.enable()  # an operator's enable() outlives a session
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    assert tracing.on()


def test_a_span_is_a_user_annotation_enclosing_its_ops():
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("probe.outer"):
            (x * 2).sum()
    ann = [e for e in prof.events() if e.name == "probe.outer"]
    assert len(ann) == 1 and ann[0].is_user_annotation
    assert ann[0].device_type == DeviceType.CPU
    ops = [e for e in prof.events() if e.name in ("aten::mul", "aten::sum")]
    assert len(ops) == 2
    for op in ops:
        assert ann[0].time_range.start <= op.time_range.start
        assert op.time_range.end <= ann[0].time_range.end


# ---------------------------------------------------------------------------
# the engine, the model API and the blocked attention
# ---------------------------------------------------------------------------


def test_engine_tokens_are_the_same_with_tracing_on_and_off(params):
    off, on = serve(params, False), serve(params, True)
    assert [r.generated for r in on.finished] == [r.generated for r in off.finished]
    assert on.memory_report() == off.memory_report()
    assert on.latency_report() == off.latency_report()


def test_engine_spans_and_counters(params):
    eng = serve(params, True)
    snap = tracing.snapshot()
    n, c, spans = snap["names"], snap["counters"], snap["spans"]
    assert n["serve.step"]["count"] == eng.steps
    assert n["serve.admit"]["count"] == eng.steps
    prefills = [s for s in spans if s.name == "serve.prefill"]
    assert c["serve.admitted"] == len(prefills) == 7
    assert sorted(s.req for s in prefills) == list(range(7))
    assert c["serve.prefill_tokens"] == sum(9 + 7 * i for i in range(7))
    decoded = sum(len(r.generated) - 1 for r in eng.finished)
    assert c["serve.decoded_rows"] == decoded
    assert n["serve.decode"]["count"] == n["model.decode"]["count"] == n["serve.sample"]["count"]
    assert n["model.prefill"]["count"] == 7
    index = {s.index: s for s in spans}
    for s in spans:
        if s.name == "model.prefill":
            assert index[s.parent].name == "serve.prefill"
        if s.name == "model.decode":
            assert index[s.parent].name == "serve.decode"
        if s.name in ("serve.prefill", "kv.add"):
            assert index[s.parent].name == "serve.admit"
        if s.name in ("serve.admit", "serve.decode", "serve.sample", "kv.append", "kv.free"):
            assert index[s.parent].name == "serve.step"
    # the KV lake's spans carry the sequence id, the request's
    for name in ("kv.add", "kv.free"):
        assert sorted(s.req for s in spans if s.name == name) == list(range(7))
    appends = [s.req for s in spans if s.name == "kv.append"]
    assert len(appends) == decoded
    assert {r: appends.count(r) for r in set(appends)} == {
        r.req_id: len(r.generated) - 1 for r in eng.finished if len(r.generated) > 1}
    assert {s.name for s in spans} == {
        "serve.step", "serve.admit", "serve.prefill", "model.prefill", "serve.decode",
        "model.decode", "serve.sample", "kv.add", "kv.append", "kv.free"}


@pytest.mark.parametrize("length", [96, 97])
def test_forward_tiles_follow_the_block_layout(length):
    """One count a (q block, kv block) tile the forward runs: a prime length
    runs one-token kv tiles."""
    q = torch.randn(1, length, 2, 8)
    tracing.enable()
    L.flash_attention(q, q, q, causal=True, kv_block=32)
    n_q, q_block, kvb, n_kv = L._block_layout(length, length, 32)
    want = sum(len(L._kv_range(i, q_block, kvb, n_kv, True, None, None, 0))
               for i in range(n_q))
    assert tracing.snapshot()["counters"]["attn.fwd_tiles"] == want
    assert (kvb, want) == ((32, 6) if length == 96 else (1, 97))


def test_stitch_counters_sum_to_the_allocators_change():
    kv = StitchedKVCache(KVCacheConfig(n_layers=2, n_kv=4, head_dim=64, dtype=torch.bfloat16,
                                       n_chunks=96, device="cpu"))
    ct = kv.config.chunk_tokens
    kv.add_sequence(99, 10)  # before tracing: not counted
    before = dict(kv.arena.allocator.state_counts)
    tracing.enable()
    for sid in range(6):
        kv.add_sequence(sid, 50 + 900 * sid)
    kv.free_sequence(1)
    kv.append_tokens(0, 2 * ct)
    kv.free_sequence(3)
    kv.add_sequence(6, 3 * ct + 5)
    kv.append_tokens(5, ct)
    after = kv.arena.allocator.state_counts
    counters = tracing.snapshot()["counters"]
    change = {f"kv.{k}": after[k] - before[k] for k in after if after[k] != before[k]}
    assert change and counters == change
    spans = tracing.snapshot()["spans"]
    assert [(s.name, s.req) for s in spans] == (
        [("kv.add", i) for i in range(6)] + [("kv.free", 1), ("kv.append", 0), ("kv.free", 3),
                                            ("kv.add", 6), ("kv.append", 5)])


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def train(traced: bool, steps=3):
    adamw = opt.AdamWConfig(lr=1e-3)
    state = init_state(SMOKE, adamw, torch.Generator().manual_seed(0), "cpu")
    data = SyntheticTokens(DataConfig(vocab=SMOKE.vocab, seq_len=32, global_batch=4), "cpu")
    step = GraphedStep(make_train_step(SMOKE, adamw), "cpu")
    losses = []
    if traced:
        tracing.enable()
    try:
        for i in range(steps):
            state, met = step(state, data.batch_at(i))
            losses.append(met["loss"])
    finally:
        tracing.disable()
    return losses, state


def test_train_losses_and_params_are_the_same_with_tracing_on_and_off():
    (l0, s0), (l1, s1) = train(False), train(True)
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(leaves(s0), leaves(s1)))
    n = tracing.snapshot()["names"]
    assert {k: v["count"] for k, v in n.items() if k.startswith("train.")} == {
        "train.forward": 3, "train.backward": 3, "train.optimizer": 3}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def card_step():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    adamw = opt.AdamWConfig(lr=1e-3)
    state = init_state(SMOKE, adamw, torch.Generator().manual_seed(0), dev)
    data = SyntheticTokens(DataConfig(vocab=SMOKE.vocab, seq_len=256, global_batch=16), dev)
    batches = [data.batch_at(i) for i in range(4)]
    return GraphedStep(make_train_step(SMOKE, adamw), dev), state, batches


@pytest.mark.card
def test_a_replays_phase_times_cover_it(monkeypatch):
    """Warm-up, capture and three replays, traced: the phases read from the
    graph's own events sum to within 2 % of the replays' device time, timed
    by events recorded outside the graph around each ``replay()``."""
    step, state, batches = card_step()
    state, _ = step(state, batches[0])  # warm-up, eager: host spans only
    outer = []
    real = torch.cuda.CUDAGraph.replay

    def timed_replay(graph):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        real(graph)
        b.record()
        outer.append((a, b))

    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", timed_replay)
    tracing.reset()
    tracing.enable()
    for b in batches[1:]:
        state, _ = step(state, b)
    tracing.disable()
    n = tracing.snapshot()["names"]
    torch.cuda.synchronize()
    replays = n["graph.replay"]["count"]
    assert replays == len(outer) == 3
    phases = [n[f"train.{p}"]["device_ms"] for p in ("forward", "backward", "optimizer")]
    assert all(p > 0 for p in phases)
    replayed = sum(a.elapsed_time(b) for a, b in outer)
    assert sum(phases) <= replayed
    assert sum(phases) == pytest.approx(replayed, rel=0.02)
    # the capture's body ran once on the host, as spans; replays run no Python
    assert n["train.forward"]["count"] == 1 + replays


@pytest.mark.card
def test_an_untraced_replay_adds_no_wait(monkeypatch):
    step, state, batches = card_step()
    for b in batches[:2]:  # warm-up, capture and replay
        state, _ = step(state, b)
    waits = []
    real = torch.cuda.Event.synchronize
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        lambda self: (waits.append(self), real(self))[1])
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in batches[2:]:
            state, _ = step(state, b)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    assert waits == [] and tracing.snapshot()["names"] == {}
