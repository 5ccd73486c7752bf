"""Port parity: the serving engine and its launcher against the JAX package.

The port's engine re-runs both scenarios of examples/record_engine_trace.py
and must reproduce the checked-in recordings event for event (requests
retire on ``max_new`` only, so the allocation stream does not depend on
model numerics). With weights converted from the JAX init, it must also
generate the JAX engine's tokens and report the same memory and latency
figures."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.trace import load_trace
from repro.models import transformer as JT
from repro.serve.engine import EngineConfig as JEngineConfig, ServeEngine as JServeEngine
from repro.serve.loadgen import LoadGenConfig, generate
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.launch import serve, train
from repro_torch.models import transformer as T
from repro_torch.serve.engine import EngineConfig, ServeEngine
from repro_torch.serve.killrecover import KillRecoverConfig, build_engine, run_scenario
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import init_state

DATA = Path(__file__).parent / "data"


def events(trace):
    return [(e.op, e.tid, e.size, e.label, e.tenant, e.slo) for e in trace.events]


def drain(eng, start_steps=0):
    steps = start_steps
    while eng.waiting or eng.running:
        eng.step()
        steps += 1
        assert steps < 10_000
    return steps


@pytest.fixture(scope="module")
def smoke():
    cfg = get_arch("smollm-135m").smoke
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params


def test_default_scenario_reproduces_checked_in_trace(smoke):
    """examples/record_engine_trace.py's ``default`` scenario."""
    cfg, params = smoke
    ref = load_trace(DATA / "serve_engine_smollm.trace.json")
    rng = np.random.default_rng(ref.meta["seed"])
    eng = ServeEngine(cfg, params, EngineConfig(max_batch=8, n_chunks=512, device="cpu"))
    for _ in range(ref.meta["requests"]):
        plen = int(rng.integers(8, 64))
        eng.submit(rng.integers(0, cfg.vocab, size=plen), max_new=ref.meta["max_new"])
    assert drain(eng) == ref.meta["decode_steps"]
    assert events(eng.recorder.trace) == events(ref)


def test_multitenant_scenario_reproduces_checked_in_trace(smoke):
    """examples/record_engine_trace.py's ``multitenant`` scenario, with the
    schedule built from the reference's load generator."""
    cfg, params = smoke
    ref = load_trace(DATA / "serve_engine_multitenant.trace.json")
    seed = ref.meta["seed"]
    rng = np.random.default_rng(seed)
    eng = ServeEngine(cfg, params, EngineConfig(max_batch=6, max_len=1024, n_chunks=1024,
                                                kv_n_kv=64, kv_head_dim=512, device="cpu"))
    load = LoadGenConfig(seed=seed, duration_steps=48, n_tenants=4,
                         base_arrivals_per_step=1.0, bursts=((16, 3.0, 4),))
    by_step = {}
    for spec in generate(load):
        by_step.setdefault(spec.step, []).append(spec)
    for step in range(load.duration_steps):
        for spec in by_step.get(step, ()):
            plen = min(480, max(8, spec.prompt_tokens // 3))
            max_new = min(40, max(3, spec.decode_tokens // 8))
            eng.submit(rng.integers(0, cfg.vocab, size=plen),
                       max_new=max_new, tenant=spec.tenant, slo=spec.slo)
        eng.step()
    assert drain(eng, load.duration_steps) == ref.meta["decode_steps"]
    assert events(eng.recorder.trace) == events(ref)


@pytest.fixture(scope="module")
def twin_engines():
    """JAX and port engines on the same converted weights and submissions,
    run to completion; requests carry SLO classes so admission reorders.
    Prompts share one length so the JAX engine compiles its prefill once."""
    jcfg = jget_arch("smollm-135m").smoke
    cfg = get_arch("smollm-135m").smoke
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = T.params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    engines = (JServeEngine(jcfg, jparams, JEngineConfig(max_batch=3, max_len=128,
                                                         n_chunks=64)),
               ServeEngine(cfg, params, EngineConfig(max_batch=3, max_len=128, n_chunks=64,
                                                     device="cpu")))
    for eng in engines:
        rng = np.random.default_rng(7)
        for i, slo in enumerate(["batch", "interactive", "", "standard", "interactive"]):
            eng.submit(rng.integers(0, cfg.vocab, size=12),
                       max_new=2 + i % 3, tenant=f"t{i % 2}", slo=slo)
        eng.step()
        eng.submit(rng.integers(0, cfg.vocab, size=12), max_new=2, slo="interactive")
        drain(eng)
    return engines


def test_reports_match_jax_engine(twin_engines):
    jeng, eng = twin_engines
    assert eng.memory_report() == jeng.memory_report()
    assert eng.latency_report() == jeng.latency_report()
    assert events(eng.recorder.trace) == events(jeng.recorder.trace)


def test_generated_tokens_match_jax_engine(twin_engines):
    jeng, eng = twin_engines
    assert [r.req_id for r in eng.finished] == [r.req_id for r in jeng.finished]
    assert [r.generated for r in eng.finished] == [r.generated for r in jeng.finished]


def test_dump_load_state_roundtrip(smoke):
    """A fresh engine restored mid-run finishes with the same tokens as the
    engine it was dumped from, and the dump has the reference's layout."""
    cfg, params = smoke

    def make():
        eng = ServeEngine(cfg, params, EngineConfig(max_batch=2, max_len=64, n_chunks=32,
                                                    device="cpu"))
        rng = np.random.default_rng(3)
        for _ in range(4):
            eng.submit(rng.integers(0, cfg.vocab, size=int(rng.integers(4, 12))), max_new=6)
        return eng

    a = make()
    for _ in range(4):
        a.step()
    state = a.dump_state()
    active_at_dump = a.memory_report()["active_bytes"]
    assert sorted(state) == ["cache", "gen_len", "gen_tok", "max_new", "phase", "prompt_len",
                             "prompt_tok", "slot", "step"]
    assert state["cache"]["k"].shape == (cfg.n_layers, 2, 64, cfg.n_kv, cfg.dh)
    k_at_dump = state["cache"]["k"].clone()
    a.step()
    assert torch.equal(state["cache"]["k"], k_at_dump)  # the dump is a copy
    b = make()
    b.load_state(state)
    assert b.steps == 4
    assert sorted(b.running) == [i for i, ph in enumerate(state["phase"]) if ph == 1]
    assert b.memory_report()["active_bytes"] == active_at_dump
    assert b.recorder.trace.events[-1].label == "engine.restore@4"
    drain(a)
    drain(b)
    assert {r.req_id: r.generated for r in a.finished} == \
        {r.req_id: r.generated for r in b.finished}


def test_launcher_smoke_on_cpu():
    out = serve.main(["--smoke", "--device", "cpu", "--requests", "5", "--max-new", "4"])
    assert out["finished"] == 5 and out["device"] == "cpu"
    assert out["arena"]["allocator"] == "gmlake" and out["arena"]["active_bytes"] == 0
    assert set(out["trace_replay"]) == {"caching", "gmlake"}


def test_entry_points_default_to_cuda(tmp_path):
    """Without a card, the CUDA default raises instead of falling back."""
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke", "--requests", "1"])
    cfg = get_arch("smollm-135m").smoke
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(cfg, AdamWConfig(), torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "smollm-135m", "--smoke", "--steps", "1"])
    kr = KillRecoverConfig(requests=1, max_new=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine(kr)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_scenario(kr, str(tmp_path))
