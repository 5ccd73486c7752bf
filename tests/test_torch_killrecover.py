"""Port parity: supervised serving under faults (kill/recover) against the
JAX package.

For every backend with a calibrated fault point, the port's
``run_scenario`` on the CPU must finish the same requests with the same
restarts (step and error), the same ``memory_report`` and the same
allocation trace as the JAX package's; the ``gmlake`` trace must equal the
checked-in recording. With weights converted from the JAX init, the
faulted run must generate the JAX run's tokens, and those of its
fault-free twin. The JAX runs take about 25 s each (prefill compiles per
prompt length), so each runs once per module.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.trace import load_trace
from repro.models import transformer as JT
from repro.serve.killrecover import KillRecoverConfig as JKillRecoverConfig
from repro.serve.killrecover import run_scenario as jrun_scenario
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.models import transformer as T
from repro_torch.serve import killrecover as K
from repro_torch.serve.killrecover import KillRecoverConfig, build_engine, run_scenario

DATA = Path(__file__).parent / "data"
BACKENDS = ["gmlake", "caching", "ellm", "hybrid"]


def events(trace):
    return [(e.op, e.tid, e.size, e.label, e.tenant, e.slo) for e in trace.events]


def restarts(out):
    return [(e["step"], e["error"]) for e in out["events"] if e["kind"] == "restart"]


def budget_resets(out):
    return [e for e in out["events"] if e["kind"] == "budget_reset"]


def tokens(eng):
    return {r.req_id: list(r.generated) for r in eng.finished}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_kr")
    return {b: jrun_scenario(JKillRecoverConfig.for_backend(b), str(root / b))
            for b in BACKENDS}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_kr")
    return {b: run_scenario(KillRecoverConfig.for_backend(b), str(root / b), device="cpu")
            for b in BACKENDS}


def test_config_and_fault_table_match_reference():
    for b in BACKENDS + ["native", "stalloc"]:
        assert vars(KillRecoverConfig.for_backend(b)) == vars(JKillRecoverConfig.for_backend(b))


@pytest.mark.parametrize("backend", BACKENDS)
def test_scenario_matches_jax(backend, jax_runs, port_runs):
    ref, out = jax_runs[backend], port_runs[backend]
    assert out["drained"] and ref["drained"]
    assert out["finished"] == ref["finished"] == out["requests"] == 6
    assert restarts(out) == restarts(ref)
    assert out["restarts"] == ref["restarts"] >= 1
    assert all(err.startswith("AllocatorOOM(") for _, err in restarts(out))
    assert budget_resets(out) == budget_resets(ref)
    assert out["memory_report"] == ref["memory_report"]
    assert events(out["engine"].recorder.trace) == events(ref["engine"].recorder.trace)


@pytest.mark.parametrize("backend,steps,peak,n_events", [
    ("gmlake", [14], 75497472, 181), ("caching", [43, 43], 83886080, 254),
    ("ellm", [14], 75497472, 181), ("hybrid", [14], 75497472, 181)])
def test_scenario_figures(backend, steps, peak, n_events, port_runs):
    """The figures the reference gives today, pinned so a drift of both
    packages together shows too."""
    out = port_runs[backend]
    rep = out["memory_report"]
    assert [s for s, _ in restarts(out)] == steps
    assert rep["peak_reserved"] == peak and rep["n_trace_events"] == n_events
    assert rep["injected_faults"] == {"shrink": 1, "burst_armed": 1, "create_fault": 20}
    assert rep["recovery_events"]["counts"].get("recovered", 0) >= 1
    marks = [e.label for e in out["engine"].recorder.trace.events if e.op == "mark"]
    assert any(m.startswith("engine.restore@") for m in marks)


def test_gmlake_trace_equals_checked_in_recording(port_runs):
    ref = load_trace(DATA / "serve_engine_killrecover.trace.json")
    assert ref.meta["restarts"] == port_runs["gmlake"]["restarts"]
    assert events(port_runs["gmlake"]["engine"].recorder.trace) == events(ref)


@pytest.fixture(scope="module")
def jax_weights():
    jparams = JT.init_params(jget_arch("smollm-135m").smoke, jax.random.PRNGKey(0))
    return T.params_from_jax_numpy(get_arch("smollm-135m").smoke,
                                   jax.tree.map(np.asarray, jparams), device="cpu")


def test_tokens_match_jax_and_fault_free_twin(jax_runs, jax_weights, tmp_path):
    """With the JAX init's weights, the faulted run restores through a
    checkpoint and still generates exactly the JAX run's tokens, and those
    of the same engine run with no faults."""
    cfg = KillRecoverConfig.for_backend("gmlake")
    eng = build_engine(cfg, K.build_schedule(cfg), device="cpu", params=jax_weights)
    sup = eng.run_supervised(CheckpointManager(tmp_path, keep=3), max_steps=cfg.max_steps,
                             config=K.supervisor_config(cfg))
    out = K.summarize(eng, sup, cfg.requests)
    ref = jax_runs["gmlake"]
    assert restarts(out) == restarts(ref) and out["finished"] == 6
    assert tokens(eng) == tokens(ref["engine"])
    twin = build_engine(cfg, None, device="cpu", params=jax_weights)
    twin.run_to_completion()
    assert tokens(twin) == tokens(eng)
    assert all(len(t) == cfg.max_new for t in tokens(eng).values())


def test_faulted_run_equals_fault_free_twin_with_seeded_weights(port_runs):
    cfg = KillRecoverConfig.for_backend("caching")
    twin = build_engine(cfg, None, device="cpu")
    twin.run_to_completion()
    assert tokens(twin) == tokens(port_runs["caching"]["engine"])


def test_run_supervised_defaults_and_first_save(tmp_path):
    """The reference's default supervisor (checkpoint every 4 steps), a
    synchronous save of step 0 before any step, and a commit at the end of
    every chunk."""

    class Spy(CheckpointManager):
        def __init__(self, directory):
            super().__init__(directory)
            self.saves = []

        def save(self, step, tree):
            self.saves.append(("save", step))
            return super().save(step, tree)

        def save_async(self, step, tree):
            self.saves.append(("async", step))
            super().save_async(step, tree)

    eng = build_engine(KillRecoverConfig(requests=2, max_new=6, max_batch=2), None,
                       device="cpu")
    spy = Spy(tmp_path)
    sup = eng.run_supervised(spy)
    assert sup.config.checkpoint_every == 4 and sup.config.max_restarts == 8
    assert sup.config.restart_reset_after == 8
    assert spy.saves == [("save", 0), ("async", 4), ("save", 4), ("async", 8), ("save", 8)]
    assert len(eng.finished) == 2 and not eng.running


def test_engine_dump_load_roundtrip_is_lossless(tmp_path):
    """dump_state -> CheckpointManager -> load_state on a *dirty* engine
    reproduces the exact generation state and KV accounting."""
    cfg = KillRecoverConfig(requests=3, max_new=8)
    eng = build_engine(cfg, None, device="cpu")
    for _ in range(5):
        eng.step()
    state = eng.dump_state()
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(eng.steps, state)
    gen_before = {r.req_id: list(r.generated) for r in eng.running.values()}
    kv_before = {s: (st.length, st.capacity_tokens) for s, st in eng.kv.seqs.items()}
    active_before = eng.kv.arena.allocator.stats.active_bytes
    for _ in range(3):
        eng.step()
    restored = ckpt.restore(eng.dump_state(), step=5)
    assert isinstance(restored["phase"], torch.Tensor)  # restores hand back tensors
    eng.load_state(restored)
    assert eng.steps == 5
    assert {r.req_id: list(r.generated) for r in eng.running.values()} == gen_before
    assert {s: (st.length, st.capacity_tokens) for s, st in eng.kv.seqs.items()} == kv_before
    assert eng.kv.arena.allocator.stats.active_bytes == active_before
    eng.step()
    eng2 = build_engine(cfg, None, device="cpu")
    for _ in range(6):
        eng2.step()
    assert {r.req_id: list(r.generated) for r in eng.running.values()} == \
        {r.req_id: list(r.generated) for r in eng2.running.values()}


def test_restore_resets_allocator_event_counters(port_runs):
    """``memory_report`` counters describe the engine's current life:
    device-lifetime fault counts survive a restore, the allocator's event
    log does not."""
    out = port_runs["gmlake"]
    rep = out["memory_report"]
    counts = rep["recovery_events"]["counts"]
    assert counts.get("recovered", 0) >= 1 and counts.get("unrecovered", 0) == 0
    assert rep["injected_faults"]["shrink"] == 1
    assert rep["injected_faults"]["burst_armed"] == 1
    eng = build_engine(KillRecoverConfig.for_backend("gmlake"), None, device="cpu")
    for _ in range(3):
        eng.step()
    log = eng.kv.arena.allocator.event_log
    state = eng.dump_state()
    log.append("test_sentinel")
    eng.load_state(state)  # same step, clean -> no-op, log untouched
    assert log.counts.get("test_sentinel") == 1
    eng.step()
    eng.load_state(state)  # step moved on -> full rebuild -> fresh life
    assert "test_sentinel" not in log.counts
    assert log.counts.get("unrecovered", 0) == 0


def test_run_to_completion_returns_finished_requests():
    cfg = KillRecoverConfig(requests=3, max_new=6, max_batch=2)
    eng = build_engine(cfg, None, device="cpu")
    done = eng.run_to_completion(max_steps=100)
    assert len(done) == 3 and all(r.done for r in done)
    assert {r.req_id for r in done} == {0, 1, 2}
    assert all(len(r.generated) == 6 for r in done)
    assert eng.run_to_completion(max_steps=10) == []



def test_example_runs_on_cpu_and_refuses_checked_in_data(tmp_path, capsys):
    import importlib.util

    path = Path(__file__).resolve().parent.parent / "examples" / "kill_recover_serving_torch.py"
    spec = importlib.util.spec_from_file_location("kill_recover_serving_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with pytest.raises(SystemExit):
        example.main(["--device", "cpu", "--out", str(DATA / "x.trace.json")])
    assert not (DATA / "x.trace.json").exists()
    out = example.main(["--device", "cpu", "--out", str(tmp_path / "kr.trace.json")])
    assert out["device"] == "cpu" and out["finished"] == 6 and out["trace_events"] == 181
    assert [s for s, _ in out["restarts"]] == [14]
    ref = load_trace(DATA / "serve_engine_killrecover.trace.json")
    assert events(load_trace(tmp_path / "kr.trace.json")) == events(ref)
