"""Port parity: the port keeps its own copy of the allocator, load-generator,
simulator and chaos modules, and this file is what keeps the copy from
drifting. The checked-in engine traces
and fixed-seed training traces replay through ``repro_torch.alloc`` and
``repro.alloc`` with identical state counts, peaks and OOM points."""

from pathlib import Path

import pytest

from repro.alloc import registry as jregistry
from repro.core import trace as jtrace
from repro_torch.alloc import GB, registry
from repro_torch.core import trace as ttrace

ROOT = Path(__file__).resolve().parent.parent
DATA = Path(__file__).parent / "data"
COPIED = ["alloc/chunks.py", "alloc/metrics.py", "alloc/protocol.py", "alloc/recovery.py",
          "alloc/registry.py", "alloc/caching_allocator.py", "alloc/gmlake.py",
          "alloc/stalloc.py", "alloc/ellm.py", "alloc/hybrid.py", "core/trace.py",
          "serve/loadgen.py", "serve/simulate.py", "chaos/__init__.py", "chaos/sentinel.py",
          "chaos/scenarios.py", "chaos/campaign.py"]
BACKENDS = ["caching", "native", "gmlake", "stalloc", "ellm", "hybrid"]
#: (checked-in trace, capacity GB), as tests/test_golden_equivalence.py replays them
ENGINE_TRACES = [("serve_engine_smollm", 2), ("serve_engine_multitenant", 2),
                 ("serve_engine_killrecover", 1)]


def _digest(res):
    return dict(
        state_counts=res.state_counts,
        peak_active=res.stats.peak_active,
        peak_reserved=res.stats.peak_reserved,
        oom=res.oom,
        oom_at_event=res.oom_at_event,
        n_alloc=res.stats.n_alloc,
        n_free=res.stats.n_free,
        model_cost=res.model_cost,
    )


@pytest.mark.parametrize("path", COPIED)
def test_copy_is_verbatim(path):
    assert (ROOT / "src/repro_torch" / path).read_bytes() == (ROOT / "src/repro" / path).read_bytes()


def test_port_registers_the_serving_backends():
    assert registry.names() == BACKENDS == jregistry.names()


def test_port_exports_the_reference_names():
    import repro.alloc
    import repro_torch.alloc

    assert repro_torch.alloc.__all__ == repro.alloc.__all__


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name,cap_gb", ENGINE_TRACES)
def test_engine_trace_replay_matches_reference(name, cap_gb, backend):
    path = DATA / f"{name}.trace.json"
    port, _ = ttrace.replay(ttrace.load_trace(path), backend, capacity_bytes=cap_gb * GB)
    ref, _ = jtrace.replay(jtrace.load_trace(path), backend, capacity_bytes=cap_gb * GB)
    assert _digest(port) == _digest(ref)


@pytest.mark.parametrize("backend", ["caching", "gmlake"])
@pytest.mark.parametrize("cap_gb", [80, 8, 2])  # at 2 GB both run out of memory mid-trace
def test_training_trace_replay_matches_reference(backend, cap_gb):
    def make(mod):
        return mod.training_trace(mod.PAPER_MODELS["opt-1.3b"], "LR", world=4, batch=8,
                                  seq=2048, iters=4, seed=0)

    port_trace, ref_trace = make(ttrace), make(jtrace)
    assert [tuple(vars(e).values()) for e in port_trace.events] == \
        [tuple(vars(e).values()) for e in ref_trace.events]
    port = ttrace.run_workload(port_trace, backend, capacity_bytes=cap_gb * GB)
    ref = jtrace.run_workload(ref_trace, backend, capacity_bytes=cap_gb * GB)
    assert _digest(port) == _digest(ref)
    assert port.oom == (cap_gb == 2)
