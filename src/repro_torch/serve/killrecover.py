"""Kill/recover serving scenario: capacity loss -> checkpoint restore.

Counterpart of ``repro.serve.killrecover``, with the same configuration,
fault table and summary. A ``ServeEngine`` drives a fixed-seed
continuous-batching workload over a fault-injected device. Mid-trace the
schedule fires a capacity shrink (simulated device loss / neighbor-tenant
pressure) together with a transient ``cuMemCreate`` failure burst sized
past the backend's recovery-ladder attempt budget, so the allocator's
staged recovery is exhausted and ``AllocatorOOM`` escapes the engine step.
The ``Supervisor`` catches it (``AllocatorOOM`` is a ``MemoryError``),
restores the last committed engine checkpoint onto the engine's device,
and ``load_state`` rebuilds the KV arena — freeing every stitched sequence
and re-admitting the running set tight against whatever capacity the
shrunken device still has. Replayed steps drain the remaining burst
through the ladder's bounded retries until allocation succeeds and the
workload finishes.

The model runs on the card unless the caller passes ``device="cpu"``; the
allocator, device model and fault schedule are host-side and identical on
either, so the allocation trace does not depend on where the model runs.
Shared by ``examples/kill_recover_serving_torch.py``, the chaos campaign's
engine legs and ``chip_smoke.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..alloc import registry
from ..alloc.chunks import CHUNK_SIZE, MB, FaultInjector, FaultSchedule, VMMDevice
from ..ckpt.checkpoint import CheckpointManager
from ..device import DeviceLike, resolve_device
from ..ft.supervisor import SupervisorConfig
from .engine import EngineConfig, ServeEngine


@dataclass(frozen=True)
class KillRecoverConfig:
    backend: str = "gmlake"
    arch: str = "smollm-135m"
    requests: int = 6
    max_new: int = 24
    seed: int = 0
    n_chunks: int = 56  # 112 MB device
    max_batch: int = 3
    #: KV accounting geometry: 8 KV heads x 4096 head dim (bf16) = 64 KB
    #: per token -> 32 tokens per 2 MB chunk, so sequences cross chunk
    #: boundaries mid-decode and the arena allocates throughout the trace
    #: (the smoke model still does the numerics on its own shapes)
    kv_n_kv: int = 8
    kv_head_dim: int = 4096
    #: capacity lost at the fault point (must leave room for the
    #: tight-packed working set or recovery degenerates to a crash loop)
    shrink_mb: int = 16
    #: alloc-side device call (1-based) at which the shrink fires and the
    #: failure burst is armed; calibrated mid-trace for the default shape
    #: (the admission ramp issues 18 creates; growth creates follow from
    #: ~step 9 as sequences cross the 32-token chunk boundary)
    fault_call: int = 25
    #: consecutive transient cuMemCreate failures — sized past one ladder
    #: run so the first hit escapes as AllocatorOOM and forces a restore
    fail_burst: int = 20
    checkpoint_every: int = 4
    max_restarts: int = 8
    max_steps: int = 200

    @classmethod
    def for_backend(cls, backend: str, **overrides) -> "KillRecoverConfig":
        """Backend-calibrated fault point for the default workload shape.

        The fault is indexed in device alloc-side calls, and backends hit
        the device at different granularities: gmlake creates one pBlock
        per 2 MB KV grow (ramp = 18 creates, growth creates follow), while
        caching reserves whole 20 MB segments (ramp = 2 reservations, the
        3rd/4th land mid-trace). ellm and hybrid sit on gmlake-style 2 MB
        chunking, so they share its fault point. All defaults put the
        fault on a growth allocation around decode step 15, after several
        checkpoints.
        """
        tuned = {
            "gmlake": dict(fault_call=25),
            "caching": dict(fault_call=4),
            "ellm": dict(fault_call=25),
            "hybrid": dict(fault_call=25),
        }
        kw = dict(tuned.get(backend, {}), backend=backend, **overrides)
        return cls(**kw)


def build_schedule(cfg: KillRecoverConfig) -> FaultSchedule:
    return FaultSchedule(
        seed=cfg.seed,
        shrink_at_call=cfg.fault_call,
        shrink_bytes=cfg.shrink_mb * MB,
        fail_at_call=cfg.fault_call,
        fail_burst=cfg.fail_burst,
    )


def build_engine(cfg: KillRecoverConfig, schedule: Optional[FaultSchedule] = None,
                 device: DeviceLike = "cuda", params: Optional[Dict] = None) -> ServeEngine:
    """Fixed-seed engine whose KV arena runs over a fault-injected device.

    ``schedule=None`` builds the fault-free twin (same seed, plain
    injector with an empty schedule) used for the A/B bit-identity check.
    The model is the arch's smoke config, as in the reference; its weights
    are ``params`` when given (a test passes the JAX init converted by
    ``models.transformer.params_from_jax_numpy``), else ``init_params``
    from a generator seeded with ``cfg.seed``.
    """
    from ..configs import get_arch
    from ..models.api import family_of

    device = resolve_device(device)
    model_cfg = get_arch(cfg.arch).smoke
    fam = family_of(model_cfg)
    if params is None:
        params = fam.init_params(model_cfg, torch.Generator().manual_seed(cfg.seed), device)
    vmm = VMMDevice(cfg.n_chunks * CHUNK_SIZE)
    injector = FaultInjector(vmm, schedule if schedule is not None else FaultSchedule())
    allocator = registry.create(cfg.backend, injector)
    eng = ServeEngine(
        model_cfg, params,
        EngineConfig(max_batch=cfg.max_batch, max_len=128,
                     n_chunks=cfg.n_chunks, allocator=allocator,
                     kv_n_kv=cfg.kv_n_kv, kv_head_dim=cfg.kv_head_dim,
                     device=device),
    )
    rng = np.random.default_rng(cfg.seed)
    for _ in range(cfg.requests):
        plen = int(rng.integers(8, 24))
        eng.submit(rng.integers(0, model_cfg.vocab, size=plen),
                   max_new=cfg.max_new)
    return eng


def supervisor_config(cfg: KillRecoverConfig) -> SupervisorConfig:
    return SupervisorConfig(
        checkpoint_every=cfg.checkpoint_every,
        max_restarts=cfg.max_restarts,
        restart_reset_after=2 * cfg.checkpoint_every,
    )


def summarize(eng: ServeEngine, sup, requests: int) -> Dict[str, Any]:
    """The scenario's audit summary of an engine driven by ``sup``."""
    return {
        "engine": eng,
        "supervisor": sup,
        "finished": len(eng.finished),
        "requests": requests,
        "drained": not eng.waiting and not eng.running,
        "restarts": sum(1 for e in sup.events if e["kind"] == "restart"),
        "events": sup.events,
        "memory_report": eng.memory_report(),
    }


def run_scenario(cfg: KillRecoverConfig, ckpt_dir: str,
                 device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Run the kill/recover scenario; returns the audit summary.

    The returned dict carries everything the tests and the chip check
    assert on: how many requests finished, the supervisor's restart/reset
    events, the allocator's recovery-event summary, and the injected
    fault counters. The engine's ``recorder.trace`` (with restore marks)
    is under ``"engine"``.
    """
    eng = build_engine(cfg, build_schedule(cfg), device=device)
    ckpt = CheckpointManager(ckpt_dir, keep=3)
    sup = eng.run_supervised(ckpt, max_steps=cfg.max_steps, config=supervisor_config(cfg))
    return summarize(eng, sup, cfg.requests)
