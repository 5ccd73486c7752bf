"""Record a fixed-seed ServeEngine run of the PyTorch port as a replayable trace.

Counterpart of ``record_engine_trace.py``: it runs the port's
continuous-batching ``ServeEngine`` over the stitched KV arena with a pinned
seed and saves the ``TraceRecorder`` output in the columnar
``repro.trace.v1`` JSON format that ``load_trace`` replays. Runs on the card
unless ``--device cpu``:

    PYTHONPATH=src python examples/record_engine_trace_torch.py \
        [--scenario default|multitenant] [--device cuda|cpu] [--out some/trace.json]

The weights are random, drawn by the family's ``init_params`` from a
generator seeded with ``--seed``, and the trace does not depend on them:
requests retire on ``max_new`` alone, so the allocation stream is a function
of the submissions and the KV geometry. With unchanged defaults the file is
byte-identical to ``tests/data/serve_engine_{smollm,multitenant}.trace.json``
on either device. Those checked-in files are the JAX package's recordings,
which the port is held to, so ``--out`` never writes under ``tests/data/``;
the default output goes under ``artifacts/traces/`` with the same file names.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.api import family_of  # noqa: E402
from repro_torch.serve.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.serve.loadgen import LoadGenConfig, generate  # noqa: E402

PROTECTED = ROOT / "tests" / "data"
OUT_DIR = ROOT / "artifacts" / "traces"
FILE_NAMES = {"default": "serve_engine_smollm.trace.json",
              "multitenant": "serve_engine_multitenant.trace.json"}


def drain(eng: ServeEngine, steps: int) -> int:
    """Step ``eng`` until nothing waits or runs; returns the total steps."""
    while eng.waiting or eng.running:
        eng.step()
        steps += 1
        if steps > 10_000:
            raise RuntimeError("engine did not drain")
    return steps


def record_multitenant(seed: int = 2, device: str = "cuda"):
    """Loadgen-driven multi-tenant run: the trace carries tenant/SLO
    columns and mixes small interactive KV growth (2-4 MB, the stitching
    core's regime) with large batch-class prompt allocations (>=16 MB,
    ellm's elastic-arena regime), so one recorded stream exercises every
    backend's interesting path.

    The KV geometry is widened (kv_n_kv=64, kv_head_dim=512 -> 64 KB per
    token per layer side) so a 256-token batch prompt is an 8-chunk,
    16 MB allocation per (layer, k|v) — loadgen's class mix, scaled to
    the engine's max_len, does the rest.
    """
    cfg = get_arch("smollm-135m").smoke
    rng = np.random.default_rng(seed)
    params = family_of(cfg).init_params(cfg, torch.Generator().manual_seed(seed), device)
    eng = ServeEngine(
        cfg, params,
        EngineConfig(max_batch=6, max_len=1024, n_chunks=1024,
                     kv_n_kv=64, kv_head_dim=512, device=device),
    )
    load = LoadGenConfig(seed=seed, duration_steps=48, n_tenants=4,
                         base_arrivals_per_step=1.0, bursts=((16, 3.0, 4),))
    sched = generate(load)
    by_step = {}
    for spec in sched:
        by_step.setdefault(spec.step, []).append(spec)
    for step in range(load.duration_steps):
        for spec in by_step.get(step, ()):
            plen = min(480, max(8, spec.prompt_tokens // 3))
            max_new = min(40, max(3, spec.decode_tokens // 8))
            eng.submit(rng.integers(0, cfg.vocab, size=plen),
                       max_new=max_new, tenant=spec.tenant, slo=spec.slo)
        eng.step()
    steps = drain(eng, load.duration_steps)
    trace = eng.recorder.trace
    trace.meta.update(
        arch=cfg.name, scenario="multitenant", seed=seed,
        requests=len(sched), decode_steps=steps,
        load=load.describe(),
    )
    return trace


def record(requests: int = 48, max_new: int = 24, seed: int = 0, device: str = "cuda"):
    """``requests`` prompts of 8-63 seeded tokens, each decoding ``max_new``
    tokens, through an 8-slot engine on a 512-chunk arena."""
    cfg = get_arch("smollm-135m").smoke
    rng = np.random.default_rng(seed)
    params = family_of(cfg).init_params(cfg, torch.Generator().manual_seed(seed), device)
    eng = ServeEngine(cfg, params, EngineConfig(max_batch=8, n_chunks=512, device=device))
    for _ in range(requests):
        plen = int(rng.integers(8, 64))
        eng.submit(rng.integers(0, cfg.vocab, size=plen), max_new=max_new)
    steps = drain(eng, 0)
    trace = eng.recorder.trace
    trace.meta.update(
        arch=cfg.name, requests=requests, max_new=max_new, seed=seed,
        decode_steps=steps,
    )
    return trace


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--scenario", choices=tuple(FILE_NAMES), default="default")
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    out = Path(args.out) if args.out is not None else OUT_DIR / FILE_NAMES[args.scenario]
    if out.resolve().is_relative_to(PROTECTED.resolve()):
        ap.error(f"refusing to write under {PROTECTED}: the checked-in traces are the "
                 "reference's recordings")
    if args.scenario == "multitenant":
        trace = record_multitenant(2 if args.seed is None else args.seed, args.device)
    else:
        trace = record(args.requests, args.max_new, 0 if args.seed is None else args.seed,
                       args.device)
    out.parent.mkdir(parents=True, exist_ok=True)
    trace.save(out)
    print(
        f"recorded {len(trace.events)} events "
        f"({trace.n_allocs} allocs, mean {trace.mean_alloc_mb:.1f} MB) -> {out}"
    )
    return trace


if __name__ == "__main__":
    main()
