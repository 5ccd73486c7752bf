"""Serving launcher: continuous batching with the stitched KV arena.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        [--smoke] [--requests 24] [--max-new 16] [--device cuda]

Counterpart of ``repro.launch.serve``. Submits a stream of variable-length
prompts, decodes with continuous batching, and reports throughput and the
arena's memory behaviour (utilization, BestFit state mix) plus a replay
comparison of the recorded trace under the caching vs GMLake allocators.
Serves the decoder-only families (dense, moe, vlm) and refuses the others,
as the reference does; like the reference's engine, it submits text
prompts only, so a vlm model, whose prefill needs patch embeddings, fails
at its first admission. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..alloc import GB
from ..configs import get_arch
from ..core.trace import run_workload
from ..device import resolve_device
from ..models.api import family_of
from ..serve.engine import EngineConfig, ServeEngine


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


#: the families this launcher serves, as the reference's
SERVED_FAMILIES = ("dense", "moe", "vlm")


def build_engine(args: argparse.Namespace) -> ServeEngine:
    """The engine with seeded random weights and every request submitted."""
    device = resolve_device(args.device)
    entry = get_arch(args.arch)
    cfg = entry.smoke if args.smoke else entry.full
    fam = family_of(cfg)
    if fam.name not in SERVED_FAMILIES:
        raise SystemExit(f"the serve launcher supports decoder-only families, got {fam.name}")
    rng = np.random.default_rng(args.seed)
    params = fam.init_params(cfg, torch.Generator().manual_seed(args.seed), device)
    eng = ServeEngine(cfg, params, EngineConfig(max_batch=args.max_batch, device=device))
    for _ in range(args.requests):
        plen = int(rng.integers(8, 64))
        eng.submit(rng.integers(0, cfg.vocab, size=plen), max_new=args.max_new)
    return eng


def _sync(eng: ServeEngine) -> None:
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)


def run(eng: ServeEngine, args: argparse.Namespace) -> dict:
    """Drain ``eng`` and return the report: throughput, the arena's memory
    behaviour and the replay of its allocation trace."""
    t0 = time.time()
    steps = 0
    while eng.waiting or eng.running:
        eng.step()
        steps += 1
        if steps > 10_000:
            raise RuntimeError("engine did not drain")
    _sync(eng)
    wall = time.time() - t0

    report = eng.memory_report()
    # replay the engine's real allocation trace through both allocators
    replay = {}
    for name in ("caching", "gmlake"):
        r = run_workload(eng.recorder.trace, name, capacity_bytes=1 * GB)
        replay[name] = {
            "utilization": round(r.utilization, 4),
            "peak_reserved_mb": round(r.stats.peak_reserved / 2**20, 1),
            "oom": r.oom,
        }
    return {
        "arch": eng.cfg.name,
        "device": str(eng.device),
        "requests": args.requests,
        "finished": len(eng.finished),
        "decode_steps": steps,
        "tokens_per_s": round(args.requests * args.max_new / wall, 1),
        "arena": {k: (round(v, 4) if isinstance(v, float) else v)
                  for k, v in report.items()},
        "trace_replay": replay,
    }


def main(argv=None) -> dict:
    """Build, serve, print and return the report, with the engine's build
    time (weights included) as ``init_s``."""
    args = parse_args(argv)
    t0 = time.time()
    eng = build_engine(args)
    _sync(eng)
    out = {"init_s": round(time.time() - t0, 3), **run(eng, args)}
    print(json.dumps(out, indent=2, default=str))
    return out


if __name__ == "__main__":
    main()
