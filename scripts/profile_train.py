#!/usr/bin/env python3
"""Time and profile the port's train step on one CUDA card.

    python3 scripts/profile_train.py

Trains smollm-135m at full width at chip_smoke.py's size (bf16, remat on,
batch 8, seq 256) from the launcher's seeded state and prints what
``measure`` reports as one JSON object. ``measure`` is also what
chip_smoke.py's phase 6b runs on its trained state, so the two report one
measurement. Needs a card: there is no CPU mode.
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BATCH, SEQ, SEED, TOP = 8, 256, 0, 12
WARMUP, STEPS = 2, 5


def measure(step, state, batch_at, first: int):
    """Train ``WARMUP`` untimed steps (they fill the caching allocator),
    then:

    1. time ``STEPS`` steps between CUDA events, with no profiler, and read
       the peak memory allocated and reserved from the first timed step on
       (what is live before it, the state included, counts);
    2. run as many steps again under ``torch.profiler`` (CPU and CUDA
       activities) and report per step: kernels launched, device busy time
       (the union of kernel and copy intervals), the profiled window's
       length and so the device's idle share, the kernels taking the most
       device time and the host operations taking the most host time.

    Batches are ``batch_at(first)``, ``batch_at(first + 1)``, ..., all made
    before the first step. Returns (state, report)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.utils.opstats import device_busy_ms

    batches = [batch_at(first + i) for i in range(WARMUP + 2 * STEPS)]
    for b in batches[:WARMUP]:
        state, m = step(state, b)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for b in batches[WARMUP:WARMUP + STEPS]:
        state, m = step(state, b)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / STEPS
    peak_alloc, peak_res = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    tokens = sum(b["tokens"].numel() for b in batches[WARMUP:WARMUP + STEPS]) / STEPS

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for b in batches[WARMUP + STEPS:]:
            state, m = step(state, b)
        end.record()
        end.synchronize()
    window_ms = start.elapsed_time(end)

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    busy_ms = device_busy_ms(prof)
    top_device = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    top_host = sorted(host, key=lambda e: -e.self_cpu_time_total)[:TOP]
    report = {
        "steps": STEPS,
        "ms_per_step": ms,
        "tokens_per_s": tokens / ms * 1e3,
        "peak_allocated_bytes": peak_alloc, "peak_reserved_bytes": peak_res,
        "profiled": {
            "ms_per_step": window_ms / STEPS,
            "device_busy_ms_per_step": busy_ms / STEPS,
            "device_idle_share": 1.0 - busy_ms / window_ms,
            "kernels_per_step": len(kernels) / STEPS,
            "top_device": [{"name": k[:120], "ms_per_step": v[0] / 1e3 / STEPS,
                            "calls_per_step": v[1] / STEPS} for k, v in top_device],
            "top_host": [{"name": e.key[:120], "self_ms_per_step": e.self_cpu_time_total
                          / 1e3 / STEPS, "calls_per_step": e.count / STEPS} for e in top_host],
        },
        "last_loss": float(m["loss"]),
    }
    return state, report


def main() -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.device import resolve_device
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import init_state, make_train_step

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("smollm-135m").full
    adamw = opt.AdamWConfig()
    state = init_state(cfg, adamw, torch.Generator().manual_seed(SEED), dev)
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                                      seed=SEED), dev)
    _, report = measure(make_train_step(cfg, adamw), state, data.batch_at, 0)
    out = {"device": torch.cuda.get_device_name(0), "arch": cfg.name,
           "n_layers": cfg.n_layers, "dtype": str(cfg.dtype).split(".")[-1],
           "remat": cfg.remat, "batch": BATCH, "seq": SEQ, **report}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
