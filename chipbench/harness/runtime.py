"""What every kind of cell shares: the run's context, device
synchronisation, peak memory, freeing the program's state, and the
profiled stretch of a ``--trace 1`` run."""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch

from . import tracing
from .spec import Cell


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # host clock when the process started
    spans: tracing.Spans = field(default_factory=tracing.Spans)

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"


@dataclass
class Outcome:
    """What a kind hands back: the record the metric readers read, the
    numbers compared with their limits, and the counts of work."""

    record: Dict
    checks: list
    attempted: int
    failed: int
    profile: Optional[Dict] = None


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peaks(device: torch.device) -> Dict[str, int]:
    if device.type != "cuda":
        return {"peak_reserved": 0, "peak_allocated": 0}
    return {"peak_reserved": torch.cuda.max_memory_reserved(device),
            "peak_allocated": torch.cuda.max_memory_allocated(device)}


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def profiled(ctx: Context, body: Callable[[], int]) -> Optional[Dict]:
    """Run ``body`` (which returns how many steps it ran) under
    ``torch.profiler`` on the card and read the trace; None off the card
    or when tracing is off."""
    if not (ctx.trace and ctx.on_card):
        return None
    from torch.profiler import ProfilerActivity, profile, record_function

    sync(ctx.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(tracing.TRACED_WINDOW):
            t = time.perf_counter()
            steps = body()
            sync(ctx.device)
            host_s = time.perf_counter() - t
    out = tracing.read_profile(prof, ctx.spans.names)
    out.update(steps=steps, host_window_s=host_s)
    return out
