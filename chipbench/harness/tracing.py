"""Spans around calls into the program's layers, and the reading of a
``torch.profiler`` trace.

Spans are the benchmark's own: ``Spans.wrap`` replaces a bound method or
function with one that times it on the host clock and marks it with
``record_function``, so the profiler's trace names what the host was
doing. A span that ends in a synchronisation of its device (``sync``)
measures the device work it launched as well; the benchmark turns spans on
only in ``--trace 1`` runs.

``read_profile`` reduces a trace to the device's busy time (the union of
its kernel and copy intervals), the operations that took the most device
time, and the longest idle gaps named by the innermost span that was open
on the host when the device ran dry. The busy arithmetic is the program's
``utils/opstats.device_busy_ms``, frozen here.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

TRACED_WINDOW = "chipbench.traced_window"
TOP = 10


class Spans:
    """Host-clock durations (seconds) by span name."""

    def __init__(self):
        self.durations: Dict[str, List[float]] = defaultdict(list)
        self.names: set = {TRACED_WINDOW}

    def wrap(self, fn: Callable, name: str, sync: Optional[torch.device] = None) -> Callable:
        self.names.add(name)
        out = self.durations[name]

        def timed(*args, **kwargs):
            with record_function(name):
                t = time.perf_counter()
                result = fn(*args, **kwargs)
                if sync is not None and sync.type == "cuda":
                    torch.cuda.synchronize(sync)
                out.append(time.perf_counter() - t)
            return result

        return timed


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def read_profile(prof, span_names) -> Dict:
    """Busy seconds, device operations and named idle gaps of the traced
    window (the ``TRACED_WINDOW`` span); raises if the device ran nothing."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        if e.name in span_names or getattr(e, "is_user_annotation", False):
            # a span is marked on the host and, as a range, on the device
            # timeline too; only the host's counts, and never as device work
            if e.device_type == DeviceType.CPU:
                host.append((e.time_range.start, e.time_range.end, e.name))
        elif e.device_type == DeviceType.CUDA:
            device.append(e)
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    windows = [(s, e) for s, e, n in host if n == TRACED_WINDOW]
    ws, we = windows[0] if windows else (min(e.time_range.start for e in device), 0.0)
    intervals = _union([(e.time_range.start, e.time_range.end) for e in device])
    we = max(we, intervals[-1][1])
    busy_us = sum(min(e, we) - max(s, ws) for s, e in intervals if e > ws and s < we)
    by_name: Dict[str, float] = defaultdict(float)
    for e in device:
        by_name[e.name] += e.time_range.elapsed_us()
    gaps, cursor = [], ws
    for s, e in intervals:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        open_ = [(he - hs, n) for hs, he, n in host if hs <= s < he and n != TRACED_WINDOW]
        named.append([min(open_)[1] if open_ else "host", (e - s) / 1e6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (we - ws) / 1e6,
        "device_ops_count": len(device),
        "device_ops": [[n[:120], t / 1e6] for n, t in top],
        "idle_gaps": named,
    }
