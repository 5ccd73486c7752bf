"""One run of one cell: set up, measure for ``--seconds``, check the outputs
against the plain reference, and print the result line.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``: each number
compared, with its limit. The same comparisons end standard error.

A run fails (exit 1, no result) without the cards its cell needs, and
when JAX or the JAX package is loaded in this process once the window has
closed.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path
from typing import List, Optional

from . import env
from .spec import Spec


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"chipbench: {msg}", file=sys.stderr)
    return 1


def run(argv: Optional[List[str]], root: Path, t_start: float, device=None) -> int:
    """Run a cell and print its result; ``device`` other than None skips
    the look for cards and runs there (the CPU tests)."""
    args = parse_args(argv)
    spec = Spec(root)
    cell = spec.cell(args.workload)
    if device is None:
        try:
            env.require_cards(cell.chips)
        except env.NoCard as exc:
            return fail(str(exc))
        device = "cuda"
        env.set_cache_dirs(root)
    import torch

    from .runtime import Context

    torch.set_num_threads(min(4, torch.get_num_threads()))
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  device=torch.device(device), t_start=t_start)
    kind = importlib.import_module(f"harness.kinds.{cell.traffic['kind']}")
    out = kind.run(ctx)

    found = env.forbidden_modules()
    if found:
        return fail(f"forbidden modules are loaded: {', '.join(found)}")
    metrics = {}
    for m in spec.metrics(cell.name, ctx.trace):
        value = spec.reader(m["name"]).read(out.record, out.profile)
        if value is None:
            if not ctx.trace:
                return fail(f"end-to-end metric {m['name']} has no reading")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(v <= lim for _, v, lim in out.checks) and out.failed == 0
    on_card = ctx.device.type == "cuda"
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(ctx.device) if on_card else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": out.record["peak_reserved"],
    }
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device_info}
    if ctx.trace and out.profile is not None:
        device_info.update(busy_s=out.profile["busy_s"], window_s=out.profile["window_s"])
        result["breakdown"] = {"device_ops": out.profile["device_ops"],
                               "idle_gaps": out.profile["idle_gaps"]}
    if on_card:
        print(f"chipbench: card {env.card_line()}", file=sys.stderr)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in out.checks}
    for n, v, lim in out.checks:
        print(f"check {n} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    print(json.dumps(result))
    return 0


def main(t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    root = Path(__file__).resolve().parents[2]
    return run(sys.argv[1:], root, t_start)
