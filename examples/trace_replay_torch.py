"""Replay the paper's whole evaluation matrix on the PyTorch port: every
model x strategy combo, caching vs GMLake, with the aggregate
MemReductionRatio.

Counterpart of ``trace_replay.py``, importing the port's copies of the
allocator and trace code; it prints what the reference's example prints.
Host-side only: no device is used.

    PYTHONPATH=src python examples/trace_replay_torch.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.alloc import GB, mem_reduction_ratio  # noqa: E402
from repro_torch.core.trace import PAPER_MODELS, run_workload, training_trace  # noqa: E402

reserved, gm = [], []
print(f"{'model':14s} {'strat':5s} {'caching':>18s} {'gmlake':>18s} {'gain':>7s}")
for mname in ("opt-1.3b", "opt-13b", "vicuna-13b", "gpt-neox-20b"):
    for strat in ("R", "LR", "LRO"):
        tr = training_trace(PAPER_MODELS[mname], strategies=strat, world=4,
                            batch=8, seq=2048, iters=8)
        res = {}
        for alloc in ("caching", "gmlake"):
            res[alloc] = run_workload(tr, alloc, capacity_bytes=80 * GB)
        c, g = res["caching"], res["gmlake"]
        reserved.append(c.stats.peak_reserved)
        gm.append(g.stats.peak_reserved)
        print(f"{mname:14s} {strat:5s} "
              f"{c.utilization:6.1%}/{c.reserved_gb:5.1f}GB "
              f"{g.utilization:6.1%}/{g.reserved_gb:5.1f}GB "
              f"{g.utilization - c.utilization:+7.1%}")
print(f"\naggregate MemReductionRatio = {mem_reduction_ratio(reserved, gm):.1%} "
      f"(paper: 15% avg, up to 33%)")
