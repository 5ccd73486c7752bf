"""Quickstart on the PyTorch port: GMLake in 60 seconds.

Counterpart of ``quickstart.py``, importing the port's copies of the
allocator (``repro_torch.alloc``) and trace (``repro_torch.core.trace``)
code; it prints what the reference's example prints. Runs the paper's
Figure-1 scenario (splitting strands memory; stitching recovers it), then
replays a real fine-tuning allocation trace through every registered
allocator backend side by side. Host-side only: no device is used.

    PYTHONPATH=src python examples/quickstart_torch.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.alloc import (  # noqa: E402
    GB, MB, AllocatorOOM, CachingAllocator, GMLakeAllocator, VMMDevice, registry,
)
from repro_torch.core.trace import PAPER_MODELS, run_workload, training_trace  # noqa: E402

# --- Figure 1: fragmentation kills the caching allocator -------------------
print("== Figure 1 scenario (128 MB device) ==")
for name, cls in (("caching", CachingAllocator), ("gmlake", GMLakeAllocator)):
    dev = VMMDevice(128 * MB)
    alloc = cls(dev)
    blocks = [alloc.malloc(9 * MB) for _ in range(12)]
    for b in blocks[::2]:
        alloc.free(b)  # 54 MB free — but scattered in 9 MB holes
    try:
        big = alloc.malloc(48 * MB)
        print(f"{name:8s}: 48 MB allocation OK "
              f"(stitched from {len(getattr(big.block, 'pblocks', [big.block]))} pieces)")
    except AllocatorOOM:
        print(f"{name:8s}: OOM — free memory exists but is fragmented")

# --- paper workload: OPT-13B fine-tune, LoRA+recompute+offload, 4 GPUs -----
# every backend in the registry is a drop-in: a name is all run_workload
# needs (planning backends get their profile pass automatically)
print("\n== OPT-13B LRO trace on 80 GB, all backends (paper Fig. 10) ==")
trace = training_trace(PAPER_MODELS["opt-13b"], strategies="LRO", world=4,
                       batch=8, seq=2048, iters=8)
print(f"trace: {trace.n_allocs} allocations, mean {trace.mean_alloc_mb:.0f} MB")
for name in registry.names():
    r = run_workload(trace, name, capacity_bytes=80 * GB)
    print(f"{name:8s}: utilization={r.utilization:.1%}  "
          f"peak reserved={r.reserved_gb:.1f} GB  "
          f"(frag={r.fragmentation:.1%})")
