"""repro_torch.alloc — the allocation-policy subsystem of the PyTorch port.

The modules in this package are copies of ``repro.alloc``'s modules of the
same names, kept byte-identical so the port's serving path makes exactly
the allocation decisions of the reference. ``tests/test_torch_alloc.py``
checks the copies verbatim and replays the checked-in engine traces and a
fixed-seed training trace through both copies, requiring identical state
counts, peaks and OOM points, which is what catches drift between them.

Registered backends, in registration order (the reference's): ``caching``
and ``native`` (the paper's baselines, §2.2), ``gmlake`` (virtual-memory
stitching, §3–§4), and the planning backends ``stalloc`` (spatio-temporal
planning from a profiled trace), ``ellm`` (elastic arena spilling to
stitching) and ``hybrid`` (stalloc's plan with a gmlake tail). The exports
are the reference package's.
"""

from . import registry
from .chunks import (
    CHUNK_SIZE,
    DEFAULT_FRAG_LIMIT,
    GB,
    MB,
    PREEMPTION_TRACE_FORMAT,
    SMALL_ALLOC_LIMIT,
    DeviceOOM,
    Extent,
    FaultInjector,
    FaultSchedule,
    FaultWindow,
    PreemptionEvent,
    TransientDeviceError,
    VMMCostLedger,
    VMMDevice,
    load_preemption_trace,
    num_chunks,
    pack_extent_runs,
    pack_extents,
    round_up,
    unpack_extents,
)
from .metrics import (
    AllocatorEventLog,
    AllocatorStats,
    ReplayResult,
    mem_reduction_ratio,
)
from .protocol import AllocatorCapabilities, AllocatorProtocol
from .recovery import RecoveryConfig, recovery_enabled, run_ladder

# backend modules self-register on import; import order fixes the
# registry's (stable) iteration order
from .caching_allocator import (
    Allocation,
    AllocatorOOM,
    CachingAllocator,
    NativeAllocator,
    QuotaDenied,
)
from .gmlake import GMLakeAllocator, PBlock, SBlock
from .stalloc import PlacementPlan, PlannedBlock, STAllocAllocator, build_plan
from .ellm import ELLMAllocator, ElasticBlock
from .hybrid import HybridAllocator

__all__ = [
    "registry",
    "CHUNK_SIZE",
    "DEFAULT_FRAG_LIMIT",
    "GB",
    "MB",
    "SMALL_ALLOC_LIMIT",
    "DeviceOOM",
    "Extent",
    "FaultInjector",
    "FaultSchedule",
    "FaultWindow",
    "PreemptionEvent",
    "PREEMPTION_TRACE_FORMAT",
    "load_preemption_trace",
    "TransientDeviceError",
    "VMMCostLedger",
    "VMMDevice",
    "num_chunks",
    "pack_extent_runs",
    "pack_extents",
    "round_up",
    "unpack_extents",
    "AllocatorEventLog",
    "AllocatorStats",
    "ReplayResult",
    "mem_reduction_ratio",
    "AllocatorCapabilities",
    "AllocatorProtocol",
    "RecoveryConfig",
    "recovery_enabled",
    "run_ladder",
    "Allocation",
    "AllocatorOOM",
    "CachingAllocator",
    "NativeAllocator",
    "QuotaDenied",
    "GMLakeAllocator",
    "PBlock",
    "SBlock",
    "PlacementPlan",
    "PlannedBlock",
    "STAllocAllocator",
    "build_plan",
    "ELLMAllocator",
    "ElasticBlock",
    "HybridAllocator",
]
