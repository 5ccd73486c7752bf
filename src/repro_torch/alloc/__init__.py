"""repro_torch.alloc — the allocation-policy subsystem of the PyTorch port.

The modules in this package are copies of ``repro.alloc``'s modules of the
same names, kept byte-identical so the port's serving path makes exactly
the allocation decisions of the reference. ``tests/test_torch_alloc.py``
replays the checked-in engine traces and a fixed-seed training trace
through both copies and requires identical state counts, peaks and OOM
points, which is what catches drift between them.

Registered backends, in registration order: ``caching`` and ``native``
(the paper's baselines, §2.2) and ``gmlake`` (virtual-memory stitching,
§3–§4). The planning backends (``stalloc``, ``ellm``, ``hybrid``) are not
part of the port yet.
"""

from . import registry
from .chunks import (
    CHUNK_SIZE,
    DEFAULT_FRAG_LIMIT,
    GB,
    MB,
    SMALL_ALLOC_LIMIT,
    DeviceOOM,
    Extent,
    FaultInjector,
    FaultSchedule,
    VMMDevice,
    num_chunks,
    round_up,
)
from .metrics import AllocatorEventLog, AllocatorStats, ReplayResult
from .protocol import AllocatorCapabilities, AllocatorProtocol

# backend modules self-register on import; import order fixes the
# registry's (stable) iteration order
from .caching_allocator import Allocation, AllocatorOOM, CachingAllocator, NativeAllocator
from .gmlake import GMLakeAllocator

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
    "VMMDevice",
    "num_chunks",
    "round_up",
    "AllocatorEventLog",
    "AllocatorStats",
    "ReplayResult",
    "AllocatorCapabilities",
    "AllocatorProtocol",
    "Allocation",
    "AllocatorOOM",
    "CachingAllocator",
    "NativeAllocator",
    "GMLakeAllocator",
]
