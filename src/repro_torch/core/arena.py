"""Arena: the PyTorch-side memory lake.

One pre-reserved device buffer of 2 MB chunks, ``(n_chunks, chunk_elems)``,
managed by the GMLake allocator (host-side metadata) and accessed through
the stitch kernels (device-side data movement). The allocator decides
*which* chunks back a logical tensor; the extent table / chunk map carries
that decision to the kernels.

Counterpart of ``repro.core.arena``. There, ``store`` threads the buffer
functionally (each call returns a new buffer); here ``store`` scatters into
the same buffer in place, which is what the memory lake is on a GPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..alloc import registry
from ..alloc.caching_allocator import Allocation
from ..alloc.chunks import CHUNK_SIZE, VMMDevice
from ..device import DeviceLike, resolve_device
from ..kernels import ops
from .trace import TraceRecorder


@dataclass(frozen=True)
class ArenaConfig:
    n_chunks: int
    dtype: torch.dtype = torch.bfloat16
    device: DeviceLike = "cuda"

    @property
    def itemsize(self) -> int:
        return self.dtype.itemsize

    @property
    def chunk_elems(self) -> int:
        return CHUNK_SIZE // self.itemsize

    @property
    def capacity_bytes(self) -> int:
        return self.n_chunks * CHUNK_SIZE


class Arena:
    """Allocator backend + device buffer + stitch-kernel access paths.

    ``allocator`` is backend-generic: a ``repro_torch.alloc`` registry key
    (default ``"gmlake"``), an already-constructed backend instance, or
    None. Host-side allocation accounting (``alloc_elems``/``free``/
    metrics) works with every backend; the device data-movement paths
    (``chunk_map``/``store``/``load``) additionally require the backend's
    blocks to carry chunk ``extents`` — i.e. a stitching backend — because
    the kernels address physical chunks, not virtual offsets.
    """

    def __init__(self, config: ArenaConfig, allocator=None,
                 recorder: Optional[TraceRecorder] = None):
        self.config = config
        self.device = resolve_device(config.device)
        if allocator is None:
            allocator = "gmlake"
        if isinstance(allocator, str):
            self.device_model = VMMDevice(config.capacity_bytes)
            self.allocator = registry.create(allocator, self.device_model)
        else:
            self.device_model = allocator.device
            self.allocator = allocator
        self.recorder = recorder
        self.buf = torch.zeros((config.n_chunks, config.chunk_elems), dtype=config.dtype,
                               device=self.device)
        self._trace_ids: Dict[int, int] = {}

    # ------------------------------------------------------------------
    # allocation (host metadata only)
    # ------------------------------------------------------------------
    def alloc_elems(self, n_elems: int, label: str = "") -> Allocation:
        nbytes = int(n_elems) * self.config.itemsize
        alloc = self.allocator.malloc(max(nbytes, CHUNK_SIZE))
        if self.recorder is not None:
            self._trace_ids[id(alloc)] = self.recorder.alloc(alloc.req_size, label)
        return alloc

    def free(self, alloc: Allocation) -> None:
        self.allocator.free(alloc)
        if self.recorder is not None:
            self.recorder.free(self._trace_ids.pop(id(alloc)))

    def require_stitching(self) -> None:
        """Fail loudly when a device data path is used with a backend whose
        blocks carry no chunk extents (capabilities.stitching is False)."""
        caps = getattr(type(self.allocator), "capabilities", None)
        if caps is None or not caps.stitching:
            raise TypeError(
                f"arena data movement needs a stitching backend whose blocks "
                f"carry chunk extents; {self.allocator.name!r} is "
                f"accounting-only here (alloc_elems/free/metrics still work)"
            )

    def chunk_map(self, alloc: Allocation) -> torch.Tensor:
        """The allocation's logical->physical chunk map, int32 on the arena's device."""
        self.require_stitching()
        return ops.chunk_map_from_extents(alloc.block.extents, self.config.n_chunks,
                                          self.device)

    # ------------------------------------------------------------------
    # data movement (device)
    # ------------------------------------------------------------------
    def store(self, alloc: Allocation, tensor: torch.Tensor) -> None:
        """Write a logical tensor into the allocation's chunks (in place)."""
        c = self.config
        flat = tensor.to(device=self.device, dtype=c.dtype).reshape(-1)
        n_chunks = -(-flat.numel() // c.chunk_elems)
        cmap = self.chunk_map(alloc)
        if n_chunks > cmap.shape[0]:
            raise ValueError(f"tensor needs {n_chunks} chunks, allocation has {cmap.shape[0]}")
        values = torch.zeros((n_chunks, c.chunk_elems), dtype=c.dtype, device=self.device)
        values.view(-1)[: flat.numel()] = flat
        ops.scatter(self.buf, cmap[:n_chunks], values)

    def load(self, alloc: Allocation, shape: Tuple[int, ...], dtype=None) -> torch.Tensor:
        """Read a logical tensor back out of the allocation's chunks."""
        c = self.config
        n_elems = math.prod(int(s) for s in shape)
        n_chunks = -(-n_elems // c.chunk_elems)
        cmap = self.chunk_map(alloc)[:n_chunks]
        out = ops.gather(self.buf, cmap).reshape(-1)[:n_elems].reshape(shape)
        return out.to(dtype) if dtype is not None else out

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def reserved_bytes(self) -> int:
        return self.allocator.reserved_bytes

    @property
    def active_bytes(self) -> int:
        return self.allocator.stats.active_bytes

    @property
    def utilization(self) -> float:
        return self.allocator.stats.utilization
