"""Host-offload staging through the GMLake arena (ZeRO-Offload style).

Counterpart of ``repro.core.offload``. Optimizer shards or activation
checkpoints are spilled to host memory and staged back through arena
allocations. Every stage allocation goes through the arena's allocator, so
the irregular alloc/free stream that fragments a caching allocator (the
paper's offload, 'O') is absorbed by stitching; the data moves through
``Arena.store``/``load``, i.e. the ``stitch_scatter``/``stitch_gather``
kernels on the card. Spilled tensors live on the host as CPU tensors
(numpy has no bfloat16). A ``TraceRecorder`` can capture the event stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..alloc.caching_allocator import Allocation
from .arena import Arena
from .trace import TraceRecorder


@dataclass
class _Resident:
    alloc: Allocation
    shape: Tuple[int, ...]
    dtype: torch.dtype


class OffloadManager:
    """Named tensors living either in the arena (device) or on the host."""

    def __init__(self, arena: Arena, recorder: Optional[TraceRecorder] = None):
        self.arena = arena
        if recorder is not None and self.arena.recorder is None:
            self.arena.recorder = recorder
        self._device: Dict[str, _Resident] = {}
        self._host: Dict[str, torch.Tensor] = {}

    # ------------------------------------------------------------------
    def put(self, name: str, tensor: torch.Tensor) -> None:
        """Place (or replace) a tensor in the arena."""
        if name in self._device:
            self.drop(name)
        alloc = self.arena.alloc_elems(tensor.numel(), f"offload.{name}")
        self.arena.store(alloc, tensor)
        self._device[name] = _Resident(alloc, tuple(tensor.shape), tensor.dtype)

    def get(self, name: str) -> torch.Tensor:
        """Read a tensor (staging it back from the host if spilled)."""
        if name not in self._device:
            self.fetch(name)
        r = self._device[name]
        return self.arena.load(r.alloc, r.shape, r.dtype)

    def spill(self, name: str) -> None:
        """Device -> host; frees the arena allocation."""
        r = self._device.pop(name)
        self._host[name] = self.arena.load(r.alloc, r.shape, r.dtype).cpu()
        self.arena.free(r.alloc)

    def fetch(self, name: str) -> None:
        """Host -> device through a fresh arena allocation."""
        host = self._host.pop(name)
        alloc = self.arena.alloc_elems(host.numel(), f"offload.{name}")
        self.arena.store(alloc, host)
        self._device[name] = _Resident(alloc, tuple(host.shape), host.dtype)

    def drop(self, name: str) -> None:
        if name in self._device:
            self.arena.free(self._device.pop(name).alloc)
        self._host.pop(name, None)

    # ------------------------------------------------------------------
    def is_resident(self, name: str) -> bool:
        return name in self._device

    def names(self):
        return set(self._device) | set(self._host)
