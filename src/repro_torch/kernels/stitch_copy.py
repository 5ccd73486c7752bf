"""Stitched chunk gather/scatter: the CUDA counterpart of cuMemMap's data path.

Replaces the Pallas TPU kernels ``repro.kernels.stitch_copy.stitch_gather``
and ``stitch_scatter``. The kernel source is ``csrc/stitch_copy.cu``: grid
``(n_logical, blocks_per_chunk)``, each block reads its physical chunk id
from the int32 map on the card and copies its slice of the chunk as
16-byte vectors. On H100 it is bound by HBM bandwidth: ``2 * n_logical *
chunk_bytes`` over 3.35 TB/s.

The wrappers take a CUDA tensor to the kernel and a CPU tensor to the
plain version in ``ref.py``; nothing falls back. ``launches`` on each
wrapper counts kernel launches, so a run can show it went through them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import stitch_gather_ref, stitch_scatter_ref

_VEC_BYTES = 16


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("stitch_copy")
    for fn in (lib.stitch_gather, lib.stitch_scatter):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_rows(x: torch.Tensor, name: str) -> int:
    """Validate a (rows, chunk) operand; returns its row size in bytes."""
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D tensor, got {tuple(x.shape)} "
                         f"strides {x.stride()}")
    row_bytes = x.shape[1] * x.element_size()
    if row_bytes % _VEC_BYTES or x.data_ptr() % _VEC_BYTES:
        raise ValueError(f"{name}: rows must be 16-byte multiples on a 16-byte aligned "
                         f"base, got {row_bytes} bytes at {x.data_ptr():#x}")
    return row_bytes


def _check_map(chunk_map: torch.Tensor, arena: torch.Tensor) -> None:
    if chunk_map.dtype != torch.int32 or chunk_map.dim() != 1 or not chunk_map.is_contiguous():
        raise ValueError("chunk_map must be a contiguous 1-D int32 tensor")
    if chunk_map.device != arena.device:
        raise ValueError(f"chunk_map on {chunk_map.device}, arena on {arena.device}")


def _check_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"stitch kernels take CPU or CUDA tensors, got {x.device}")


def stitch_gather(arena: torch.Tensor, chunk_map: torch.Tensor) -> torch.Tensor:
    """Gather logical chunks out of the arena: ``out[i] = arena[chunk_map[i]]``.

    ``arena`` is ``(n_phys, chunk_elems)``; ``chunk_map`` int32 ``(n_logical,)``
    on the same device, with ids in ``[0, n_phys)``.
    """
    if arena.device.type == "cpu":
        return stitch_gather_ref(arena, chunk_map)
    _check_cuda(arena)
    row_bytes = _check_rows(arena, "arena")
    _check_map(chunk_map, arena)
    n_logical = chunk_map.shape[0]
    out = torch.empty((n_logical, arena.shape[1]), dtype=arena.dtype, device=arena.device)
    if n_logical == 0:
        return out
    with torch.cuda.device(arena.device):
        err = _lib().stitch_gather(
            arena.data_ptr(), chunk_map.data_ptr(), out.data_ptr(), n_logical, row_bytes,
            arena.shape[0], torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"stitch_gather kernel launch failed: CUDA error {err}")
    stitch_gather.launches += 1
    return out


def stitch_scatter(
    arena: torch.Tensor, chunk_map: torch.Tensor, values: torch.Tensor
) -> torch.Tensor:
    """Scatter logical chunks into the arena: ``arena[chunk_map[i]] = values[i]``.

    Writes ``arena`` in place and returns it; chunks outside the map are
    untouched. The JAX reference threads the arena functionally through an
    input/output alias; here the update is the same memory, made in place.
    ``chunk_map`` must not repeat a chunk (maps built from allocator
    extents never do).
    """
    if arena.device.type == "cpu":
        return stitch_scatter_ref(arena, chunk_map, values)
    _check_cuda(arena)
    row_bytes = _check_rows(arena, "arena")
    _check_rows(values, "values")
    _check_map(chunk_map, arena)
    n_logical = chunk_map.shape[0]
    if values.shape != (n_logical, arena.shape[1]) or values.dtype != arena.dtype:
        raise ValueError(f"values {tuple(values.shape)} {values.dtype} do not match "
                         f"({n_logical}, {arena.shape[1]}) {arena.dtype}")
    if values.device != arena.device:
        raise ValueError(f"values on {values.device}, arena on {arena.device}")
    if n_logical == 0:
        return arena
    with torch.cuda.device(arena.device):
        err = _lib().stitch_scatter(
            arena.data_ptr(), chunk_map.data_ptr(), values.data_ptr(), n_logical, row_bytes,
            arena.shape[0], torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"stitch_scatter kernel launch failed: CUDA error {err}")
    stitch_scatter.launches += 1
    return arena


stitch_gather.launches = 0
stitch_scatter.launches = 0
