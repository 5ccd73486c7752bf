"""Stitched decode attention: flash-decoding straight over the KV arena.

Replaces the Pallas TPU kernel
``repro.kernels.stitched_attention.stitched_decode_attention``. The kernel
source is ``csrc/stitched_attention.cu``. On H100 it is bound by HBM
bandwidth: the K and V rows of the valid tokens plus q and the output,
over 3.35 TB/s. The TPU kernel carries (m, l, acc) across a sequence's
chunks in VMEM from one grid step to the next; CUDA blocks cannot, so the
kernel splits each sequence's valid positions over blocks
(grid ``(B, KVH * ceil(G / 4), splits)``), each block keeping f32
(m, l, acc) in registers for up to 4 query heads of one kv head, and a
second small kernel merges the splits. The arena is read through a strided
view (chunk stride may exceed ``T_c * KVH * D``), so the KV cache can hand
over the token-structured prefix of every 2 MiB chunk without a copy.

The wrapper takes a CUDA tensor to the kernel and a CPU tensor to the
plain version in ``ref.py``; nothing falls back. ``launches`` counts
kernel launches (one per call: the partial pass and its merge).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build
from .ref import stitched_decode_attention_ref

#: these two mirror kGT and kMinSplitTokens in csrc/stitched_attention.cu
_G_TILE = 4
_MIN_SPLIT_TOKENS = 128
#: enough blocks for two waves over H100's 132 SMs
_TARGET_BLOCKS = 2 * 132
_MAX_HEAD_DIM = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("stitched_attention")
    fn = lib.stitched_decode_attention
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def _num_splits(batch: int, n_kv: int, group: int, capacity_tokens: int) -> int:
    """How many blocks share one (sequence, kv head, G tile): enough for
    ``_TARGET_BLOCKS`` blocks, but no more than the capacity allows at
    ``_MIN_SPLIT_TOKENS`` positions each."""
    blocks = batch * n_kv * -(-group // _G_TILE)
    want = -(-_TARGET_BLOCKS // max(blocks, 1))
    return max(1, min(want, -(-capacity_tokens // _MIN_SPLIT_TOKENS)))


def _check_arena(x: torch.Tensor, name: str, q: torch.Tensor) -> None:
    if x.dim() != 4 or x.dtype != q.dtype or x.device != q.device:
        raise ValueError(f"{name} must be 4-D {q.dtype} on {q.device}, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    _, t_c, n_kv, d = x.shape
    if x.stride()[1:] != (n_kv * d, d, 1) or x.stride(0) < t_c * n_kv * d:
        raise ValueError(f"{name}: each chunk's (T_c, KVH, D) block must be contiguous, "
                         f"got strides {x.stride()}")


def _check_index(x: torch.Tensor, name: str, shape, q: torch.Tensor) -> None:
    if x.dtype != torch.int32 or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous int32 {tuple(shape)}, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device != q.device:
        raise ValueError(f"{name} on {x.device}, q on {q.device}")


def stitched_decode_attention(
    q: torch.Tensor,  # (B, H, D)
    k_arena: torch.Tensor,  # (n_phys, T_c, KVH, D)
    v_arena: torch.Tensor,  # (n_phys, T_c, KVH, D)
    page_table: torch.Tensor,  # (B, C) int32, physical chunk per logical chunk
    seq_lens: torch.Tensor,  # (B,) int32
    *,
    page_table_v: Optional[torch.Tensor] = None,  # defaults to sharing page_table
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention over the stitched KV arena. Returns (B, H, D) in q's dtype.

    K and V may live in the same arena buffer under different page tables
    (pass the buffer twice + ``page_table_v``), or in separate buffers under
    one shared table. Positions ``>= seq_lens[b]`` are masked; a sequence of
    length 0 gives zeros.
    """
    if q.device.type == "cpu":
        return stitched_decode_attention_ref(
            q, k_arena, v_arena, page_table, seq_lens, page_table_v, scale=scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"stitched attention takes CPU or CUDA tensors, got {q.device}")
    if page_table_v is None:
        page_table_v = page_table
    if q.dim() != 3 or not q.is_contiguous() or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q must be contiguous (B, H, D) float32/bfloat16, got "
                         f"{tuple(q.shape)} {q.dtype}")
    batch, n_heads, head_dim = q.shape
    _check_arena(k_arena, "k_arena", q)
    _check_arena(v_arena, "v_arena", q)
    n_phys, chunk_tokens, n_kv, head_dim_k = k_arena.shape
    if v_arena.shape != k_arena.shape or v_arena.stride(0) != k_arena.stride(0):
        raise ValueError("k_arena and v_arena must share shape and chunk stride")
    if head_dim_k != head_dim or n_heads % n_kv or head_dim > _MAX_HEAD_DIM:
        raise ValueError(f"need H % KVH == 0 and matching D <= {_MAX_HEAD_DIM}; got "
                         f"H={n_heads} KVH={n_kv} D={head_dim}/{head_dim_k}")
    n_chunks = page_table.shape[1] if page_table.dim() == 2 else -1
    _check_index(page_table, "page_table", (batch, n_chunks), q)
    _check_index(page_table_v, "page_table_v", (batch, n_chunks), q)
    _check_index(seq_lens, "seq_lens", (batch,), q)

    scale = (head_dim**-0.5) if scale is None else scale
    splits = _num_splits(batch, n_kv, n_heads // n_kv, n_chunks * chunk_tokens)
    f32 = dict(dtype=torch.float32, device=q.device)
    part_acc = torch.empty((batch, n_heads, splits, head_dim), **f32)
    part_ml = torch.empty((batch, n_heads, splits, 2), **f32)
    out = torch.empty_like(q)
    if batch == 0:
        return out
    with torch.cuda.device(q.device):
        err = _lib().stitched_decode_attention(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
            page_table.data_ptr(), page_table_v.data_ptr(), seq_lens.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
            batch, n_heads, n_kv, head_dim, chunk_tokens, n_chunks, k_arena.stride(0),
            n_phys, splits, scale, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"stitched_decode_attention kernel launch failed: CUDA error {err}")
    stitched_decode_attention.launches += 1
    return out


stitched_decode_attention.launches = 0
