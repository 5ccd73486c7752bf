"""Stitched decode attention: flash-decoding straight over the KV arena.

Replaces the Pallas TPU kernel
``repro.kernels.stitched_attention.stitched_decode_attention``. The kernel
source is ``csrc/stitched_attention.cu``. On H100 it is bound by HBM
bandwidth: the K and V rows of the valid tokens plus q and the output,
over 3.35 TB/s. The TPU kernel carries (m, l, acc) across a sequence's
chunks in VMEM from one grid step to the next; CUDA blocks run in no order,
so the kernel cuts each sequence into tiles (``tile_tokens`` tokens of one
chunk, never crossing a chunk boundary), gives each block a fixed number of
whole tiles (a split) of one sequence for a group of kv heads, stages the
tiles in shared memory through a ring of ``cp.async`` copies, and lets the
last block of each (sequence, head group) merge the splits' partials in the
same launch. ``attention_plan`` sizes all of that from the geometry on the
host; ``tile_ranges`` spells out the tile walk the kernel does. The sizing
constants below were chosen by timing the alternatives on H100 at
smollm-135m's shapes (PERF.md, Findings). The arena is
read through a strided view (chunk stride may exceed ``T_c * KVH * D``), so
the KV cache can hand over the token-structured prefix of every 2 MiB chunk
without a copy. A dense cache (B, S, KVH, D) is an arena of B chunks of S
tokens under the identity page table: ``models/layers.py`` decodes through
this kernel that way, with a sliding ``window`` where the model has one
(the stitched KV cache passes none).

The wrapper takes a CUDA tensor to the kernel and a CPU tensor to the
plain version in ``ref.py``; nothing falls back. ``launches`` counts
kernel launches: one per call with a non-empty batch.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from . import build
from .ref import stitched_decode_attention_ref

#: these three mirror kMaxThreads, kMaxTile and kStages in csrc/stitched_attention.cu
MAX_THREADS = 320
MAX_TILE_TOKENS = 64
STAGES = 2  # stages of the shared-memory tile ring
#: query heads of one kv head that a thread takes together (the kernel's GC)
MAX_HEAD_CHUNK = 4
#: threads a block aims for when its P.V units are fewer
_TARGET_THREADS = 256
#: shared memory a block may take on H100 (227 KB)
SMEM_LIMIT = 232_448
#: shared memory for the tile ring: about two blocks per SM
_RING_BYTES = 104 * 1024
_MIN_TILES_PER_SPLIT = 8
#: blocks the splits aim for at full capacity: 16 per SM of H100's 132
_TARGET_BLOCKS = 16 * 132
_MAX_HEAD_DIM = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclass(frozen=True)
class AttentionPlan:
    kv_per_block: int  # kv heads a block takes (with all their query heads)
    tile_tokens: int  # tokens per tile (a tile never crosses a chunk)
    head_chunk: int  # query heads a thread takes together
    phases: int  # P.V threads that share one output, each every phases-th token
    tiles_per_chunk: int
    tiles_per_split: int
    splits: int  # blocks per (sequence, head group) the capacity needs
    threads: int  # block size
    smem_bytes: int


def _units(kv_per_block: int, group: int, head_dim: int) -> int:
    """P.V units of a block: (kv head, chunk of query heads, four dims)."""
    head_chunk = min(group, MAX_HEAD_CHUNK)
    return kv_per_block * -(-group // head_chunk) * head_dim // 4


def smem_bytes(kv_per_block: int, group: int, head_dim: int, itemsize: int,
               tile_tokens: int, splits: int = 1, phases: int = 1) -> int:
    """Dynamic shared memory of one block, as the kernel lays it out: the
    ring of K and V tiles (rows padded by 16 bytes; after the last tile it
    holds the P.V phases' sums, then the merge's (m, l) of every split),
    then in f32 q, the tile's probabilities (4 slots per (kv head, head
    chunk)), (m, l, alpha) per head, and a flag."""
    pitch = kv_per_block * head_dim * itemsize + 16
    heads = kv_per_block * group
    head_chunk = min(group, MAX_HEAD_CHUNK)
    pairs = kv_per_block * -(-group // head_chunk)
    units = _units(kv_per_block, group, head_dim)
    ring = max(STAGES * 2 * tile_tokens * pitch, 8 * splits * heads,
               16 * phases * units * head_chunk)
    ring = -(-ring // 16) * 16
    return ring + 4 * (heads * head_dim + tile_tokens * pairs * 4 + 3 * heads + 1)


@functools.lru_cache(maxsize=256)
def attention_plan(batch: int, n_heads: int, n_kv: int, head_dim: int, chunk_tokens: int,
                   n_chunks: int, itemsize: int) -> AttentionPlan:
    """Kv heads per block, tile size, threads and splits for one geometry.

    A block takes all kv heads when it can, so a tile of K is one
    contiguous run of the chunk; fewer only where its P.V units would
    exceed ``MAX_THREADS`` or its shared memory would not fit. Tiles are as
    long as the ring budget allows (at most 64 tokens and one chunk). P.V
    units are repeated over token phases up to about ``_TARGET_THREADS``
    threads. Splits hold a fixed number of whole tiles, enough to give
    about ``_TARGET_BLOCKS`` blocks when every sequence is full; the kernel
    runs only the splits that ``seq_len`` reaches."""
    if n_heads % n_kv or head_dim % 8 or not 0 < head_dim <= _MAX_HEAD_DIM:
        raise ValueError(f"need H % KVH == 0 and D a multiple of 8 up to {_MAX_HEAD_DIM}; "
                         f"got H={n_heads} KVH={n_kv} D={head_dim}")
    group = n_heads // n_kv
    for kv_per_block in (k for k in range(n_kv, 0, -1) if n_kv % k == 0):
        if (_units(kv_per_block, group, head_dim) <= MAX_THREADS and
                smem_bytes(kv_per_block, group, head_dim, itemsize, 1) <= SMEM_LIMIT):
            break
    else:
        raise ValueError(f"no kv-head group fits a block: H={n_heads} KVH={n_kv} D={head_dim}")
    units = _units(kv_per_block, group, head_dim)
    phases = max(1, min(-(-_TARGET_THREADS // units), MAX_THREADS // units))
    threads = -(-units * phases // 32) * 32

    def smem(tile, splits=1):
        return smem_bytes(kv_per_block, group, head_dim, itemsize, tile, splits, phases)

    pitch = kv_per_block * head_dim * itemsize + 16
    tile = 1
    while tile * 2 <= MAX_TILE_TOKENS and STAGES * 2 * tile * 2 * pitch <= _RING_BYTES:
        tile *= 2
    tile = max(1, min(tile, chunk_tokens))
    while smem(tile) > SMEM_LIMIT:
        tile -= 1
    tiles_per_chunk = -(-chunk_tokens // tile)
    capacity = n_chunks * tiles_per_chunk
    blocks = batch * (n_kv // kv_per_block) * capacity
    per_split = max(_MIN_TILES_PER_SPLIT, -(-blocks // _TARGET_BLOCKS))
    per_split = max(1, min(per_split, capacity))
    splits = max(1, -(-capacity // per_split))
    # the merge keeps (m, l) of every split in the ring: fewer, longer splits
    # where that would not fit
    while smem(tile, splits) > SMEM_LIMIT:
        per_split *= 2
        splits = max(1, -(-capacity // per_split))
    return AttentionPlan(kv_per_block, tile, min(group, MAX_HEAD_CHUNK), phases,
                         tiles_per_chunk, per_split, splits, threads, smem(tile, splits))


def tile_ranges(plan: AttentionPlan, chunk_tokens: int, seq_len: int, window: int = 0
                ) -> Iterator[Tuple[int, int, int, int]]:
    """The tiles the kernel reads for one sequence, as (split, chunk, first
    token in the chunk, token count); the kernel's ``tile_at`` walk. With a
    ``window`` the walk starts at the tile holding position ``seq_len -
    window`` and the splits count from there; the kernel masks that tile's
    positions before the window."""
    tile = plan.tile_tokens
    full, rem = divmod(seq_len, chunk_tokens)
    n_tiles = full * plan.tiles_per_chunk + -(-rem // tile)
    c_lo, r_lo = divmod(max(0, seq_len - window) if window > 0 else 0, chunk_tokens)
    j_lo = c_lo * plan.tiles_per_chunk + r_lo // tile
    for j in range(j_lo, n_tiles):
        c, r = divmod(j, plan.tiles_per_chunk)
        t0 = r * tile
        yield ((j - j_lo) // plan.tiles_per_split, c, t0,
               min(tile, chunk_tokens - t0, seq_len - c * chunk_tokens - t0))


class _Plan(ctypes.Structure):
    """``Plan`` in csrc/stitched_attention.cu, field for field."""
    _fields_ = (
        [(n, ctypes.c_int) for n in ("dtype", "B", "H", "KVH", "D", "T_c", "C", "n_phys")]
        + [("chunk_stride", ctypes.c_longlong)]
        + [(n, ctypes.c_int) for n in ("kv_per_block", "tile_tokens", "head_chunk", "phases",
                                       "tiles_per_split", "splits", "threads", "aligned",
                                       "smem_bytes")]
        + [("scale", ctypes.c_float), ("window", ctypes.c_int)]
    )


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("stitched_attention")
    lib.stitched_decode_attention.argtypes = [ctypes.c_void_p] * 11
    lib.stitched_decode_attention.restype = ctypes.c_int
    lib.empty_kernel_launch.argtypes = [ctypes.c_void_p]
    lib.empty_kernel_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def _launch_plan(dtype: torch.dtype, batch: int, n_heads: int, n_kv: int, head_dim: int,
                 chunk_tokens: int, n_chunks: int, n_phys: int, chunk_stride: int,
                 aligned: bool, scale: float, window: int) -> Tuple[AttentionPlan, _Plan]:
    plan = attention_plan(batch, n_heads, n_kv, head_dim, chunk_tokens, n_chunks,
                          dtype.itemsize)
    c_plan = _Plan(_DTYPE_CODE[dtype], batch, n_heads, n_kv, head_dim, chunk_tokens, n_chunks,
                   n_phys, chunk_stride, plan.kv_per_block, plan.tile_tokens, plan.head_chunk, plan.phases, plan.tiles_per_split, plan.splits,
                   plan.threads, int(aligned), plan.smem_bytes, scale, window)
    return plan, c_plan


#: per device: every (tickets, partials) workspace made so far, the newest
#: last. Tickets are zero between calls (the kernel resets the ones it
#: takes); calls on concurrent streams of one device must not run at once,
#: as they would share them. A workspace outgrown by a larger call is kept,
#: never freed: a CUDA graph captured earlier still launches on it.
_workspace: Dict[torch.device, List[Tuple[torch.Tensor, torch.Tensor]]] = {}


def _scratch(device: torch.device, n_tickets: int, n_partial: int):
    held = _workspace.setdefault(device, [])
    if held and held[-1][0].numel() >= n_tickets and held[-1][1].numel() >= n_partial:
        return held[-1]
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("stitched_decode_attention: the workspace must grow for this "
                           "geometry; make one call outside CUDA-graph capture first")
    least_t, least_p = ((2 * held[-1][0].numel(), 2 * held[-1][1].numel()) if held
                        else (1024, 1 << 16))
    held.append((torch.zeros(max(n_tickets, least_t), dtype=torch.int32, device=device),
                 torch.empty(max(n_partial, least_p), dtype=torch.float32, device=device)))
    return held[-1]


def _check_arena(x: torch.Tensor, name: str, q: torch.Tensor) -> None:
    if x.dim() != 4 or x.dtype != q.dtype or x.device != q.device:
        raise ValueError(f"{name} must be 4-D {q.dtype} on {q.device}, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    _, t_c, n_kv, d = x.shape
    if x.stride()[1:] != (n_kv * d, d, 1) or x.stride(0) < t_c * n_kv * d:
        raise ValueError(f"{name}: each chunk's (T_c, KVH, D) block must be contiguous, "
                         f"got strides {x.stride()}")


def _check_index(x: torch.Tensor, name: str, shape, q: torch.Tensor) -> None:
    if x.dtype != torch.int32 or x.shape != shape or not x.is_contiguous():
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
    window: int = 0,
) -> torch.Tensor:
    """Decode attention over the stitched KV arena. Returns (B, H, D) in q's dtype.

    K and V may live in the same arena buffer under different page tables
    (pass the buffer twice + ``page_table_v``), or in separate buffers under
    one shared table. Positions ``>= seq_lens[b]`` are masked, and with a
    ``window`` > 0 positions ``< seq_lens[b] - window`` too; a sequence of
    length 0 gives zeros. On the card D must be a multiple of 8.
    """
    if window < 0:
        raise ValueError(f"window must be 0 (none) or positive, got {window}")
    if q.device.type == "cpu":
        return stitched_decode_attention_ref(
            q, k_arena, v_arena, page_table, seq_lens, page_table_v, scale=scale, window=window
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
    chunk_stride = k_arena.stride(0)
    if v_arena.shape != k_arena.shape or v_arena.stride(0) != chunk_stride:
        raise ValueError("k_arena and v_arena must share shape and chunk stride")
    if head_dim_k != head_dim:
        raise ValueError(f"q has D={head_dim}, the arena D={head_dim_k}")
    n_chunks = page_table.shape[1] if page_table.dim() == 2 else -1
    table_shape = torch.Size((batch, n_chunks))
    _check_index(page_table, "page_table", table_shape, q)
    _check_index(page_table_v, "page_table_v", table_shape, q)
    _check_index(seq_lens, "seq_lens", torch.Size((batch,)), q)

    out = torch.empty_like(q)
    if batch == 0:
        return out
    aligned = ((k_arena.data_ptr() | v_arena.data_ptr()) % 16 == 0
               and chunk_stride * q.element_size() % 16 == 0)
    plan, c_plan = _launch_plan(
        q.dtype, batch, n_heads, n_kv, head_dim, chunk_tokens, n_chunks, n_phys, chunk_stride,
        aligned, (head_dim**-0.5) if scale is None else float(scale), int(window))
    n_groups = n_kv // plan.kv_per_block
    tickets, partials = _scratch(
        q.device, batch * n_groups,
        batch * n_groups * plan.splits * (n_heads // n_groups) * (head_dim + 2))
    args = (ctypes.addressof(c_plan), q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
            page_table.data_ptr(), page_table_v.data_ptr(), seq_lens.data_ptr(),
            out.data_ptr(), tickets.data_ptr(), partials.data_ptr())
    if q.device.index == torch.cuda.current_device():
        err = _lib().stitched_decode_attention(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(q.device):
            err = _lib().stitched_decode_attention(
                *args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"stitched_decode_attention kernel launch failed: CUDA error {err}")
    stitched_decode_attention.launches += 1
    return out


stitched_decode_attention.launches = 0


def empty_kernel() -> None:
    """Launch an empty kernel on the current stream: the floor of one launch."""
    err = _lib().empty_kernel_launch(torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")
