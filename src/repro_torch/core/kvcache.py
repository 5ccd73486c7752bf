"""StitchedKVCache: per-sequence KV history backed by the GMLake arena.

The serving-side integration of the paper's technique. vLLM pages KV into
small fixed blocks and pays a table indirection per block; GMLake-style
stitching instead hands each sequence *variable-size* blocks (whole
allocations that grow geometrically), so the page table stays short and the
attention kernel walks long physically-contiguous extents.

Token layout: one 2 MB chunk holds ``chunk_tokens = CHUNK_SIZE //
(n_kv * head_dim * itemsize)`` tokens of K (or V) for ONE layer. K and V of
every layer share the single arena (one memory lake), each with its own
allocation per sequence.

Counterpart of ``repro.core.kvcache``. Where a token row does not divide
2 MB (smollm-135m: n_kv=3, head_dim=64, bf16 -> 384-byte rows, 5461 tokens
and 256 spare bytes per chunk), the token view uses the first
``chunk_tokens * n_kv * head_dim`` elements of each chunk and leaves the
tail unused; wherever the row does divide 2 MB this is the reference's
layout exactly. (The reference reshapes the whole chunk and raises there.)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..alloc.caching_allocator import Allocation
from ..alloc.chunks import CHUNK_SIZE
from ..device import DeviceLike
from ..kernels import ops
from .arena import Arena, ArenaConfig
from .trace import TraceRecorder


@dataclass(frozen=True)
class KVCacheConfig:
    n_layers: int
    n_kv: int
    head_dim: int
    dtype: torch.dtype = torch.bfloat16
    n_chunks: int = 1024
    #: new allocations grow by at least this fraction of current capacity
    growth: float = 0.5
    device: DeviceLike = "cuda"

    @property
    def itemsize(self) -> int:
        return self.dtype.itemsize

    @property
    def token_bytes(self) -> int:
        return self.n_kv * self.head_dim * self.itemsize

    @property
    def chunk_tokens(self) -> int:
        ct = CHUNK_SIZE // self.token_bytes
        assert ct > 0, "a KV token row must fit in one chunk"
        return ct


@dataclass
class _SeqState:
    length: int = 0
    capacity_tokens: int = 0
    # one allocation list per (layer, k|v); growth appends allocations and
    # their extents concatenate into the logical block — the stitch.
    allocs: Dict[Tuple[int, str], List[Allocation]] = field(default_factory=dict)


class StitchedKVCache:
    def __init__(
        self,
        config: KVCacheConfig,
        recorder: Optional[TraceRecorder] = None,
        allocator=None,
    ):
        """``allocator``: any ``repro_torch.alloc`` registry key or backend
        instance, forwarded to the ``Arena`` (default gmlake). Device-side
        access paths need an extent-carrying (stitching) backend; pure
        accounting runs work with any."""
        self.config = config
        self.arena = Arena(
            ArenaConfig(n_chunks=config.n_chunks, dtype=config.dtype, device=config.device),
            allocator=allocator,
            recorder=recorder,
        )
        self.seqs: Dict[int, _SeqState] = {}

    # ------------------------------------------------------------------
    # host-side sequence management
    # ------------------------------------------------------------------
    def add_sequence(self, seq_id: int, n_tokens: int) -> None:
        assert seq_id not in self.seqs
        state = _SeqState()
        self.seqs[seq_id] = state
        self._grow_to(state, n_tokens)
        state.length = n_tokens

    def append_tokens(self, seq_id: int, n: int = 1) -> None:
        state = self.seqs[seq_id]
        if state.length + n > state.capacity_tokens:
            want = max(
                state.length + n,
                int(state.capacity_tokens * (1.0 + self.config.growth)),
            )
            self._grow_to(state, want)
        state.length += n

    def free_sequence(self, seq_id: int) -> None:
        state = self.seqs.pop(seq_id)
        for allocs in state.allocs.values():
            for a in allocs:
                self.arena.free(a)

    def _grow_to(self, state: _SeqState, n_tokens: int) -> None:
        c = self.config
        need_chunks = -(-n_tokens // c.chunk_tokens)
        have_chunks = state.capacity_tokens // c.chunk_tokens
        if need_chunks <= have_chunks:
            return
        delta = (need_chunks - have_chunks) * CHUNK_SIZE
        for layer in range(c.n_layers):
            for kv in ("k", "v"):
                key = (layer, kv)
                state.allocs.setdefault(key, []).append(
                    self.arena.alloc_elems(delta // c.itemsize, f"kv.{kv}.L{layer}")
                )
        state.capacity_tokens = need_chunks * c.chunk_tokens

    # ------------------------------------------------------------------
    # device-side access
    # ------------------------------------------------------------------
    def _extent_chunks(self, seq_id: int, layer: int, kv: str) -> List[int]:
        self.arena.require_stitching()
        out: List[int] = []
        for a in self.seqs[seq_id].allocs[(layer, kv)]:
            for e in a.block.extents:
                out.extend(range(e.start, e.stop))
        return out

    def page_table(
        self, seq_ids: List[int], layer: int, kv: str, pad_chunks: Optional[int] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, C) physical-chunk table + (B,) seq lengths for the kernels,
        int32 on the arena's device. Padding entries are chunk 0; the
        kernels never read them because they mask by sequence length."""
        rows = [self._extent_chunks(s, layer, kv) for s in seq_ids]
        width = pad_chunks or max(len(r) for r in rows)
        table = np.zeros((len(rows), width), np.int32)
        for i, r in enumerate(rows):
            assert len(r) <= width
            table[i, : len(r)] = r
        if table.size and not (0 <= table.min() and table.max() < self.config.n_chunks):
            raise ValueError(f"page table ids outside the arena's {self.config.n_chunks} chunks")
        lens = np.array([self.seqs[s].length for s in seq_ids], np.int32)
        dev = self.arena.device
        return torch.from_numpy(table).to(dev), torch.from_numpy(lens).to(dev)

    def arena_view(self) -> torch.Tensor:
        """The arena buffer viewed token-structured, (n_chunks, T_c, KVH, D):
        a strided view of the same storage over the first ``T_c * KVH * D``
        elements of every chunk."""
        c = self.config
        used = c.chunk_tokens * c.n_kv * c.head_dim
        return self.arena.buf[:, :used].unflatten(1, (c.chunk_tokens, c.n_kv, c.head_dim))

    def write_tokens(
        self, seq_id: int, layer: int, kv: str, start: int, tokens: torch.Tensor
    ) -> None:
        """Write ``tokens`` (T, KVH, D) at logical position ``start``, in place."""
        c = self.config
        chunks = self._extent_chunks(seq_id, layer, kv)
        view = self.arena_view()
        t = tokens.to(device=self.arena.device, dtype=c.dtype)
        # split the logical token range on chunk boundaries, one copy per run
        pos = start
        off = 0
        while off < t.shape[0]:
            chunk_idx = pos // c.chunk_tokens
            in_chunk = pos % c.chunk_tokens
            run = min(t.shape[0] - off, c.chunk_tokens - in_chunk)
            view[chunks[chunk_idx], in_chunk : in_chunk + run] = t[off : off + run]
            pos += run
            off += run

    def decode_attention(self, seq_ids: List[int], layer: int, q: torch.Tensor) -> torch.Tensor:
        """q: (B, H, D) one token per sequence -> (B, H, D).

        K and V share the arena buffer; each carries its own page table.
        """
        ptk, lens = self.page_table(seq_ids, layer, "k")
        ptv, _ = self.page_table(seq_ids, layer, "v", pad_chunks=ptk.shape[1])
        view = self.arena_view()
        return ops.decode_attention(q, view, view, ptk, lens, page_table_v=ptv)

    # ------------------------------------------------------------------
    def utilization(self) -> float:
        return self.arena.utilization
