"""Plain PyTorch versions of every stitch kernel (the correctness contract).

Counterparts of ``repro.kernels.ref``. The kernel wrappers take these for
tensors on the CPU; on the card they are what ``chip_smoke.py`` holds each
CUDA kernel against.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def stitch_gather_ref(arena: torch.Tensor, chunk_map: torch.Tensor) -> torch.Tensor:
    """out[i] = arena[chunk_map[i]]"""
    return arena[chunk_map.long()]


def stitch_scatter_ref(
    arena: torch.Tensor, chunk_map: torch.Tensor, values: torch.Tensor
) -> torch.Tensor:
    """arena[chunk_map[i]] = values[i], in place; returns ``arena``."""
    arena[chunk_map.long()] = values
    return arena


def stitched_decode_attention_ref(
    q: torch.Tensor,  # (B, H, D)
    k_arena: torch.Tensor,  # (n_phys, T_c, KVH, D)
    v_arena: torch.Tensor,  # (n_phys, T_c, KVH, D)
    page_table: torch.Tensor,  # (B, C) int32
    seq_lens: torch.Tensor,  # (B,) int32
    page_table_v: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Gather-then-softmax reference for the stitched decode attention."""
    batch, n_heads, head_dim = q.shape
    _, chunk_tokens, n_kv, _ = k_arena.shape
    group = n_heads // n_kv
    n_chunks = page_table.shape[1]
    scale = (head_dim**-0.5) if scale is None else scale
    if page_table_v is None:
        page_table_v = page_table

    # materialise each sequence's logical KV: (B, C*T_c, KVH, D)
    k = k_arena[page_table.long()].reshape(batch, n_chunks * chunk_tokens, n_kv, head_dim)
    v = v_arena[page_table_v.long()].reshape(batch, n_chunks * chunk_tokens, n_kv, head_dim)
    pos = torch.arange(n_chunks * chunk_tokens, device=q.device)[None, :]
    masked = ~(pos < seq_lens.long()[:, None])[:, None, None, :]  # (B, 1, 1, T)

    qg = (q * scale).reshape(batch, n_kv, group, head_dim).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()).masked_fill(masked, NEG_INF)
    p = torch.softmax(s, dim=-1).masked_fill(masked, 0.0)
    o = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return o.reshape(batch, n_heads, head_dim).to(q.dtype)
