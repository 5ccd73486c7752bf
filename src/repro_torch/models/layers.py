"""Shared neural-net layers (plain functions over tensors and param dicts).

Counterpart of the dense subset of ``repro.models.layers``, in the JAX
package's layouts: activations ``(B, S, H, D)``, per-layer weights stacked
on a leading ``layers`` axis. Precision follows the reference: norms and
softmax statistics in float32, products of low-precision inputs summed in
float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# initialisers / norms / activations
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights drawn on the CPU from ``generator`` (so a
    seed gives the same weights whatever device they are moved to)."""
    fan_in = shape[in_axis]
    w = torch.randn(shape, generator=generator, dtype=torch.float32)
    return (w * (1.0 / math.sqrt(fan_in))).to(dtype)


def rmsnorm(x, scale, eps: float = 1e-6):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layernorm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


ACTIVATIONS: dict = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "relu": F.relu,
    "sqrelu": lambda x: F.relu(x).square(),
}


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_angles(positions, head_dim: int, theta: float = 10000.0):
    """positions (...,) -> cos/sin (..., head_dim//2)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device)
                      / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta: float = 10000.0):
    """x (..., S, H, D); positions broadcastable to (..., S)."""
    cos, sin = rope_angles(positions, x.shape[-1], theta)  # (..., S, D/2)
    cos, sin = cos[..., None, :], sin[..., None, :]  # head axis
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _expand_kv(k, n_heads: int):
    """(B, S, KVH, D) -> (B, S, H, D) by repeating each kv head."""
    n_kv = k.shape[2]
    if n_kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // n_kv, dim=2)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KVH, D)
    v: torch.Tensor,  # (B, Skv, KVH, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,  # sliding-window size (SWA)
    prefix_len=None,  # int or (B,) tensor: bidirectional prefix (prefix-LM)
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked softmax attention, forward only: the function the JAX package's
    blocked flash attention computes, written plainly (one score matrix per
    call; prompts on the serving path are short). The backward pass comes
    with the training path."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    scale = (d**-0.5) if scale is None else scale
    kf, vf = _expand_kv(k, h), _expand_kv(v, h)
    s = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), kf.float())
    q_pos = q_offset + torch.arange(sq, device=q.device)
    kv_pos = torch.arange(skv, device=q.device)
    vis = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        vis = kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        vis = vis & (kv_pos[None, :] > (q_pos[:, None] - window))
    if prefix_len is not None:
        pl = torch.as_tensor(prefix_len, device=q.device)
        if pl.dim():  # (B,) per-sequence prefix
            vis = (vis[None] | (kv_pos[None, None, :] < pl[:, None, None]))[:, None]
        else:
            vis = vis | (kv_pos[None, :] < pl)
    s = s.masked_fill(~vis, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vf.float())
    return o.to(q.dtype)


def decode_attention_dense(
    q: torch.Tensor,  # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, S, KVH, D)
    v_cache: torch.Tensor,  # (B, S, KVH, D)
    lengths: torch.Tensor,  # (B,) valid tokens in cache (new token included)
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode over a dense KV cache (serve_step path)."""
    b, _, h, d = q.shape
    s = k_cache.shape[1]
    scale = (d**-0.5) if scale is None else scale
    kf = _expand_kv(k_cache, h)
    vf = _expand_kv(v_cache, h)
    logits = torch.einsum("bqhd,bshd->bhqs", (q * scale).float(), kf.float())
    pos = torch.arange(s, device=q.device)[None, :]
    valid = pos < lengths.long()[:, None]
    if window is not None:
        valid = valid & (pos > (lengths.long()[:, None] - 1 - window))
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", p.float(), vf.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_apply(params: dict, x: torch.Tensor, act: str = "gelu", gated: bool = False):
    a = ACTIVATIONS[act]
    h = x @ params["wi"]
    if gated:
        h = a(x @ params["wg"]) * h
    else:
        h = a(h)
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# cross-entropy
# ---------------------------------------------------------------------------


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor, mask=None) -> torch.Tensor:
    """logits (..., V) float, targets (...) int -> mean xent."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
