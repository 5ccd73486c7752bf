"""The yardstick's arithmetic: the H100's peaks and the operations and
bytes that a model's work needs, from its configuration and shapes alone.

Peaks are NVIDIA's datasheet figures for the H100 SXM 80 GB at 700 W,
dense, without sparsity (the same figures as the program's
``utils/roofline.py``, frozen here so a change to the program cannot move
them). Model FLOPs count each multiply-add of a matmul as two operations
and leave out recomputation, norms and elementwise work; attention counts
the score and value products over the positions a query can see. What
depends on a family's shapes is counted in ``harness/families/<family>.py``
from these parts.
"""

from __future__ import annotations

from typing import Dict

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def head_dim(m: Dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def attn_proj(m: Dict) -> int:
    """Weights of q, k, v and o in one attention block."""
    d, h, kv, dh = m["d_model"], m["n_heads"], m["n_kv"], head_dim(m)
    return 2 * d * h * dh + 2 * d * kv * dh


def mlp(m: Dict) -> int:
    """Weights of one MLP of width ``d_ff`` (three matrices where gated)."""
    return m["d_model"] * m["d_ff"] * (3 if m.get("gated") else 2)


def causal_attn_flops(m: Dict, s: int) -> float:
    """Forward score and value products of one causal layer over s positions."""
    return 2.0 * m["n_heads"] * head_dim(m) * s * (s + 1)


def full_attn_flops(m: Dict, sq: int, skv: int) -> float:
    return 4.0 * m["n_heads"] * head_dim(m) * sq * skv


def decode_step_least_s(fam, weight_bytes: int, m: Dict, contexts, itemsize: int = 2) -> float:
    """Least time of one decode step of a model of family ``fam`` (its
    module under ``harness/families``): the larger of its bytes (every
    weight read once, each running sequence's valid K and V read once) over
    HBM bandwidth and its FLOPs over the bf16 peak."""
    kv = fam.kv_bytes_per_token(m, itemsize) * sum(contexts)
    flops = sum(fam.decode_token_flops(m, c) for c in contexts)
    return max((weight_bytes + kv) / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)
