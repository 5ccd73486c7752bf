"""The encoder-decoder speech model (``family: audio``, Whisper): training
FLOPs and its training batches. It is not served here, so it has no
serving counts."""

from __future__ import annotations

from typing import Dict

import torch

from ..flops import attn_proj, causal_attn_flops, full_attn_flops, head_dim, mlp
from . import known_keys

KEYS = ("n_layers", "d_model", "n_heads", "n_kv", "head_dim", "d_ff", "vocab",
        "max_positions", "act", "dtype", "remat")


def train_step_flops(m: Dict, mix: Dict) -> float:
    """Model FLOPs of one training step (3x forward): ``n_layers`` encoder
    layers over ``frames`` with full attention, as many decoder layers over
    ``seq`` tokens with causal self-attention and cross-attention to the
    frames, and the head on every token."""
    known_keys("audio", m, KEYS)
    d, L, s, f = m["d_model"], m["n_layers"], mix["seq"], mix["frames"]
    q_o = 2 * d * m["n_heads"] * head_dim(m)
    k_v = attn_proj(m) - q_o
    enc = L * (2.0 * (attn_proj(m) + mlp(m)) * f + full_attn_flops(m, f, f))
    dec = L * (2.0 * (attn_proj(m) + q_o + mlp(m)) * s + 2.0 * k_v * f
               + causal_attn_flops(m, s) + full_attn_flops(m, s, f))
    return 3.0 * mix["batch"] * (enc + dec + 2.0 * d * m["vocab"] * s)


def positions_per_row(mix: Dict) -> int:
    """Decoder tokens and encoder frames."""
    return mix["seq"] + mix["frames"]


def train_batch(mix: Dict, m: Dict, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """``seq + 1`` token ids a row (the decoder reads ``seq`` and predicts
    ``seq``) and ``frames`` standard-normal frame embeddings in the model's
    dtype."""
    b = mix["batch"]
    tokens = torch.randint(0, m["vocab"], (b, mix["seq"] + 1), generator=g,
                           dtype=torch.int64, device=device).to(torch.int32)
    frames = torch.randn((b, mix["frames"], m["d_model"]), generator=g, dtype=torch.float32,
                         device=device).to(getattr(torch, m["dtype"]))
    return {"tokens": tokens, "frames": frames}
