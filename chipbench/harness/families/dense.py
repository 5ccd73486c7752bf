"""The dense decoder-only LM (``family: dense``): training FLOPs, serving
FLOPs and KV bytes, and its training batches."""

from __future__ import annotations

from typing import Dict

import torch

from ..flops import attn_proj, causal_attn_flops, head_dim, mlp
from . import known_keys

KEYS = ("n_layers", "d_model", "n_heads", "n_kv", "head_dim", "d_ff", "gated", "vocab",
        "norm", "act", "rope_theta", "tie_embeddings", "dtype", "remat")


def _checked(m: Dict) -> Dict:
    known_keys("dense", m, KEYS)
    return m


def layer_weights(m: Dict) -> int:
    return attn_proj(_checked(m)) + mlp(m)


def train_step_flops(m: Dict, mix: Dict) -> float:
    """Model FLOPs of one training step (forward and backward, 3x forward);
    the head predicts ``seq - 1`` positions a row."""
    s, L = mix["seq"], m["n_layers"]
    fwd = 2.0 * L * layer_weights(m) * s + L * causal_attn_flops(m, s)
    fwd += 2.0 * m["d_model"] * m["vocab"] * (s - 1)
    return 3.0 * mix["batch"] * fwd


def positions_per_row(mix: Dict) -> int:
    return mix["seq"]


def train_batch(mix: Dict, m: Dict, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """``seq`` token ids a row; the loss predicts the last ``seq - 1``."""
    return {"tokens": torch.randint(0, m["vocab"], (mix["batch"], mix["seq"]), generator=g,
                                    dtype=torch.int64, device=device).to(torch.int32)}


def prefill_flops(m: Dict, p: int) -> float:
    """A prefill of p tokens; the head runs on the last one."""
    return (2.0 * m["n_layers"] * layer_weights(m) * p
            + m["n_layers"] * causal_attn_flops(m, p) + 2.0 * m["d_model"] * m["vocab"])


def decode_token_flops(m: Dict, ctx: int) -> float:
    """One decoded token that attends over ``ctx`` positions (itself included)."""
    return (2.0 * (m["n_layers"] * layer_weights(m) + m["d_model"] * m["vocab"])
            + m["n_layers"] * 4.0 * m["n_heads"] * head_dim(m) * ctx)


def kv_bytes_per_token(m: Dict, itemsize: int = 2) -> int:
    return _checked(m)["n_layers"] * 2 * m["n_kv"] * head_dim(m) * itemsize
