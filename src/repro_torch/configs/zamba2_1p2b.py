"""zamba2-1.2b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242]."""
import torch

from ..models.zamba2 import Zamba2Config

FULL = Zamba2Config(
    name="zamba2-1.2b", n_layers=38, d_model=2048, n_heads=32, n_kv=32,
    d_ff=8192, vocab=32000, d_state=64, attn_every=6, dtype=torch.bfloat16,
)

SMOKE = Zamba2Config(
    name="zamba2-smoke", n_layers=5, d_model=64, n_heads=4, n_kv=4,
    d_ff=128, vocab=512, d_state=16, attn_every=2, chunk=8,
    dtype=torch.float32, remat=False,
)
