"""paligemma-3b [vlm] — SigLIP (stub) + gemma backbone [arXiv:2407.07726]."""
import torch
from ..models.paligemma import make_config

FULL = make_config(
    "paligemma-3b", n_layers=18, d_model=2048, n_heads=8, n_kv=1,
    head_dim=256, d_ff=16384, vocab=257216, rope_theta=1e4,
    dtype=torch.bfloat16, n_patches=256,
)

SMOKE = make_config(
    "paligemma-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=1,
    d_ff=128, vocab=512, dtype=torch.float32, remat=False, n_patches=16,
)
