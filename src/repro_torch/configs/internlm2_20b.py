"""internlm2-20b [dense] — GQA kv=8 [arXiv:2403.17297; hf]."""
import torch
from ..models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="internlm2-20b", n_layers=48, d_model=6144, n_heads=48, n_kv=8,
    d_ff=16384, vocab=92544, norm="rmsnorm", act="silu", gated=True,
    rope_theta=1e6, tie_embeddings=True, dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="internlm2-smoke", n_layers=2, d_model=128, n_heads=8, n_kv=2,
    d_ff=256, vocab=512, norm="rmsnorm", act="silu", gated=True,
    dtype=torch.float32, remat=False,
)
