"""starcoder2-15b [dense] — GQA kv=4, RoPE, layernorm [arXiv:2402.19173; hf]."""
import torch
from ..models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="starcoder2-15b", n_layers=40, d_model=6144, n_heads=48, n_kv=4,
    d_ff=24576, vocab=49152, norm="layernorm", act="gelu", gated=False,
    rope_theta=1e5, tie_embeddings=True, dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="starcoder2-smoke", n_layers=2, d_model=128, n_heads=8, n_kv=2,
    d_ff=256, vocab=512, norm="layernorm", act="gelu", gated=False,
    dtype=torch.float32, remat=False,
)
