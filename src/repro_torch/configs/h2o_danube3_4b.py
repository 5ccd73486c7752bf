"""h2o-danube-3-4b [dense] — llama+mistral mix, SWA [arXiv:2401.16818]."""
import torch
from ..models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="h2o-danube-3-4b", n_layers=24, d_model=3840, n_heads=32, n_kv=8,
    d_ff=10240, vocab=32000, norm="rmsnorm", act="silu", gated=True,
    rope_theta=1e4, window=4096, tie_embeddings=True, dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="danube3-smoke", n_layers=2, d_model=128, n_heads=8, n_kv=4,
    d_ff=256, vocab=512, norm="rmsnorm", act="silu", gated=True,
    window=32, dtype=torch.float32, remat=False,
)
