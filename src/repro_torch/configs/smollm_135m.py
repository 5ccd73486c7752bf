"""smollm-135m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""
import torch

from ..models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="smollm-135m", n_layers=30, d_model=576, n_heads=9, n_kv=3,
    d_ff=1536, vocab=49152, norm="rmsnorm", act="silu", gated=True,
    rope_theta=1e4, tie_embeddings=True, dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="smollm-smoke", n_layers=3, d_model=96, n_heads=3, n_kv=1,
    d_ff=192, vocab=512, norm="rmsnorm", act="silu", gated=True,
    dtype=torch.float32, remat=False,
)
