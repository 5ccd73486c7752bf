"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1]."""
import torch
from ..models.moe import MoEConfig

FULL = MoEConfig(
    name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48, n_kv=8,
    d_ff=32768, vocab=131072, norm="rmsnorm", act="gelu", gated=False,
    rope_theta=1e4, tie_embeddings=True, dtype=torch.bfloat16,
    n_experts=8, top_k=2, capacity_factor=1.25,
    # expert-TP: 8 experts x 2 ff-shards = 16 virtual experts
    expert_shards=2,
    # local routing + all-to-all dispatch: needs a mesh (the parallelism
    # port); on one device the dispatch is global, as the reference's
    a2a_dispatch=True,
)

SMOKE = MoEConfig(
    name="grok1-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
    d_ff=128, vocab=512, act="gelu", gated=False, dtype=torch.float32,
    n_experts=4, top_k=2, capacity_factor=2.0, remat=False,
)
