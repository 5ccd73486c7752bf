"""dbrx-132b [moe] — 16 experts top-4, fine-grained [hf:databricks/dbrx-base]."""
import torch
from ..models.moe import MoEConfig

FULL = MoEConfig(
    name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48, n_kv=8,
    d_ff=10752, vocab=100352, norm="rmsnorm", act="silu", gated=True,
    rope_theta=5e5, tie_embeddings=True, dtype=torch.bfloat16,
    n_experts=16, top_k=4, capacity_factor=1.25,
    # local routing + all-to-all dispatch: needs a mesh (the parallelism
    # port); on one device the dispatch is global, as the reference's
    a2a_dispatch=True,
)

SMOKE = MoEConfig(
    name="dbrx-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
    d_ff=96, vocab=512, act="silu", gated=True, dtype=torch.float32,
    n_experts=4, top_k=2, capacity_factor=2.0, remat=False,
)
