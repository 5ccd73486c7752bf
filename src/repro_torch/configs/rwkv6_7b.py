"""rwkv6-7b [ssm] — Finch, data-dependent decay [arXiv:2404.05892; hf]."""
import torch

from ..models.rwkv6 import RWKV6Config

FULL = RWKV6Config(
    name="rwkv6-7b", n_layers=32, d_model=4096, d_ff=14336, vocab=65536,
    head_size=64, dtype=torch.bfloat16,
)

SMOKE = RWKV6Config(
    name="rwkv6-smoke", n_layers=2, d_model=64, d_ff=128, vocab=512,
    head_size=16, decay_lora=8, chunk=8, dtype=torch.float32, remat=False,
)
