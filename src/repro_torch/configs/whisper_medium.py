"""whisper-medium [audio] — enc-dec, conv frontend stub [arXiv:2212.04356]."""
import torch

from ..models.whisper import WhisperConfig

FULL = WhisperConfig(
    name="whisper-medium", n_layers=24, d_model=1024, n_heads=16, n_kv=16,
    d_ff=4096, vocab=51865, max_positions=65536, dtype=torch.bfloat16,
)

SMOKE = WhisperConfig(
    name="whisper-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=4,
    d_ff=128, vocab=512, max_positions=128, dtype=torch.float32, remat=False,
)
