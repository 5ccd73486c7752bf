"""The four dry-run input shapes, and meta-tensor stand-ins for every
model input of a (config, shape) cell.

Counterpart of ``repro.configs.shapes``. Four shapes per architecture:

  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> prefill
  decode_32k   seq 32,768  global_batch 128   -> serve_step (1 new token,
                                                 KV cache of seq_len)
  long_500k    seq 524,288 global_batch 1     -> serve_step; only for
                                                 sub-quadratic archs (SWA /
                                                 hybrid / SSM), else SKIP

Where the reference returns ``ShapeDtypeStruct``s, these return tensors on
the ``meta`` device: shape and dtype, no memory. For [vlm]/[audio] the
modality frontend is a stub: the specs carry precomputed patch/frame
embeddings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from ..models import paligemma, rwkv6, transformer, whisper, zamba2
from ..models.api import family_of


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

#: decoder-prompt fraction of seq_len for enc-dec prefill
AUDIO_DEC_FRACTION = 8


def supports_long_context(cfg) -> bool:
    """long_500k runs only for sub-quadratic attention."""
    if isinstance(cfg, (rwkv6.RWKV6Config, zamba2.Zamba2Config)):
        return True
    if isinstance(cfg, transformer.TransformerConfig) and cfg.window is not None:
        return True  # sliding-window attention
    return False


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def token_batch_specs(cfg, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Model inputs for the train/prefill paths (tokens + modality stubs)."""
    b, s = shape.global_batch, shape.seq_len
    if isinstance(cfg, paligemma.PaliGemmaConfig):
        p = cfg.n_patches
        return {"patch_embeds": _meta((b, p, cfg.d_model), cfg.dtype),
                "tokens": _meta((b, s - p), torch.int32)}
    if isinstance(cfg, whisper.WhisperConfig):
        toks = s if shape.kind == "train" else max(s // AUDIO_DEC_FRACTION, 64)
        return {"frames": _meta((b, s, cfg.d_model), cfg.dtype),
                "tokens": _meta((b, toks), torch.int32)}
    return {"tokens": _meta((b, s), torch.int32)}


def cache_specs(cfg, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """The serve cache of a decode shape, built by the family's
    ``init_cache`` on the meta device."""
    fam = family_of(cfg)
    b, s = shape.global_batch, shape.seq_len
    if isinstance(cfg, whisper.WhisperConfig):
        return fam.init_cache(cfg, b, s, s, device="meta")
    if isinstance(cfg, rwkv6.RWKV6Config):
        return fam.init_cache(cfg, b, device="meta")  # O(1) state
    return fam.init_cache(cfg, b, s, device="meta")


def decode_token_specs(shape: ShapeSpec) -> torch.Tensor:
    return _meta((shape.global_batch,), torch.int32)
