"""Uniform model API: each family exposes the same entry points.

Counterpart of ``repro.models.api``, with all six of its families; the
launchers, the train step and the serving engine go through
``family_of(cfg)``. ``param_axes`` and ``cache_axes`` wait for the
parallelism port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

from . import moe, paligemma, rwkv6, transformer, whisper, zamba2


@dataclass(frozen=True)
class Family:
    name: str
    init_params: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


FAMILIES: Dict[str, Family] = {
    "dense": Family(
        "dense", transformer.init_params, transformer.loss_fn, transformer.prefill,
        transformer.decode_step, transformer.init_cache,
    ),
    "moe": Family(
        "moe", moe.init_params, moe.loss_fn, moe.prefill, moe.decode_step, moe.init_cache,
    ),
    "hybrid": Family(
        "hybrid", zamba2.init_params, zamba2.loss_fn, zamba2.prefill, zamba2.decode_step,
        zamba2.init_cache,
    ),
    "ssm": Family(
        "ssm", rwkv6.init_params, rwkv6.loss_fn, rwkv6.prefill, rwkv6.decode_step,
        rwkv6.init_cache,
    ),
    "audio": Family(
        "audio", whisper.init_params, whisper.loss_fn, whisper.prefill, whisper.decode_step,
        whisper.init_cache,
    ),
    "vlm": Family(
        "vlm", paligemma.init_params, paligemma.loss_fn, paligemma.prefill,
        paligemma.decode_step, paligemma.init_cache,
    ),
}


def family_of(cfg) -> Family:
    if isinstance(cfg, paligemma.PaliGemmaConfig):
        return FAMILIES["vlm"]
    if isinstance(cfg, moe.MoEConfig):
        return FAMILIES["moe"]
    if isinstance(cfg, transformer.TransformerConfig):
        return FAMILIES["dense"]
    if isinstance(cfg, zamba2.Zamba2Config):
        return FAMILIES["hybrid"]
    if isinstance(cfg, rwkv6.RWKV6Config):
        return FAMILIES["ssm"]
    if isinstance(cfg, whisper.WhisperConfig):
        return FAMILIES["audio"]
    raise TypeError(f"unknown model config type {type(cfg)}")
