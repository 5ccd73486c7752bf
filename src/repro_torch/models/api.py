"""Uniform model API: each family exposes the same entry points.

Counterpart of ``repro.models.api``; the launchers, the train step and the
serving engine go through ``family_of(cfg)``. The dense, moe and vlm
families are ported; the hybrid (zamba2), ssm (rwkv6) and audio (whisper)
families wait for later slices, and ``param_axes`` for the parallelism
port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

from . import moe, paligemma, transformer


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
    raise TypeError(f"unknown model config type {type(cfg)}")
