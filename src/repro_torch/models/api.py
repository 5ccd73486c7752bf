"""Uniform model API: each family exposes the same entry points.

Counterpart of ``repro.models.api``; the launcher and the serving engine go
through ``family_of(cfg)``. Only the dense family is ported so far.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

from . import transformer


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
}


def family_of(cfg) -> Family:
    if isinstance(cfg, transformer.TransformerConfig):
        return FAMILIES["dense"]
    raise TypeError(f"unknown model config type {type(cfg)}")
