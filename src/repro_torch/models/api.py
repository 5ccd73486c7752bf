"""Uniform model API: each family exposes the same entry points.

Counterpart of ``repro.models.api``, with all six of its families; the
launchers, the train step and the serving engine go through
``family_of(cfg)``. ``param_axes`` and ``cache_axes`` name every leaf's
dims for the sharding rules (``repro_torch.parallel.sharding``);
``param_shapes`` gives a config's param tree as meta tensors. Every
family's ``prefill`` and ``decode_step`` is a ``model.prefill`` /
``model.decode`` span (``utils/tracing.py``): the host's dispatch of the
step, since neither waits for the device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict

import torch

from ..utils.tracing import spanned
from . import layers as L
from . import moe, paligemma, rwkv6, transformer, whisper, zamba2


@dataclass(frozen=True)
class Family:
    name: str
    init_params: Callable
    param_axes: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable
    cache_axes: Callable


FAMILIES: Dict[str, Family] = {
    "dense": Family(
        "dense", transformer.init_params, transformer.param_axes, transformer.loss_fn,
        transformer.prefill, transformer.decode_step, transformer.init_cache,
        transformer.cache_axes,
    ),
    "moe": Family(
        "moe", moe.init_params, moe.param_axes, moe.loss_fn, moe.prefill, moe.decode_step,
        moe.init_cache, transformer.cache_axes,
    ),
    "hybrid": Family(
        "hybrid", zamba2.init_params, zamba2.param_axes, zamba2.loss_fn, zamba2.prefill,
        zamba2.decode_step, zamba2.init_cache, zamba2.cache_axes,
    ),
    "ssm": Family(
        "ssm", rwkv6.init_params, rwkv6.param_axes, rwkv6.loss_fn, rwkv6.prefill,
        rwkv6.decode_step, rwkv6.init_cache, rwkv6.cache_axes,
    ),
    "audio": Family(
        "audio", whisper.init_params, whisper.param_axes, whisper.loss_fn, whisper.prefill,
        whisper.decode_step, whisper.init_cache, whisper.cache_axes,
    ),
    "vlm": Family(
        "vlm", paligemma.init_params, paligemma.param_axes, paligemma.loss_fn,
        paligemma.prefill, paligemma.decode_step, paligemma.init_cache,
        paligemma.cache_axes,
    ),
}
FAMILIES = {k: dataclasses.replace(f, prefill=spanned("model.prefill")(f.prefill),
                                   decode_step=spanned("model.decode")(f.decode_step))
            for k, f in FAMILIES.items()}


def param_shapes(cfg) -> Dict:
    """The param tree of ``cfg`` as meta tensors (shapes and dtypes, no
    memory and no draws), for the sharding rules at full size."""
    with L.meta_init():
        return family_of(cfg).init_params(cfg, torch.Generator(), "meta")


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
