"""Architecture registry: ``--arch <id>`` resolves here.

Each entry carries the full published config, a reduced smoke config of
the same family, and the reference's per-arch distribution settings (ZeRO
sharding, sequence parallelism, microbatches, optimizer dtype) as data.
The train launcher reads ``zero`` (the state's ZeRO sharding), as the
reference's does; the dry run (``launch/dryrun.py``) reads them all.
Counterpart of ``repro.configs``: all ten architectures, in its order, and
``cells()``, every (arch x shape) cell of the dry run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

from . import (
    dbrx_132b,
    grok1_314b,
    h2o_danube3_4b,
    internlm2_20b,
    paligemma_3b,
    rwkv6_7b,
    smollm_135m,
    starcoder2_15b,
    whisper_medium,
    zamba2_1p2b,
)
from .shapes import SHAPES, ShapeSpec, supports_long_context


@dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    full: Any
    smoke: Any
    #: ZeRO-1: shard optimizer state over 'data'
    zero: bool = False
    #: ZeRO-3: also shard parameters over 'data'
    zero_params: bool = False
    #: sequence parallelism for the residual stream
    seq_parallel: bool = True
    #: gradient-accumulation microbatches for long training sequences
    microbatches: int = 1
    #: adam moment dtype ("float32" | "bfloat16")
    opt_dtype: str = "float32"
    #: pure data-parallel mapping (batch over every axis, no tensor parallelism)
    pure_dp: bool = False


ARCHS: Dict[str, ArchEntry] = {
    e.arch_id: e
    for e in [
        ArchEntry("starcoder2-15b", starcoder2_15b.FULL, starcoder2_15b.SMOKE,
                  zero=True, microbatches=2),
        ArchEntry("h2o-danube-3-4b", h2o_danube3_4b.FULL, h2o_danube3_4b.SMOKE,
                  zero=True),
        ArchEntry("internlm2-20b", internlm2_20b.FULL, internlm2_20b.SMOKE,
                  zero=True, microbatches=2),
        ArchEntry("smollm-135m", smollm_135m.FULL, smollm_135m.SMOKE,
                  zero=False, seq_parallel=False, pure_dp=True),
        ArchEntry("zamba2-1.2b", zamba2_1p2b.FULL, zamba2_1p2b.SMOKE, zero=True),
        ArchEntry("paligemma-3b", paligemma_3b.FULL, paligemma_3b.SMOKE, zero=True),
        ArchEntry("rwkv6-7b", rwkv6_7b.FULL, rwkv6_7b.SMOKE, zero=True),
        ArchEntry("dbrx-132b", dbrx_132b.FULL, dbrx_132b.SMOKE,
                  zero=True, zero_params=True, microbatches=4,
                  opt_dtype="bfloat16"),
        ArchEntry("grok-1-314b", grok1_314b.FULL, grok1_314b.SMOKE,
                  zero=True, zero_params=True, microbatches=4,
                  opt_dtype="bfloat16"),
        ArchEntry("whisper-medium", whisper_medium.FULL, whisper_medium.SMOKE,
                  zero=False),
    ]
}


def get_arch(arch_id: str) -> ArchEntry:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def cells():
    """All (arch x shape) dry-run cells, with SKIP reasons where applicable."""
    out = []
    for aid, entry in ARCHS.items():
        for sname in SHAPES:
            skip = None
            if sname == "long_500k" and not supports_long_context(entry.full):
                skip = "pure full attention (quadratic) — assignment says skip"
            out.append((aid, sname, skip))
    return out


__all__ = ["ARCHS", "ArchEntry", "SHAPES", "ShapeSpec", "get_arch", "cells"]
