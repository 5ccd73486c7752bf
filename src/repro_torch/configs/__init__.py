"""Architecture registry: ``--arch <id>`` resolves here.

Each entry carries the full published config, a reduced smoke config of
the same family, and the reference's per-arch distribution settings (ZeRO
sharding, sequence parallelism, microbatches, optimizer dtype) as data:
nothing reads them until the parallelism port. Counterpart of
``repro.configs``, in its order; zamba2-1.2b, rwkv6-7b and whisper-medium
wait for their model families, and ``get_arch`` raises ``KeyError`` for
them until then.
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
    smollm_135m,
    starcoder2_15b,
)


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
        ArchEntry("paligemma-3b", paligemma_3b.FULL, paligemma_3b.SMOKE, zero=True),
        ArchEntry("dbrx-132b", dbrx_132b.FULL, dbrx_132b.SMOKE,
                  zero=True, zero_params=True, microbatches=4,
                  opt_dtype="bfloat16"),
        ArchEntry("grok-1-314b", grok1_314b.FULL, grok1_314b.SMOKE,
                  zero=True, zero_params=True, microbatches=4,
                  opt_dtype="bfloat16"),
    ]
}


def get_arch(arch_id: str) -> ArchEntry:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


__all__ = ["ARCHS", "ArchEntry", "get_arch"]
