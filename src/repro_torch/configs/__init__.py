"""Architecture registry: ``--arch <id>`` resolves here.

Each entry carries the full published config and a reduced smoke config
of the same family. Counterpart of ``repro.configs``; only smollm-135m is
ported so far.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

from . import smollm_135m


@dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    full: Any
    smoke: Any


ARCHS: Dict[str, ArchEntry] = {
    e.arch_id: e
    for e in [ArchEntry("smollm-135m", smollm_135m.FULL, smollm_135m.SMOKE)]
}


def get_arch(arch_id: str) -> ArchEntry:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


__all__ = ["ARCHS", "ArchEntry", "get_arch"]
