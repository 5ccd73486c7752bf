"""Seeds for each purpose, derived from the run's ``--seed``.

``--seed`` may be any whole number up to a little over 2**31 (and beyond);
each purpose (weights, traffic, the correctness sample) takes its own
stream, so adding one never shifts another.
"""

from __future__ import annotations

import zlib

import numpy as np


def _code(purpose: str) -> int:
    return zlib.crc32(purpose.encode())


def derive(seed: int, purpose: str, *index: int) -> int:
    """A 63-bit seed for ``purpose`` (and ``index``) from the run's seed."""
    if seed < 0:
        raise ValueError(f"--seed must not be negative, got {seed}")
    words = [seed & 0xFFFFFFFF, seed >> 32, _code(purpose), *index]
    ss = np.random.SeedSequence(words)
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, purpose: str, *index: int) -> np.random.Generator:
    return np.random.default_rng(derive(seed, purpose, *index))
