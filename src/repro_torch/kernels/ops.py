"""Public entry points for the stitch kernels.

Dispatch is by device: each wrapper takes a CUDA tensor to its hand-written
kernel and a CPU tensor to its plain version (``ref.py``), in place of the
JAX package's ``interpret=`` switch. This module also bridges the host-side
allocator metadata (extent tables) to the int32 maps the kernels read on
the card, and reads or resets the wrappers' launch counts.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

from .stitch_copy import stitch_gather, stitch_scatter
from .stitched_attention import stitched_decode_attention

_WRAPPERS = (stitch_gather, stitch_scatter, stitched_decode_attention)


def chunk_map_from_extents(extents: Iterable, n_phys: int, device) -> torch.Tensor:
    """Flatten an extent table (list of (start, n) runs) into the dense
    logical->physical chunk map the kernels read, as int32 on ``device``.

    The map is checked on the host before upload: every id must lie in
    ``[0, n_phys)`` and no id may repeat (a scatter through a repeated id
    would race)."""
    ids = []
    for e in extents:
        ids.extend(range(e.start, e.start + e.n))
    if any(not 0 <= i < n_phys for i in ids):
        raise ValueError(f"chunk ids {ids} fall outside the arena's {n_phys} chunks")
    if len(set(ids)) != len(ids):
        raise ValueError(f"chunk ids {ids} repeat a chunk")
    return torch.tensor(ids, dtype=torch.int32, device=device)


#: the kernel wrappers under the JAX package's ``ops`` names
gather = stitch_gather
scatter = stitch_scatter
decode_attention = stitched_decode_attention


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {w.__name__: w.launches for w in _WRAPPERS}


def reset_launch_counts() -> None:
    for w in _WRAPPERS:
        w.launches = 0
