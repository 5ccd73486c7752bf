"""Device selection shared by the port's entry points.

Every entry point takes an explicit ``device`` and defaults to ``cuda``.
Asking for CUDA on a host without a card raises: there is no silent fall
back to the CPU, so a run that reports device numbers really ran there.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    card is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the host"
        )
    return dev
