"""What a run needs of its machine, and what it must not carry.

* ``require_cards``: a run needs CUDA and as many cards as its cell asks
  for; without them it fails, and never falls back to the CPU.
* ``set_cache_dirs``: kernel and build caches at fixed paths inside the
  checkout (``build/chipbench_cache``, which git ignores), so only a
  checkout's first run builds anything.
* ``forbidden_modules``: JAX and the JAX package must not be loaded in the
  process that prints a result. Module names are compared by their whole
  top-level name: the port's ``repro_torch`` begins with ``repro``.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoCard(RuntimeError):
    pass


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: this benchmark runs only on a card")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell needs {n} cards, torch.cuda.device_count() is "
                     f"{torch.cuda.device_count()}")


def set_cache_dirs(root: Path) -> None:
    cache = root / "build" / "chipbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        path = cache / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def forbidden_modules(modules=None) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def card_line() -> str:
    """``name, power limit`` of card 0 as nvidia-smi reads them, or the
    reason it could not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"
