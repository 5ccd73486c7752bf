"""A model family's counts, found by the family's name: one file each.

``harness/families/<family>.py`` (``family`` as the configuration file and
the program name it) holds what the yardstick has to know of the family's
shapes: the model FLOPs of a training step, the input positions a row
feeds, and how a training batch is drawn; a family that is served adds the
FLOPs of a prefill and of a decoded token, and the KV bytes a token keeps.
A family with no file here has no counts: a cell of it fails at once and
is never counted as another family.
"""

from __future__ import annotations

import importlib
from typing import Dict, Iterable


def of(family: str):
    """The counts of ``family`` (``harness/families/<family>.py``)."""
    try:
        return importlib.import_module(f"{__name__}.{family}")
    except ModuleNotFoundError as exc:
        if exc.name != f"{__name__}.{family}":
            raise
        raise ValueError(f"no counts for family {family!r}: add "
                         f"harness/families/{family}.py") from None


def known_keys(family: str, m: Dict, keys: Iterable[str]) -> None:
    """Refuse a model with a key the family's counts do not know (an
    expert count, a window, a second MLP shape): counted without it, its
    FLOPs and bytes would be wrong and nothing would say so."""
    unknown = sorted(set(m) - set(keys))
    if unknown:
        raise ValueError(f"the {family} family's counts know no {', '.join(unknown)}: "
                         f"count such a model in a family file of its own")
