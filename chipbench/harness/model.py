"""A configuration file turned into the program's config object, and its
plain reference module.

The file's ``model`` block holds every size as run, under the program's
field names; the program's registry entry (``arch``) supplies the config
class. ``dtype`` is written as a name (``"bfloat16"``).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

import torch


def port_config(config: Dict):
    from repro_torch.configs import get_arch
    from repro_torch.models.api import family_of

    fields = dict(config["model"])
    fields["dtype"] = getattr(torch, fields["dtype"])
    cfg = dataclasses.replace(get_arch(config["arch"]).full, name=config["name"], **fields)
    if family_of(cfg).name != config["family"]:
        raise ValueError(f"{config['name']}: the program runs it as family "
                         f"{family_of(cfg).name!r}, the file says {config['family']!r}")
    return cfg


def param_shapes(cfg):
    from repro_torch.models.api import param_shapes as shapes

    return shapes(cfg)


def reference(config: Dict):
    """The configuration's plain reference module (``reference/<name>.py``)."""
    return importlib.import_module(f"reference.{config['reference']}")
