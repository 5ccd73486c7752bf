"""Seeded weights, drawn on the device, in the program's tree layout.

The tree's shape comes from the program's ``param_shapes`` (meta tensors:
names, shapes and dtypes, nothing drawn). Each leaf is drawn by one call
on a generator of its own, seeded from (seed, leaf name), so a leaf can be
drawn again alone and the same seed gives the same weights wherever the
tree is rebuilt. The rule is the usual one and the program's own:
normal with variance 1/fan-in, fan-in the second-to-last axis of a
matrix (the last of the embedding, read by rows); norm scales one, norm
biases zero; Whisper's learned positions normal with scale 0.01.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import torch

from .seeds import derive


def leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(dotted name, leaf) pairs in sorted key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaves(tree[k], f"{prefix}.{k}" if prefix else k))
        return out
    return [(prefix, tree)]


def _name_code(name: str) -> int:
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")


def draw_leaf(name: str, shape, dtype, seed: int, device) -> torch.Tensor:
    last = name.rsplit(".", 1)[-1]
    if last == "scale":
        return torch.ones(shape, dtype=dtype, device=device)
    if last == "bias":
        return torch.zeros(shape, dtype=dtype, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, "weights", _name_code(name)))
    w = torch.randn(shape, generator=g, dtype=torch.float32, device=device)
    if last == "pos":
        std = 0.01
    elif last == "embed":
        std = shape[-1] ** -0.5
    else:
        std = shape[-2] ** -0.5
    return w.mul_(std).to(dtype)


def draw(shapes, seed: int, device) -> Dict:
    """A weight tree shaped like ``shapes`` (meta tensors), drawn on
    ``device`` from ``seed``."""
    def build(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}.{k}" if prefix else k) for k, v in tree.items()}
        return draw_leaf(prefix, tuple(tree.shape), tree.dtype, seed, device)

    return build(shapes)


#: elements of each leaf whose first gradient is compared one by one
SAMPLE = 4096


def sample_index(name: str, numel: int, seed: int) -> torch.Tensor:
    """Seeded positions (into the flattened leaf) of the elements compared
    one by one; all of them for a leaf of at most ``SAMPLE`` elements."""
    if numel <= SAMPLE:
        return torch.arange(numel)
    g = torch.Generator().manual_seed(derive(seed, "grad sample", _name_code(name)))
    return torch.randint(numel, (SAMPLE,), generator=g)


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in leaves(tree))
