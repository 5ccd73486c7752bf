"""Seeded weights, drawn on the device, in the program's tree layout, and
the float32 view of them that a reference reads.

The tree's shape comes from the program's ``param_shapes`` (meta tensors:
names, shapes and dtypes, nothing drawn). Each leaf is drawn by one call
on a generator of its own, seeded from (seed, leaf name), so a leaf can be
drawn again alone and the same seed gives the same weights wherever the
tree is rebuilt. A leaf is stacked over layers where its first axis is
the configuration's layer count (``stacked``). A leaf of more than
``WHOLE`` elements (a float32 draw over 4 GiB) must be stacked: it is
drawn one layer slice at a time, each slice on a generator seeded from
(seed, leaf name, layer index) and cast into the leaf, so the float32
temporary is one slice and each slice can be drawn again alone. A larger
leaf that is not stacked, or whose slice is itself over ``WHOLE``,
raises.
The rule is the usual one and the program's own, for whole leaves and
slices alike: normal with variance 1/fan-in, fan-in the second-to-last
axis of a matrix (the last of the embedding, read by rows); norm scales
one, norm biases zero; Whisper's learned positions normal with scale 0.01.

``OnDemand`` hands a reference the tree in float32 without casting it
whole: a stacked leaf indexed by layer gives that layer's slice cast
anew, and the other leaves are cast once, when first read. bfloat16 to
float32 is exact, so the reference reads the same values as from a tree
cast whole.
"""

from __future__ import annotations

import hashlib
import math
import operator
from collections.abc import Mapping
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


#: elements of the largest leaf drawn by one call: its float32 draw is 4 GiB
WHOLE = 1 << 30


def stacked(shape, n_layers: int) -> bool:
    """Whether a leaf is stacked over layers: read by layer in the float32
    view, and drawn by layer where it is big. The one rule for both."""
    return len(shape) >= 2 and shape[0] == n_layers


def sliced(name: str, shape, n_layers: int) -> bool:
    """Whether the leaf is drawn one layer slice at a time (it is over
    ``WHOLE``); raises, naming it, for a leaf over ``WHOLE`` that is not
    ``stacked`` or whose layer slice is over ``WHOLE`` too."""
    numel = math.prod(shape)
    if numel <= WHOLE:
        return False
    if not stacked(shape, n_layers) or numel // shape[0] > WHOLE:
        raise ValueError(f"leaf {name} {tuple(shape)} has {numel} elements, over {WHOLE}, "
                         f"and is not stacked over {n_layers} layers in slices of at most "
                         f"{WHOLE}")
    return True


def _std(name: str, shape) -> float:
    last = name.rsplit(".", 1)[-1]
    if last == "pos":
        return 0.01
    if last == "embed":
        return shape[-1] ** -0.5
    return shape[-2] ** -0.5


def drawn(name: str, shape, seed: int, device, *layer: int) -> torch.Tensor:
    """The float32 draw of a whole leaf of ``shape``, or with ``layer`` of
    that layer's slice, before the cast: either can be drawn again alone."""
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, "weights", _name_code(name), *layer))
    w = torch.randn(tuple(shape[len(layer):]), generator=g, dtype=torch.float32, device=device)
    return w.mul_(_std(name, shape))


def draw_leaf(name: str, shape, dtype, seed: int, device, n_layers: int) -> torch.Tensor:
    last = name.rsplit(".", 1)[-1]
    if last == "scale":
        return torch.ones(shape, dtype=dtype, device=device)
    if last == "bias":
        return torch.zeros(shape, dtype=dtype, device=device)
    if not sliced(name, shape, n_layers):
        return drawn(name, shape, seed, device).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i].copy_(drawn(name, shape, seed, device, i))
    return out


def draw(shapes, seed: int, device, n_layers: int) -> Dict:
    """A weight tree shaped like ``shapes`` (meta tensors) of a model of
    ``n_layers`` layers, drawn on ``device`` from ``seed``."""
    def build(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}.{k}" if prefix else k) for k, v in tree.items()}
        return draw_leaf(prefix, tuple(tree.shape), tree.dtype, seed, device, n_layers)

    return build(shapes)


def to_float32(t: torch.Tensor) -> torch.Tensor:
    """The one cast the float32 view makes (the tests count what it holds)."""
    return t.float()


class Layers:
    """A leaf stacked over layers, read by layer: ``leaf[i]`` is layer
    ``i``'s slice cast to float32 anew, held only as long as its reader
    holds it."""

    def __init__(self, leaf: torch.Tensor):
        self.leaf = leaf

    def __getitem__(self, i) -> torch.Tensor:
        return to_float32(self.leaf[operator.index(i)])


class OnDemand(Mapping):
    """``tree`` as a reference reads it in float32, with nothing cast ahead
    of the read: a ``stacked`` leaf comes out as ``Layers``; any other leaf (the
    embedding, a head, a final norm) is cast once, when first read, and
    kept. Sub-trees are views of the same kind, sharing that cache."""

    def __init__(self, tree: Dict, n_layers: int, prefix: str = "", cast=None):
        self._tree, self._n_layers, self._prefix = tree, n_layers, prefix
        self._cast: Dict[str, torch.Tensor] = {} if cast is None else cast

    def __getitem__(self, key):
        v = self._tree[key]
        name = f"{self._prefix}.{key}" if self._prefix else key
        if isinstance(v, dict):
            return OnDemand(v, self._n_layers, name, self._cast)
        if stacked(v.shape, self._n_layers):
            return Layers(v)
        if name not in self._cast:
            self._cast[name] = to_float32(v)
        return self._cast[name]

    def __iter__(self):
        return iter(self._tree)

    def __len__(self) -> int:
        return len(self._tree)


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
