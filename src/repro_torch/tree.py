"""Nested containers of tensors ("trees") in the JAX package's leaf order.

The port keeps model and training state as the reference does: nested
dicts of tensors inside NamedTuples (``TrainState``, ``OptState``). These
helpers flatten and map such trees in the order ``jax.tree`` uses (dict
keys sorted, NamedTuple and tuple/list fields in order) and name each leaf
as ``jax.tree_util.keystr`` does (``.params['embed']``, ``.opt.count``), so
checkpoints written by either package carry the same keys.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    """(key string, child) pairs of a container, in JAX's order; [] for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", x) for i, x in enumerate(tree)]
    return []


def _is_leaf(tree) -> bool:
    return not isinstance(tree, (dict, tuple, list))


def flatten_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """Every leaf with its ``keystr`` path, in JAX's leaf order."""
    if _is_leaf(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out.extend(flatten_with_path(child, prefix + key))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable[[Any], bool]] = None):
    """``fn`` applied leaf by leaf over trees of one structure, rebuilt in
    the first tree's containers. ``is_leaf`` marks more nodes of the first
    tree as leaves (an axes tree's name tuples)."""
    if _is_leaf(tree) or (is_leaf is not None and is_leaf(tree)):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in sorted(tree)}
    mapped = [tree_map(fn, x, *(r[i] for r in rest), is_leaf=is_leaf)
              for i, x in enumerate(tree)]
    if _is_namedtuple(tree):
        return type(tree)(*mapped)
    return type(tree)(mapped)


def unflatten_like(like, new_leaves: List[Any]):
    """A tree shaped like ``like`` whose leaves are ``new_leaves`` in
    ``leaves(like)`` order."""
    n = len(leaves(like))
    if len(new_leaves) != n:
        raise ValueError(f"{len(new_leaves)} leaves for a tree of {n}")
    it = iter(new_leaves)
    return tree_map(lambda _: next(it), like)
