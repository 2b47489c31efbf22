"""Pytrees of tensors in JAX's leaf order, for the optimizer and the
checkpointer: a master tree, its moments and a checkpoint walk the
reference's leaves in the reference's order, so a checkpoint either package
writes restores in the other.

A tree is nested dicts (walked in sorted key order), lists, tuples and
NamedTuples (in field order); ``None`` holds no leaf; anything else is a
leaf. ``flatten`` returns the leaves and a ``Spec`` that ``unflatten``
refills.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


class _Leaf:
    """The place of one leaf in a ``Spec``."""

    def __repr__(self):
        return "*"


LEAF = _Leaf()


class Spec:
    """A tree's structure with its leaves taken out."""

    def __init__(self, shape):
        self.shape = shape

    def __repr__(self):
        return f"Spec({self.shape!r})"


def _walk(tree, leaves: List) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _walk(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_walk(v, leaves) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, leaves) for v in tree)
    leaves.append(tree)
    return LEAF


def flatten(tree) -> Tuple[List, Spec]:
    leaves: List = []
    return leaves, Spec(_walk(tree, leaves))


def unflatten(spec: Spec, leaves) -> Any:
    it = iter(leaves)

    def fill(shape):
        if shape is LEAF:
            return next(it)
        if shape is None:
            return None
        if isinstance(shape, dict):
            return {k: fill(v) for k, v in shape.items()}
        if isinstance(shape, tuple) and hasattr(shape, "_fields"):
            return type(shape)(*[fill(v) for v in shape])
        return type(shape)(fill(v) for v in shape)

    out = fill(spec.shape)
    if next(it, None) is not None:
        raise ValueError("more leaves than the spec holds")
    return out


def leaves(tree) -> List:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree of ``rest`` (same structure)."""
    flat, spec = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError(f"trees differ: {len(flat)} vs {len(o)} leaves")
    return unflatten(spec, [fn(*xs) for xs in zip(flat, *others)])
