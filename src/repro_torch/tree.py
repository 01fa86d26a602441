"""Trees of tensors, walked in the JAX package's leaf order.

A tree is a nested dict, list or tuple, or a dataclass (``OptState``,
``CompressionState``) of such; anything else is a leaf.  Dict keys are
visited sorted and sequences and dataclass fields in order, as
``jax.tree.leaves`` visits a dict and a registered dataclass, so a sum over
leaves adds in the reference's order.  An ``LM`` module stands for its
``tree()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

from torch import nn


def as_tree(tree: Any) -> Any:
    """``tree``, or an ``LM``'s parameter tree."""
    return tree.tree() if isinstance(tree, nn.Module) else tree


def children(tree: Any) -> Optional[List[Tuple[Any, Any]]]:
    """``[(key, child)]`` of a tree node in leaf order, or ``None`` for a
    leaf."""
    tree = as_tree(tree)
    if isinstance(tree, dict):
        return sorted(tree.items())
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def tree_items(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in leaf order, keys joined by ``/``."""
    kids = children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out += tree_items(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                       prefix: str = "") -> Any:
    """``tree``'s shape with ``fn(path, leaf)`` at each leaf."""
    tree = as_tree(tree)
    kids = children(tree)
    if kids is None:
        return fn(prefix, tree)
    new = {k: tree_map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
           for k, v in kids}
    if isinstance(tree, dict):
        return new
    if isinstance(tree, (list, tuple)):
        return type(tree)(new[i] for i in range(len(tree)))
    return dataclasses.replace(tree, **new)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of trees of one shape, as ``jax.tree.map``."""
    others = [dict(tree_items(r)) for r in rest]
    return tree_map_with_path(
        lambda path, leaf: fn(leaf, *(o[path] for o in others)), tree)
