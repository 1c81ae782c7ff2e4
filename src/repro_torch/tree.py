"""Nested dicts of tensors (the port's parameter and optimizer trees),
walked in sorted-key order: the order in which JAX flattens a dict
pytree, so a leaf list lines up with the reference's ``jax.tree.leaves``."""
from __future__ import annotations

from typing import Callable, Iterator, List, Tuple

__all__ = ["tree_map", "tree_leaves", "tree_items", "tree_unflatten"]


def tree_items(tree, prefix: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[Tuple[str, ...], object]]:
    """(path, leaf) pairs in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def tree_leaves(tree) -> List:
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (same keys), as a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in
    ``tree_leaves`` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    return build(tree)
