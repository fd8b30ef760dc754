"""Walking a tree of tensors in the JAX package's order.

A tree is nested dicts; a dict's children are taken in sorted key order,
which is the order JAX flattens a dict in. The optimizer, the checkpoint
payload, the parameter templates and the tests all walk trees this way, so
that leaf i of one is leaf i of another, and of the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

Tree = Any  # nested dicts of tensors (the leaves: anything else)


def ordered_keys(node: dict) -> list:
    """A dict node's keys in flattening order."""
    return sorted(node)


def named_leaves(tree: Tree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """``(dotted name, leaf)`` pairs in flattening order."""
    if not isinstance(tree, dict):
        yield prefix.removesuffix("."), tree
        return
    for key in ordered_keys(tree):
        yield from named_leaves(tree[key], f"{prefix}{key}.")


def tree_leaves(tree: Tree) -> Iterator:
    """The leaves in flattening order."""
    return (leaf for _, leaf in named_leaves(tree))


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in ordered_keys(tree)}
    return fn(tree, *rest)
