"""Param trees of the train path: nested dicts of tensors, as repro's
pytrees are nested dicts of arrays.

``leaves`` flattens a tree in JAX's order (dict keys sorted) and names
each leaf with the string ``jax.tree_util.keystr`` gives its path, such
as ``['params']['layers']['attn']['wq']``: a checkpoint written by either
package then names its leaves alike. An empty dict holds no leaf.
"""
from __future__ import annotations

from typing import Callable, Iterator

import torch


def leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(keystr path, leaf) of every leaf, dict keys in sorted order."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out.extend(leaves(tree[key], f"{prefix}[{key!r}]"))
        return out
    return [(prefix, tree)]


def tensors(tree) -> Iterator[torch.Tensor]:
    return (t for _, t in leaves(tree))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), as ``jax.tree.map``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, prefix: str = ""):
    """``fn(path, leaf)`` over the leaves of ``tree``, each path the
    string ``leaves`` names it by (``jax.tree_util.tree_map_with_path``);
    anything not a dict is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    return fn(prefix, tree)


def unflatten(like, values: list):
    """A tree of ``like``'s structure whose leaves, in ``leaves`` order,
    are ``values``."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more values than leaves")
    return out
