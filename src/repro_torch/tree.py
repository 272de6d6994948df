"""Nested dicts of tensors — the port's stand-in for JAX pytrees.

Parameter, optimizer and cache trees are plain nested ``dict``s keyed as the
JAX package keys its pytrees; every leaf is a tensor (or a numpy array on
the way in or out).  Flattening walks keys in sorted order and joins them
with ``/``, as ``jax.tree_util`` paths are joined in the checkpoint layout.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

__all__ = ["tree_map", "tree_leaves", "flatten", "unflatten"]

SEP = "/"


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf-wise over ``tree`` and the same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``{"a/b/c": leaf}`` in sorted key order."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(flatten(tree[k], f"{prefix}{SEP}{k}" if prefix else str(k)))
    return out


def tree_leaves(tree) -> List[Any]:
    return list(flatten(tree).values())


def unflatten(flat: Dict[str, Any]) -> dict:
    """The nested dict of a :func:`flatten` result."""
    out: dict = {}
    for key, leaf in flat.items():
        *path, last = key.split(SEP)
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out
