"""Minimal pytree helpers over the port's parameter and state containers.

Params are nested dicts of tensors (``{"embed": ..., "dense": ...}``, the
JAX package's layout); optimizer states are tuples and NamedTuples. These
helpers walk exactly those containers so the optimizer code can mirror the
reference's ``jax.tree.map`` calls one for one. ``None`` is a leaf that
maps to ``None``.
"""

from __future__ import annotations

from typing import Any, Callable

PyTree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Apply ``fn`` leafwise over trees of the same structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> list:
    """Leaves in the order ``tree_map`` visits them (``None`` skipped)."""
    out: list = []
    tree_map(out.append, tree)
    return out


def flatten_with_paths(tree: PyTree, prefix: str = "") -> dict:
    """``{"a/b/0/name": leaf}`` — the key format of the JAX package's
    checkpoints: dict keys, sequence indices and NamedTuple field names
    joined by ``/``."""
    flat: dict = {}

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            items = node.items()
        elif _is_namedtuple(node):
            items = zip(node._fields, node)
        elif isinstance(node, (tuple, list)):
            items = enumerate(node)
        else:
            flat[path] = node
            return
        for k, v in items:
            walk(v, f"{path}/{k}" if path else str(k))

    walk(tree, prefix)
    return flat


def unflatten_dict(flat: dict) -> dict:
    """Inverse of ``flatten_with_paths`` for trees made only of dicts."""
    out: dict = {}
    for key, leaf in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out
