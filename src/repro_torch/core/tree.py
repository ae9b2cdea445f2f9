"""Minimal pytree helpers over the port's state containers.

Decode states are nested dicts and dataclasses of tensors (the layout of the
reference's pytrees).  Dataclass fields whose metadata says ``static`` are
configuration, not state, and pass through untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch


def is_static(f: dataclasses.Field) -> bool:
    return bool(f.metadata.get("static"))


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """Apply ``fn`` to every tensor leaf of ``tree`` (and the matching leaves
    of ``rest``), rebuilding the same structure.  A node for which
    ``is_leaf`` is true goes to ``fn`` whole."""
    if isinstance(tree, torch.Tensor) or (is_leaf is not None
                                          and is_leaf(tree)):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        kw = {}
        for f in dataclasses.fields(tree):
            val = getattr(tree, f.name)
            kw[f.name] = val if is_static(f) else tree_map(
                fn, val, *(getattr(r, f.name) for r in rest), is_leaf=is_leaf)
        return type(tree)(**kw)
    raise TypeError(f"not a state tree node: {type(tree).__name__}")


def tree_leaves(tree: Any) -> list:
    """Every tensor leaf of ``tree`` in a fixed order (dict insertion order,
    tuple and dataclass field order); ``None`` holds no leaf."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) if not is_static(f)
                for x in tree_leaves(getattr(tree, f.name))]
    raise TypeError(f"not a state tree node: {type(tree).__name__}")


def tree_unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with its tensor leaves replaced, in
    :func:`tree_leaves` order, by ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
