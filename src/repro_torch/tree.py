"""Nested trees: dicts, lists and tuples of tensors, the layout of the JAX
package's params pytrees (R-GAT's ``params["layers"][l]["rel"]["g0"]["w_src"]``),
and dataclasses such as ``TrainState``.

Leaves come in JAX's ``tree_leaves`` order: dict entries by sorted key,
list, tuple and dataclass entries in order; ``None`` is an empty subtree
(an unused ``master`` entry), as in JAX.  A leaf's path is JAX's key-path
string, the key a checkpoint stores it under: a dict entry ``['name']``, a
list entry ``[i]``, a dataclass field ``[<flat index i>]``, joined by
``/``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


def _children(tree) -> list[tuple[str, Any]] | None:
    """A node's (key, child) pairs in JAX's order; None for a leaf."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f"[<flat index {i}>]", getattr(tree, f.name))
                for i, f in enumerate(dataclasses.fields(tree))]
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", t) for i, t in enumerate(tree)]
    return None


def tree_leaves_with_path(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in JAX's leaf order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [kv for k, t in kids
            for kv in tree_leaves_with_path(t, f"{prefix}/{k}" if prefix else k)]


def tree_leaves(tree) -> list:
    return [x for _, x in tree_leaves_with_path(tree)]


def tree_leaves_at(like, tree) -> list:
    """``tree``'s entries at the leaves of ``like`` (a tree of the same
    structure, whose entries there may be anything, None included), in
    :func:`tree_leaves` order."""
    if like is None:
        return []
    kids = _children(like)
    if kids is None:
        return [tree]
    return [x for (_, a), (_, b) in zip(kids, _children(tree)) for x in tree_leaves_at(a, b)]


def tree_map(fn: Callable[..., Any], tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching entries of
    ``rest`` (trees of the same structure, whose entries at ``tree``'s
    leaves may be anything, None included).  None in ``tree`` stays None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return type(t)(**{f.name: build(getattr(t, f.name))
                              for f in dataclasses.fields(t)})
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}  # leaves in sorted-key order
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        if t is None:
            return None
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
