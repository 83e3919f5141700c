"""Parameter trees: nested dicts and lists of tensors, as the JAX package's
pytrees.  Leaves are visited in ``jax.tree.leaves`` order (dict keys sorted,
lists in order), so flat lists line up leaf for leaf with the JAX side."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied to every leaf of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any, path: tuple = ()) -> Any:
    """``tree_map`` with the leaf's path (as ``tree_leaves_with_path``
    gives it) as ``fn``'s first argument."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest), path=path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, *(r[i] for r in rest), path=path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def _iter_leaves(tree: Any) -> Iterator[Any]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _iter_leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _iter_leaves(v)
    else:
        yield tree


def tree_leaves(tree: Any) -> List[Any]:
    return list(_iter_leaves(tree))


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_leaves_with_path(tree: Any, path: tuple = ()) -> List[tuple]:
    """(path, leaf) pairs in ``tree_leaves`` order; a path is the tuple of
    the dict keys and list indices (as strings) down to the leaf, the names
    the JAX package's ``launch/shardings.py`` reads."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves_with_path(tree[k], path + (str(k),))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in tree_leaves_with_path(v, path + (str(i),))]
    return [(path, tree)]
