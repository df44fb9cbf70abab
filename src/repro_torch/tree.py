"""Trees of tensors: the reference's pytrees over dicts, lists, tuples and
NamedTuples (parameters, optimizer state, checkpoints, batches).

Leaves are visited in ``jax.tree.leaves`` order: dict keys sorted at every
level, sequences and NamedTuple fields in order; ``None`` is an empty
subtree; any other tuple subclass (``parallel.sharding.P``) is a leaf, as
in JAX. A leaf's name is ``jax.tree_util.keystr`` of its path, e.g.
``"[0]['groups']['b0']['attn']['wq']"`` or ``"[1].mu['embed']"``, so a
checkpoint manifest names its leaves as the reference's does.
"""
from __future__ import annotations

from typing import Any, Callable, Optional


def _children(node) -> Optional[list[tuple[str, Any]]]:
    """``(key, child)`` pairs of an inner node in leaf order; None for a
    leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if type(node) in (tuple, list):    # a tuple subclass (a spec) is a leaf
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    if node is None:
        return []
    return None


def leaves_with_names(tree, prefix: str = "") -> list[tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [item for key, child in kids
            for item in leaves_with_names(child, prefix + key)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_names(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` on every leaf (and the matching leaves of ``rest``, trees of
    the same structure), keeping the structure of ``tree``."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    if isinstance(tree, dict):   # visited in leaf order, keys kept in place
        out = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if tree is None:
        return None
    out = [tree_map(fn, c, *(r[i] for r in rest))
           for i, c in enumerate(tree)]
    if hasattr(tree, "_fields"):
        return type(tree)(*out)
    return type(tree)(out)


def unflatten(tree_like, new_leaves) -> Any:
    """A tree of ``tree_like``'s structure holding ``new_leaves`` in leaf
    order."""
    new_leaves = list(new_leaves)
    n = len(leaves(tree_like))
    if len(new_leaves) != n:
        raise ValueError(f"{len(new_leaves)} leaves for a tree of {n}")
    it = iter(new_leaves)
    return tree_map(lambda _: next(it), tree_like)
