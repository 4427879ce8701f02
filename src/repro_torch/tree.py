"""The little of ``jax.tree_util`` the port needs, over its parameter
trees: nested dicts, lists and tuples of tensors (VGG's per-layer list of
dicts, the PPO agent's ``{"actor": {...}, "critic": {...}}``, the LMs'
nested dicts of stacked layers, the hybrid LM's list of slots and its
tuple of slot caches).

The leaf order is the reference's: dict keys sorted, lists and tuples in
order.  ``tree_structure`` keeps a tree's containers (an empty dict, as
VGG's pooling layers hold, stays an empty dict) and ``tree_unflatten``
fills them with leaves in that order."""
from __future__ import annotations

from typing import Any, List

import torch


def tree_map(fn, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, keeping the structure (dicts, lists and tuples, each kept as
    its own type; a leaf is anything else)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in the reference's pytree order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


class _Leaf:
    """The placeholder of a leaf in a ``tree_structure``."""

    def __repr__(self) -> str:
        return "*"


LEAF = _Leaf()


def tree_structure(tree) -> Any:
    """``tree``'s containers with every leaf replaced by ``LEAF``."""
    return tree_map(lambda _: LEAF, tree)


def tree_unflatten(structure, leaves) -> Any:
    """``structure``'s containers (a ``tree_structure``, or any tree whose
    leaves are ignored) filled with ``leaves`` in the reference's leaf
    order; each container keeps its type and dicts their key order.
    ``None`` is an empty subtree, as in JAX."""
    it = iter(leaves)

    def rebuild(s):
        if s is None:
            return None
        if isinstance(s, dict):
            out = {k: rebuild(s[k]) for k in sorted(s)}
            return {k: out[k] for k in s}
        if isinstance(s, (list, tuple)):
            return type(s)(rebuild(t) for t in s)
        return next(it)

    out = rebuild(structure)
    if next(it, LEAF) is not LEAF:
        raise ValueError("tree_unflatten: more leaves than the structure "
                         "holds")
    return out


def tree_unzip(tree, i: int) -> Any:
    """Component ``i`` of a tree of dicts and lists whose leaves are
    tuples."""
    if isinstance(tree, dict):
        return {k: tree_unzip(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_unzip(t, i) for t in tree]
    return tree[i]
