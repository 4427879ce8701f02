"""The little of ``jax.tree_util`` the port needs, over its parameter
trees: nested dicts and lists of tensors (VGG's per-layer list of dicts,
the PPO agent's ``{"actor": {...}, "critic": {...}}``)."""
from __future__ import annotations

from typing import Any, List

import torch


def tree_map(fn, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, keeping the structure (dicts and lists; a leaf is anything
    else)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in the reference's pytree order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unzip(tree, i: int) -> Any:
    """Component ``i`` of a tree whose leaves are tuples."""
    return tree_map(lambda t: t[i], tree)
