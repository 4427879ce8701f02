"""Pieces every plain reference family shares: the parameter tree's leaf
order, the weights' draws, RMS norm, rotary embeddings, the int8 cut and
the cross-entropy.  Plain PyTorch; nothing here imports the port.

Parameters follow the port's layout: a nested dict whose per-layer leaves
are stacked on a leading layer axis under ``"layers"``.  Leaves are
visited with dict keys sorted (the port's flat-buffer order), and named by
their key path joined with ``/``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.utils.checkpoint

Tree = Dict[str, object]


def leaf_paths(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(path, leaf)`` in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaf_paths(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of dicts and lists, the structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def layer(tree: Tree, i: int) -> Tree:
    """Layer ``i``'s params: its slice of the stacked ``tree["layers"]``
    (views), or entry ``i`` where ``tree["layers"]`` is a list of
    per-layer trees (``unstack``)."""
    if isinstance(tree["layers"], list):
        return tree["layers"][i]

    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return take(tree["layers"])


def unstack(tree: Tree, num_layers: int, fn=lambda t: t) -> Tree:
    """``tree`` with its stacked ``"layers"`` as a list of per-layer trees
    (``fn`` of each slice, e.g. a trainable copy), other leaves ``fn``
    of themselves."""
    out = {k: tree_map(fn, v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [tree_map(fn, layer(tree, i)) for i in range(num_layers)]
    return out


def restack(tree: Tree) -> Tree:
    """The inverse of ``unstack``: the per-layer trees stacked again."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    out["layers"] = tree_map(lambda *xs: torch.stack(xs), *tree["layers"])
    return out


def draw(gen: torch.Generator, device, normal: Sequence[Tuple[str, tuple,
                                                              float]]
         ) -> Dict[str, torch.Tensor]:
    """Leaves of N(0, std^2) for each ``(path, shape, std)``, in one
    ``normal_`` call over one buffer on ``device`` (each leaf a view of
    it, scaled in place)."""
    sizes = [math.prod(shape) for _, shape, _ in normal]
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    buf.normal_(0.0, 1.0, generator=gen)
    out, off = {}, 0
    for (path, shape, std), n in zip(normal, sizes):
        out[path] = buf[off:off + n].view(shape).mul_(std)
        off += n
    return out


def nest(flat: Dict[str, torch.Tensor]) -> Tree:
    """``{"a/b/c": t}`` -> ``{"a": {"b": {"c": t}}}``."""
    tree: Tree = {}
    for path, t in flat.items():
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = t
    return tree


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMS norm with the weight stored as ``scale - 1`` (zeros are the
    identity)."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x`` (B, S, heads, D) at positions 0..S-1,
    halves rotated (the first D/2 lanes against the second)."""
    S, D = x.shape[1], x.shape[-1]
    freqs = 1.0 / torch.pow(float(theta), torch.arange(
        0, D, 2, dtype=torch.float32, device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def quantize_rows(x: torch.Tensor):
    """Rowwise absmax int8 codes and scales of a 2-D tensor."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale[:, None]


class Int8Cut(torch.autograd.Function):
    """The activation crossing the cut as int8 (rows are the last axis),
    its gradient straight through."""

    @staticmethod
    def forward(ctx, x):
        shape = x.shape
        q, s = quantize_rows(x.reshape(-1, shape[-1]))
        return dequantize_rows(q, s).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return g


def run_layers(block: Callable, params: Tree, x: torch.Tensor, start: int,
               stop: int) -> torch.Tensor:
    """Layers ``[start, stop)``: ``block(layer_params, x)``, each
    recomputed in the backward while grad is on."""
    for i in range(start, stop):
        p = layer(params, i)
        if torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                block, p, x, use_reentrant=False)
        else:
            x = block(p, x)
    return x


def through_cut(block: Callable, params: Tree, x: torch.Tensor, op: int,
                num_layers: int, quantize: bool) -> torch.Tensor:
    """The device's layers ``[0, op)``, the cut (int8 when ``quantize``
    and the cut lies inside the model), the server's ``[op, L)``."""
    x = run_layers(block, params, x, 0, op)
    if quantize and op < num_layers:
        x = Int8Cut.apply(x)
    return run_layers(block, params, x, op, num_layers)


def _ce_chunk(h: torch.Tensor, unembed: torch.Tensor, lab: torch.Tensor):
    logits = h @ unembed
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lab.clamp(min=0)[:, None])[:, 0]
    return torch.sum((lse - gold) * (lab >= 0))


def cross_entropy(hidden: torch.Tensor, unembed: torch.Tensor,
                  labels: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """Mean next-token cross-entropy over the labels >= 0, the logits
    made ``chunk`` tokens at a time (recomputed in the backward)."""
    h = hidden.reshape(-1, hidden.shape[-1])
    lab = labels.reshape(-1).long()
    total = h.new_zeros(())
    for c in range(0, h.shape[0], chunk):
        args = (h[c:c + chunk], unembed, lab[c:c + chunk])
        if torch.is_grad_enabled():
            total = total + torch.utils.checkpoint.checkpoint(
                _ce_chunk, *args, use_reentrant=False)
        else:
            total = total + _ce_chunk(*args)
    return total / torch.clamp((lab >= 0).sum(), min=1)
