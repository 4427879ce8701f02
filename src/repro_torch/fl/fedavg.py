"""FedAvg aggregation [McMahan et al. 2017] (counterpart of
``repro/fl/fedavg.py``): the per-leaf server step of classic FL and
FedAdapt, over parameter deltas (client - global), so the same functions
serve plain averaging, straggler-dropped rounds with renormalized weights
and compressed deltas.

Client weights are normalized in float64 and enter each product as an
fp32 scalar; the weighted sum accumulates client by client in the given
order, as the reference's does.  ``fedavg_delta_stacked`` takes the
batched engine's stacked client axis and reduces it with one
``tensordot`` per leaf.  The round loop runs these under
``FLConfig.server_step="reference"`` (``flatbuf.reference_server_step``
composes them with per-client compression); the fused flat-buffer step is
the default.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

Params = Any


def _normalized(k: int, weights: Optional[Sequence[float]]) -> np.ndarray:
    w = np.ones(k) / k if weights is None else np.asarray(weights, np.float64)
    return w / w.sum()


def fedavg(client_params: List[Params],
           weights: Optional[Sequence[float]] = None) -> Params:
    """Weighted average of parameter trees."""
    w = _normalized(len(client_params), weights)

    def avg(*leaves):
        out = sum(float(wi) * leaf.to(torch.float32)
                  for wi, leaf in zip(w, leaves))
        return out.to(leaves[0].dtype)

    return tree_map(avg, *client_params)


def fedavg_delta(global_params: Params, client_params: List[Params],
                 weights: Optional[Sequence[float]] = None,
                 compress_fn=None) -> Params:
    """global + sum_k w_k (client_k - global), optionally compressing each
    client delta (top-k sparsification / int8) before averaging."""
    w = _normalized(len(client_params), weights)

    def agg(g, *cs):
        g32 = g.to(torch.float32)
        acc = torch.zeros_like(g32)
        for wi, c in zip(w, cs):
            delta = c.to(torch.float32) - g32
            if compress_fn is not None:
                delta = compress_fn(delta)
            acc = acc + float(wi) * delta
        return (g32 + acc).to(g.dtype)

    return tree_map(agg, global_params, *client_params)


def fedavg_apply_deltas(global_params: Params, deltas: List[Params],
                        weights: Optional[Sequence[float]] = None) -> Params:
    """``global + sum_k w_k delta_k`` over precomputed float32 deltas."""
    w = _normalized(len(deltas), weights)

    def agg(g, *ds):
        g32 = g.to(torch.float32)
        acc = torch.zeros_like(g32)
        for wi, d in zip(w, ds):
            acc = acc + float(wi) * d.to(torch.float32)
        return (g32 + acc).to(g.dtype)

    return tree_map(agg, global_params, *deltas)


def fedavg_delta_stacked(global_params: Params, stacked_params: Params,
                         weights: Optional[Sequence[float]] = None) -> Params:
    """``fedavg_delta`` over a stacked client axis: every leaf of
    ``stacked_params`` is ``(K, ...)``; one ``tensordot`` per leaf."""
    k = int(tree_leaves(stacked_params)[0].shape[0])
    w = _normalized(k, weights)

    def agg(g, s):
        g32 = g.to(torch.float32)
        wt = torch.as_tensor(w, dtype=torch.float32, device=g.device)
        upd = torch.tensordot(wt, s.to(torch.float32) - g32[None], dims=1)
        return (g32 + upd).to(g.dtype)

    return tree_map(agg, global_params, stacked_params)


def model_bytes(params: Params) -> int:
    """Bytes of all parameters."""
    return int(sum(leaf.numel() * leaf.element_size()
                   for leaf in tree_leaves(params)))
