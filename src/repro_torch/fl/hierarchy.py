"""Two-tier aggregation: edge aggregators and one root (counterpart of
``repro/fl/hierarchy.py``).

* Edge tier: each ``EdgeAggregator`` owns a contiguous slice of the
  survivors and runs ``ServerStep.reduce``: the whole compression pipeline
  (EF carry, block top-k, the int8 wire) and the weighted reduction, but
  no apply.  Its product is one pre-reduced flat row, the coverage row
  under width masks, its members' new EF rows and its weight mass.
* Root tier: ``flatbuf.RootStep`` combines the ``(E, padded)`` edge rows
  and applies them to the flat global; it never sees a client's row.

Within an edge the weights are normalized by the edge's mass ``W_e``; the
root weighs edge ``e`` by ``W_e / sum(W)``, so every client keeps its
global weight and two or more edges match the flat step up to fp32
summation order.  With one edge ``hierarchical_apply`` runs the flat step
itself, so ``num_edges=1`` is the flat step bit for bit by construction.
The EF rows come back in the caller's survivor order.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.fl.flatbuf import RootStep, ServerStep

__all__ = ["EdgeAggregator", "EdgeUpdate", "assign_edges",
           "hierarchical_apply"]


def assign_edges(count: int, num_edges: int) -> List[np.ndarray]:
    """Balanced partition of ``count`` survivor positions over
    ``min(num_edges, count)`` edges: contiguous slices in survivor order,
    sizes differing by at most one (``num_edges=1``: the identity)."""
    if count <= 0:
        return []
    if num_edges < 1:
        raise ValueError(f"num_edges={num_edges} must be >= 1")
    return list(np.array_split(np.arange(count), min(num_edges, count)))


@dataclasses.dataclass
class EdgeUpdate:
    """One edge's pre-reduced product, in flight to the root."""
    num: torch.Tensor                # (padded,) weighted sum of sent rows
    den: Optional[torch.Tensor]      # (padded,) covered weight (masked)
    new_err: Optional[torch.Tensor]  # (members, padded) new EF rows
    weight: float                    # the edge's survivor weight mass W_e
    members: int                     # survivors behind this edge


class EdgeAggregator:
    """One edge server: the shared ``ServerStep`` in reduce-only mode over
    its slice of the survivors.  Stateless between rounds: EF rows flow
    through it."""

    def __init__(self, edge_id: int, step: ServerStep):
        self.edge_id = int(edge_id)
        self.step = step

    def aggregate(self, deltas: torch.Tensor, weights: Sequence[float],
                  errors: Optional[torch.Tensor] = None,
                  masks: Optional[torch.Tensor] = None) -> EdgeUpdate:
        acc, den, new_err = self.step.reduce(deltas, weights, errors, masks)
        return EdgeUpdate(num=acc, den=den, new_err=new_err,
                          weight=float(np.asarray(weights, np.float64).sum()),
                          members=int(deltas.shape[0]))


def hierarchical_apply(
    step: ServerStep,
    root: RootStep,
    g_flat: torch.Tensor,
    deltas: torch.Tensor,
    weights: Sequence[float],
    errors: Optional[torch.Tensor] = None,
    masks: Optional[torch.Tensor] = None,
    num_edges: int = 1,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], int]:
    """One two-tier aggregation: partition the survivors over the edges,
    reduce each edge, combine and apply at the root.  Returns ``(new_g,
    new_err, edges_used)``, ``new_err`` in the caller's survivor order
    (``None`` without top-k)."""
    parts = assign_edges(int(deltas.shape[0]), num_edges)
    if len(parts) == 1:
        # one edge reduces and applies through the flat step itself
        new_g, new_err = step(g_flat, deltas, weights, errors, masks=masks)
        return new_g, new_err, 1
    # the parts are contiguous slices in survivor order: each edge reads
    # views of the stacked rows (no copy of an LM-sized row)
    updates = []
    for e, pos in enumerate(parts):
        sl = slice(int(pos[0]), int(pos[-1]) + 1)
        updates.append(EdgeAggregator(e, step).aggregate(
            deltas[sl], [weights[i] for i in pos],
            errors[sl] if errors is not None else None,
            masks[sl] if masks is not None else None))
    dens = (torch.stack([u.den for u in updates])
            if updates[0].den is not None else None)
    new_g = root(g_flat, torch.stack([u.num for u in updates]),
                 [u.weight for u in updates], dens)
    new_err = None
    if updates[0].new_err is not None:
        # the edges' rows, concatenated, are in survivor order
        new_err = torch.cat([u.new_err for u in updates])
    return new_g, new_err, len(parts)
