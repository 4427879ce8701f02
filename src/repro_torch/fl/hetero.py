"""HeteroFL width-scaled clients (counterpart of ``repro/fl/hetero.py``).

FedAdapt meets compute heterogeneity by offloading: a weak device cuts
earlier.  Width scaling is the complementary answer: a weak client trains
only the first ``width`` fraction of every hidden dimension, a static
subnetwork of the global model.  Both compose: a client has an OP and a
width.

``HeteroSpec`` builds, once per run and per *distinct* width, the 0/1
mask tree (``SplitProgram.width_mask``) and its flat row in the server
step's layout, on the params' device:

* the engines (``fl/fleet.py``) start a client from ``mask * global`` and
  step ``p - lr * (mask * grad)``, so it never leaves its subnetwork;
* the server step (``fl/flatbuf.py``, ``masks=``) averages each coordinate
  over the clients whose mask covers it; a coordinate no client covers
  keeps its value bit for bit.  Masks are nested, so every coordinate's
  average is over the clients that trained it.

``compute_scale`` is the Eq. 1 compute multiplier, ``width**2``: a
width-``w`` client's matmuls shrink in both operand dims (the HeteroFL
accounting).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.fl.flatbuf import FlatLayout, Params
from repro_torch.tree import tree_map


class HeteroSpec:
    """Per-client widths in (0, 1] and their cached masks.  A width of 1.0
    is an all-ones mask.  Masks are a pure function of (param structure,
    width), the same every round, so resume and replay stay bitwise."""

    def __init__(self, program, params: Params, widths: Sequence[float],
                 layout: Optional[FlatLayout] = None):
        ws = [float(w) for w in widths]
        for w in ws:
            if not 0.0 < w <= 1.0:
                raise ValueError(f"client width {w} outside (0, 1]")
        self.widths: List[float] = ws
        self.layout = layout if layout is not None else FlatLayout(params)
        self._mask_trees: Dict[float, Params] = {}
        self._mask_rows: Dict[float, torch.Tensor] = {}
        for w in sorted(set(ws)):
            tree = program.width_mask(params, w)
            self._mask_trees[w] = tree
            # 0/1 values are exact in fp32: the row is the tree, flattened
            self._mask_rows[w] = self.layout.flatten(tree)

    def __len__(self) -> int:
        return len(self.widths)

    def width(self, k: int) -> float:
        return self.widths[k]

    def mask_tree(self, k: int) -> Params:
        """Client ``k``'s 0/1 mask tree (the params' structure)."""
        return self._mask_trees[self.widths[k]]

    def mask_row(self, k: int) -> torch.Tensor:
        """Client ``k``'s flat 0/1 mask row ``(layout.padded,)``."""
        return self._mask_rows[self.widths[k]]

    def rows(self, k_indices: Sequence[int]) -> torch.Tensor:
        """Stacked mask rows ``(len(k_indices), padded)``: the server
        step's ``masks`` operand, in the order of ``k_indices``."""
        return torch.stack([self.mask_row(int(k)) for k in k_indices])

    def apply(self, params: Params, k: int) -> Params:
        """``mask_k * params``, leaf by leaf: client ``k``'s start point."""
        return tree_map(lambda p, m: m * p, params, self.mask_tree(k))

    @property
    def compute_scale(self) -> np.ndarray:
        """Per-client Eq. 1 compute multiplier, ``width**2`` in float64."""
        return np.asarray([w * w for w in self.widths], np.float64)


def resolve_hetero(fl, program, params: Params,
                   layout: Optional[FlatLayout] = None
                   ) -> Optional[HeteroSpec]:
    """The fleet's ``HeteroSpec`` from ``FLConfig.client_widths``, or
    ``None``: the homogeneous paths stay bit for bit as they are."""
    if fl.client_widths is None:
        return None
    return HeteroSpec(program, params, fl.client_widths, layout=layout)
