"""Flat-buffer server step (counterpart of ``repro/fl/flatbuf.py``, single
device): aggregate the clients' weight deltas into the global model.

* ``FlatLayout`` lays every parameter leaf into one contiguous fp32 buffer
  in the reference's leaf order (layer index, then the layer's keys sorted:
  ``b``, ``bn_bias``, ``bn_scale``, ``w``), each leaf row-major in its
  reference shape and padded to a block boundary.  No compression block
  straddles two leaves, so each block's ``(valid, k)`` budget comes from its
  leaf's true size and every keep decision matches the reference's.
  ``flatten`` / ``unflatten`` are exact inverses.
* ``ServerStep`` applies one round: plain averaging is one ``w @ deltas``;
  with top-k error feedback (``density < 1``) or the int8 wire format
  (``quantize``) the client rows stream through the kernels one by one, in
  client order, so the weighted sum accumulates in the reference's order and
  the working set stays O(n):
      carried = d + e;  comp = topk(carried);
      sent = dequantize(quantize(comp as rows of one block));
      new_e = carried - sent;  acc += w_i * sent.
  Client weights are normalized in float64, then cast to fp32.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.fl.fedavg import fedavg_apply_deltas
from repro_torch.kernels.quant_transfer import dequantize_rows, quantize_rows
from repro_torch.kernels.topk_compress import (
    compress_tree,
    density_block_meta,
    topk_compress_flat,
)
from repro_torch.tree import tree_leaves, tree_map

Params = List[Dict[str, torch.Tensor]]


class FlatLayout:
    """Per-leaf (shape, offset, size) for one parameter structure, offsets
    aligned to ``block``."""

    def __init__(self, params: Params, block: int = 1024):
        self.block = int(block)
        self.keys = tuple(tuple(sorted(layer)) for layer in params)
        leaves = tree_leaves(params)
        self.shapes = tuple(tuple(leaf.shape) for leaf in leaves)
        self.sizes = tuple(int(np.prod(s)) if s else 1 for s in self.shapes)
        self.segs = tuple(-(-sz // self.block) * self.block
                          for sz in self.sizes)
        self.offsets = tuple(int(o) for o in
                             np.cumsum((0,) + self.segs[:-1]))
        self.size = int(sum(self.sizes))      # true element count
        self.padded = int(sum(self.segs))     # buffer length (block-aligned)

    def flatten(self, params: Params) -> torch.Tensor:
        """Params -> contiguous fp32 ``(padded,)`` buffer on their device."""
        parts = [F.pad(leaf.detach().reshape(-1).to(torch.float32),
                       (0, seg - sz))
                 for leaf, sz, seg in zip(tree_leaves(params), self.sizes,
                                          self.segs)]
        return torch.cat(parts)

    def unflatten(self, buf: torch.Tensor) -> Params:
        """Exact inverse of ``flatten`` (padding dropped; fresh tensors)."""
        leaves = iter(buf[off:off + sz].reshape(shape).clone()
                      for off, sz, shape in
                      zip(self.offsets, self.sizes, self.shapes))
        return [{k: next(leaves) for k in keys} for keys in self.keys]

    def flatten_stacked(self, tree: Params) -> torch.Tensor:
        """A tree whose leaves carry a leading client axis ``(K, ...)`` ->
        ``(K, padded)``, each row ``flatten`` of that client's params."""
        parts = [F.pad(leaf.detach().reshape(leaf.shape[0], -1)
                       .to(torch.float32), (0, seg - sz))
                 for leaf, sz, seg in zip(tree_leaves(tree), self.sizes,
                                          self.segs)]
        return torch.cat(parts, dim=1)

    def rows_to_deltas(self, rows, g_flat: torch.Tensor) -> torch.Tensor:
        """Client parameter rows (the sequential engine's list, or the
        batched engine's ``StackedRows``) -> stacked fp32 deltas
        ``(R, padded)``."""
        if isinstance(rows, list):
            return torch.stack([self.flatten(r) for r in rows]) - g_flat[None]
        return self.flatten_stacked(rows.tree) - g_flat[None]

    def block_meta(self, density: float) -> np.ndarray:
        """Per-block ``(valid, k)`` rows over the whole buffer, each leaf's
        budget from its true (unpadded) element count."""
        return np.concatenate([density_block_meta(sz, self.block, density)
                               for sz in self.sizes], axis=0)


def _normalized_f64(weights: Sequence[float]) -> np.ndarray:
    w = np.asarray(weights, np.float64)
    return w / w.sum()


class ServerStep:
    """One server round over the flat buffer: call with the flat global,
    the stacked deltas ``(K, padded)``, per-client weights and (when
    ``density < 1``) the matching error-feedback rows; returns the new flat
    global and the new error rows."""

    def __init__(self, layout: FlatLayout, density: float = 1.0,
                 quantize: bool = False):
        self.layout = layout
        self.density = float(density)
        self.quantize = bool(quantize)
        self.track_errors = self.density < 1.0
        # the per-block (valid, k) table, moved to the buffers' device once
        self._meta = (torch.from_numpy(layout.block_meta(self.density))
                      if self.track_errors else None)

    def __call__(self, g_flat: torch.Tensor, deltas: torch.Tensor,
                 weights: Sequence[float],
                 errors: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        w = torch.as_tensor(_normalized_f64(weights), dtype=torch.float32,
                            device=g_flat.device)
        if not self.track_errors and not self.quantize:
            return g_flat + w @ deltas, None
        block = self.layout.block
        if self.track_errors and self._meta.device != g_flat.device:
            self._meta = self._meta.to(g_flat.device)
        acc = torch.zeros_like(g_flat)
        new_err = torch.empty_like(errors) if self.track_errors else None
        for i in range(deltas.shape[0]):
            carried = deltas[i] + errors[i] if self.track_errors else deltas[i]
            comp = (topk_compress_flat(carried[None], self._meta, block)[0]
                    if self.track_errors else carried)
            if self.quantize:
                q, s = quantize_rows(comp.view(-1, block))
                sent = dequantize_rows(q, s).view(-1)
            else:
                sent = comp
            if self.track_errors:
                new_err[i] = carried - sent
            acc = acc + w[i] * sent
        return g_flat + acc, new_err


# =============================================================================
# reference path: the per-leaf, per-client pipeline the fused step is held
# against (O(K x leaves) kernel launches)
# =============================================================================
def quantize_delta_flat(layout: FlatLayout, tree: Params) -> Params:
    """int8 wire format of one delta, unfused: flatten, quantize rows of
    ``block``, dequantize, unflatten.  The rows are the fused step's, so
    the scales and values agree with it."""
    q, s = quantize_rows(layout.flatten(tree).view(-1, layout.block))
    return layout.unflatten(dequantize_rows(q, s).view(-1))


def reference_server_step(
    layout: FlatLayout,
    params: Params,
    deltas: List[Params],
    weights: Sequence[float],
    errors: Optional[torch.Tensor],
    density: float = 1.0,
    quantize: bool = False,
) -> Tuple[Params, Optional[torch.Tensor]]:
    """Per-leaf, per-client server step with the fused ``ServerStep``'s
    algorithm: error-feedback carry, per-leaf top-k (``compress_tree``, a
    budget from each leaf's true size), optional int8 wire format, weighted
    apply (``fedavg_apply_deltas``).  ``errors`` are flat ``(len(deltas),
    padded)`` rows, as the loop keeps them; returns ``(params, new error
    rows)``.  (The reference's width-masked branch, ``masks``, comes with
    HeteroFL widths.)"""
    track = density < 1.0
    sents, new_err_rows = [], []
    for i, delta in enumerate(deltas):
        if track:
            err_tree = layout.unflatten(errors[i])
            carried = tree_map(lambda d, e: d.to(torch.float32)
                               + e.to(torch.float32), delta, err_tree)
            comp, _ = compress_tree(delta, err_tree, density=density,
                                    block=layout.block)
        else:
            carried, comp = None, delta
        sent = quantize_delta_flat(layout, comp) if quantize else comp
        if track:
            new_err_rows.append(layout.flatten(
                tree_map(lambda c, s: c - s, carried, sent)))
        sents.append(sent)
    new_params = fedavg_apply_deltas(params, sents, weights)
    return new_params, (torch.stack(new_err_rows) if track else None)
