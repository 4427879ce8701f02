"""Flat-buffer server step (counterpart of ``repro/fl/flatbuf.py``, single
device): aggregate the clients' weight deltas into the global model.

* ``FlatLayout`` lays every parameter leaf of any params tree (VGG's
  per-layer list of dicts, an LM's nested dicts of stacked layers, the
  hybrid's lists of slots) into one contiguous fp32 buffer in the
  reference's leaf order (dict keys sorted, lists in order: for VGG the
  layer index, then ``b``, ``bn_bias``, ``bn_scale``, ``w``), each leaf
  row-major in its reference shape and padded to a block boundary.  No
  compression block straddles two leaves, so each block's ``(valid, k)``
  budget comes from its leaf's true size and every keep decision matches
  the reference's.  ``flatten`` / ``unflatten`` are exact inverses (the
  tree's nesting and each leaf's dtype come back).
* ``ServerStep`` applies one round: plain averaging is one ``w @ deltas``;
  with top-k error feedback (``density < 1``) or the int8 wire format
  (``quantize``) the client rows stream through the kernels one by one, in
  client order, so the weighted sum accumulates in the reference's order and
  the working set stays O(n):
      carried = d + e;  comp = topk(carried);
      sent = dequantize(quantize(comp as rows of one block));
      new_e = carried - sent;  acc += w_i * sent.
  Client weights are normalized in float64, then cast to fp32.
* With ``masks`` (HeteroFL width rows, ``fl/hetero.py``) each coordinate
  averages over the clients whose mask covers it: plain averaging is
  ``w @ (masks * deltas)`` over ``w @ masks``, and the compression loop
  masks the delta before the carry and the sent row after the wire
  (``den += w_i * m``).  The apply is the guarded quotient
  ``where(den > 0, acc, 0) / where(den > 0, den, 1)``, so a coordinate no
  client covers keeps its value bit for bit.
* ``ServerStep.reduce`` is the same pipeline without the apply: the edge
  tier of the two-tier server (``fl/hierarchy.py``), whose ``(E, padded)``
  rows ``RootStep`` combines and applies at the root.  ``__call__`` is
  reduce then apply, in the same operations as before the split.
"""
from __future__ import annotations

import weakref
from typing import Any, List, Optional, Sequence, Tuple

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
from repro_torch.tree import (
    tree_leaves,
    tree_map,
    tree_structure,
    tree_unflatten,
)

Params = Any


class FlatLayout:
    """Per-leaf (shape, dtype, offset, size) for one parameter structure,
    offsets aligned to ``block``."""

    def __init__(self, params: Params, block: int = 1024):
        self.block = int(block)
        self.structure = tree_structure(params)
        leaves = tree_leaves(params)
        self.shapes = tuple(tuple(leaf.shape) for leaf in leaves)
        self.dtypes = tuple(leaf.dtype for leaf in leaves)
        # fp32 params round-trip through the flat buffer without rounding:
        # the async loop checkpoints in-flight deltas as flat rows, which
        # is bitwise only then
        self.exact_fp32 = all(d == torch.float32 for d in self.dtypes)
        self.sizes = tuple(int(np.prod(s)) if s else 1 for s in self.shapes)
        self.segs = tuple(-(-sz // self.block) * self.block
                          for sz in self.sizes)
        self.offsets = tuple(int(o) for o in
                             np.cumsum((0,) + self.segs[:-1]))
        self.size = int(sum(self.sizes))      # true element count
        self.padded = int(sum(self.segs))     # buffer length (block-aligned)

    def flatten(self, params: Params,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Params -> contiguous fp32 ``(padded,)`` buffer on their device;
        with ``out`` (a zeroed ``(padded,)`` fp32 row) the leaves are
        written into it in place and ``out`` is returned."""
        leaves = tree_leaves(params)
        if out is not None:
            for leaf, off, sz in zip(leaves, self.offsets, self.sizes):
                out[off:off + sz] = leaf.detach().reshape(-1)
            return out
        parts = [F.pad(leaf.detach().reshape(-1).to(torch.float32),
                       (0, seg - sz))
                 for leaf, sz, seg in zip(leaves, self.sizes, self.segs)]
        return torch.cat(parts)

    def unflatten(self, buf: torch.Tensor) -> Params:
        """Exact inverse of ``flatten`` (padding dropped, dtypes restored;
        fresh tensors in the params' nesting)."""
        return tree_unflatten(self.structure, (
            buf[off:off + sz].reshape(shape).to(dtype, copy=True)
            for off, sz, shape, dtype in
            zip(self.offsets, self.sizes, self.shapes, self.dtypes)))

    def copy(self, buf: torch.Tensor) -> torch.Tensor:
        """Bitwise copy of a flat buffer into a fresh one (the reference's
        donated-copy identity): the copy's owner may keep it while the
        source's owner overwrites or frees its own."""
        return buf.detach().clone(memory_format=torch.contiguous_format)

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
        ``(R, padded)``, each row flattened into its place and the global
        subtracted in place (no second ``(R, padded)`` buffer: at an LM's
        size each row is the whole model)."""
        if isinstance(rows, list):
            out = torch.zeros((len(rows), self.padded), dtype=torch.float32,
                              device=g_flat.device)
            for i, r in enumerate(rows):
                self.flatten(r, out=out[i])
            return out.sub_(g_flat[None])
        return self.flatten_stacked(rows.tree).sub_(g_flat[None])

    def block_meta(self, density: float) -> np.ndarray:
        """Per-block ``(valid, k)`` rows over the whole buffer, each leaf's
        budget from its true (unpadded) element count."""
        return np.concatenate([density_block_meta(sz, self.block, density)
                               for sz in self.sizes], axis=0)


def _normalized_f64(weights: Sequence[float],
                    device: torch.device) -> torch.Tensor:
    """Weights normalized in float64, then cast to fp32 on ``device``."""
    w = np.asarray(weights, np.float64)
    return torch.as_tensor(w / w.sum(), dtype=torch.float32, device=device)


def _apply(g_flat: torch.Tensor, acc: torch.Tensor,
           den: Optional[torch.Tensor]) -> torch.Tensor:
    """``g + acc``; under width masks ``g + acc / den`` where ``den > 0``
    and ``g + 0`` where no client covers the coordinate."""
    if den is None:
        return g_flat + acc
    covered = den > 0
    return g_flat + (torch.where(covered, acc, 0.0)
                     / torch.where(covered, den, 1.0))


class ServerStep:
    """One server round over the flat buffer: call with the flat global,
    the stacked deltas ``(K, padded)``, per-client weights, (when
    ``density < 1``) the matching error-feedback rows and (under HeteroFL
    widths) the clients' 0/1 mask rows; returns the new flat global and the
    new error rows."""

    def __init__(self, layout: FlatLayout, density: float = 1.0,
                 quantize: bool = False):
        self.layout = layout
        self.density = float(density)
        self.quantize = bool(quantize)
        self.track_errors = self.density < 1.0
        # the per-block (valid, k) table, moved to the buffers' device once
        self._meta = (torch.from_numpy(layout.block_meta(self.density))
                      if self.track_errors else None)

    def _reduce_core(self, deltas: torch.Tensor, w: torch.Tensor,
                     errors: Optional[torch.Tensor],
                     masks: Optional[torch.Tensor]):
        """``(acc, den, new_err)``: the weighted (masked) sum of the sent
        rows, the per-coordinate covered weight (``None`` unmasked) and the
        new error rows (``None`` without top-k)."""
        if not self.track_errors and not self.quantize:
            if masks is None:
                return w @ deltas, None, None
            return w @ (masks * deltas), w @ masks, None
        block = self.layout.block
        if self.track_errors and self._meta.device != deltas.device:
            self._meta = self._meta.to(deltas.device)
        acc = torch.zeros_like(deltas[0])
        den = torch.zeros_like(acc) if masks is not None else None
        new_err = torch.empty_like(errors) if self.track_errors else None
        for i in range(deltas.shape[0]):
            d = deltas[i] if masks is None else masks[i] * deltas[i]
            carried = d + errors[i] if self.track_errors else d
            comp = (topk_compress_flat(carried[None], self._meta, block)[0]
                    if self.track_errors else carried)
            if self.quantize:
                q, s = quantize_rows(comp.view(-1, block))
                sent = dequantize_rows(q, s).view(-1)
            else:
                sent = comp
            if masks is not None:
                sent = masks[i] * sent
                den = den + w[i] * masks[i]
            if self.track_errors:
                new_err[i] = carried - sent
            acc = acc + w[i] * sent
        return acc, den, new_err

    def __call__(self, g_flat: torch.Tensor, deltas: torch.Tensor,
                 weights: Sequence[float],
                 errors: Optional[torch.Tensor] = None,
                 masks: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``masks`` (``(K, padded)`` 0/1 rows stacked as ``deltas``)
        switches on the coverage-count average; ``None`` keeps the
        homogeneous step."""
        acc, den, new_err = self._reduce_core(
            deltas, _normalized_f64(weights, g_flat.device), errors, masks)
        return _apply(g_flat, acc, den), new_err

    def reduce(self, deltas: torch.Tensor, weights: Sequence[float],
               errors: Optional[torch.Tensor] = None,
               masks: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                          Optional[torch.Tensor]]:
        """The edge tier: ``__call__``'s pipeline without the apply.
        Returns ``(acc, den, new_err)``: one pre-reduced row (weights
        normalized within this edge), the covered weight under ``masks``
        (else ``None``) and the members' new error rows."""
        return self._reduce_core(
            deltas, _normalized_f64(weights, deltas.device), errors, masks)


class RootStep:
    """The root tier of the two-tier server: combine the edges' ``(E,
    padded)`` pre-reduced rows, each weighted by its edge's share of the
    survivors' weight mass, and apply to the flat global: ``g + w @ nums``,
    or under width masks the guarded quotient of ``w @ nums`` over ``w @
    dens``.  ``calls`` counts applications."""

    def __init__(self, padded: int):
        self.padded = int(padded)
        self.calls = 0

    def __call__(self, g_flat: torch.Tensor, nums: torch.Tensor,
                 weights: Sequence[float],
                 dens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``weights``: the edges' raw weight masses (normalized here in
        float64, then cast to fp32, as ``ServerStep`` does)."""
        w = _normalized_f64(weights, g_flat.device)
        self.calls += 1
        return _apply(g_flat, w @ nums, None if dens is None else w @ dens)


_ROOT_STEPS: "weakref.WeakKeyDictionary[FlatLayout, RootStep]" = \
    weakref.WeakKeyDictionary()


def get_root_step(layout: FlatLayout) -> RootStep:
    """The layout's one ``RootStep`` (held as long as the layout is), so
    the loops and their callers share its ``calls``."""
    if layout not in _ROOT_STEPS:
        _ROOT_STEPS[layout] = RootStep(layout.padded)
    return _ROOT_STEPS[layout]


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
    masks: Optional[torch.Tensor] = None,
) -> Tuple[Params, Optional[torch.Tensor]]:
    """Per-leaf, per-client server step with the fused ``ServerStep``'s
    algorithm: error-feedback carry, per-leaf top-k (``compress_tree``, a
    budget from each leaf's true size), optional int8 wire format, weighted
    apply (``fedavg_apply_deltas``).  ``errors`` are flat ``(len(deltas),
    padded)`` rows, as the loop keeps them; returns ``(params, new error
    rows)``.

    ``masks`` (flat 0/1 width rows, stacked as ``errors``) selects the
    coverage-count oracle: each client's delta and sent tree are masked,
    and every coordinate averages ``sum_i w_i m_i s_i`` over ``sum_i w_i
    m_i`` (accumulated client by client), keeping its value where no
    client covers it."""
    track = density < 1.0
    mask_trees = ([layout.unflatten(masks[i]) for i in range(len(deltas))]
                  if masks is not None else None)
    sents, new_err_rows = [], []
    for i, delta in enumerate(deltas):
        if mask_trees is not None:
            delta = tree_map(lambda m, d: m.to(torch.float32)
                             * d.to(torch.float32), mask_trees[i], delta)
        if track:
            err_tree = layout.unflatten(errors[i])
            carried = tree_map(lambda d, e: d.to(torch.float32)
                               + e.to(torch.float32), delta, err_tree)
            comp, _ = compress_tree(delta, err_tree, density=density,
                                    block=layout.block)
        else:
            carried, comp = None, delta
        sent = quantize_delta_flat(layout, comp) if quantize else comp
        if mask_trees is not None:
            sent = tree_map(lambda m, x: m.to(torch.float32) * x,
                            mask_trees[i], sent)
        if track:
            new_err_rows.append(layout.flatten(
                tree_map(lambda c, x: c - x, carried, sent)))
        sents.append(sent)
    new_err = torch.stack(new_err_rows) if track else None
    if mask_trees is None:
        return fedavg_apply_deltas(params, sents, weights), new_err
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    num = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    den = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    for wi, sent, mask in zip(w, sents, mask_trees):
        wi = torch.tensor(wi, dtype=torch.float32)
        num = tree_map(lambda a, x: a + wi * x, num, sent)
        den = tree_map(lambda a, m: a + wi * m.to(torch.float32), den, mask)
    return tree_map(lambda p, n, d: _apply(p.to(torch.float32), n, d)
                    .to(p.dtype), params, num, den), new_err
