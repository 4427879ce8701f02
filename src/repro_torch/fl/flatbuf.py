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
* ``ShardedFlatLayout`` / ``ShardedServerStep`` run the step over a
  ``(data, model)`` mesh (``parallel.sharding.make_flat_mesh``, behind
  ``FLConfig.mesh_shape``): the buffer gains a zero tail so it splits into
  ``model`` shards of whole blocks (``flat_shard_tail``; the tail's blocks
  carry ``(valid=0, k=1)`` metadata), client rows split along ``data``.
  Averaging is the single-device program.  The compression paths run the
  reference's ``shard_map`` body once per place ``(i, j)``: data shard
  ``i``'s rows (zero-padded, at zero weight, to a multiple of ``data``)
  over model shard ``j``'s lanes, through top-k with that shard's slice of
  the metadata (``topk_compress_rows``) and the int8 pair over its rows of
  one block; each model shard's partial sums then add over ``data`` in
  place order (``parallel.sharding.psum``) and gather back to the mesh's
  home place, where the global buffers stay one tensor.  Every op is
  block-local and shards are whole blocks, so ``data = 1`` is the
  single-device step bit for bit; ``data > 1`` adds the partial sums in
  another order (fp32 tolerance).  ``layout_of`` and ``get_server_step``
  pick the sharded classes for a mesh.
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
    topk_compress_rows,
)
from repro_torch.parallel.sharding import flat_shard_tail, psum
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
        return self._cat(parts, 0)

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
        return self._cat(parts, 1)

    def _cat(self, parts: List[torch.Tensor], dim: int) -> torch.Tensor:
        """The leaves' padded segments, joined along the buffer's dim."""
        return torch.cat(parts, dim=dim)

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


class ShardedFlatLayout(FlatLayout):
    """``FlatLayout`` over a ``(data, model)`` mesh: the flat vector splits
    along ``model`` in whole blocks, stacked client rows along ``data``.

    The buffer gains ``tail`` zero lanes (``flat_shard_tail``) so its block
    count divides the model-axis size: every shard owns ``shard_elems``
    distinct lanes, the tail's blocks carry ``(valid=0, k=1)`` metadata and
    stay zero in every delta and EF row.  Buffers stay one tensor on the
    caller's device (the mesh's home place): the loops, checkpoints and hot
    swap never see the mesh.  ``unflatten`` reads only the leaf segments,
    so round trips stay bitwise."""

    def __init__(self, params: Params, mesh, block: int = 1024):
        super().__init__(params, block=block)
        if not {"data", "model"} <= set(mesh.shape):
            raise ValueError(f"mesh axes {tuple(mesh.shape)} must include "
                             f"'data' and 'model'")
        self.mesh = mesh
        self.data_size = int(mesh.shape["data"])
        self.model_size = int(mesh.shape["model"])
        self.base_padded = self.padded
        self.tail = flat_shard_tail(self.padded, self.block, self.model_size)
        self.padded += self.tail
        self.shard_elems = self.padded // self.model_size

    def _cat(self, parts: List[torch.Tensor], dim: int) -> torch.Tensor:
        if self.tail:
            shape = list(parts[0].shape)
            shape[dim] = self.tail
            parts = parts + [parts[0].new_zeros(shape)]
        return torch.cat(parts, dim=dim)

    def block_meta(self, density: float) -> np.ndarray:
        """The base per-leaf ``(valid, k)`` rows plus ``(0, 1)`` rows over
        the tail's blocks (they keep lane 0 of an all-zero block, so the
        tail stays exactly zero in the output and the error feedback)."""
        rows = super().block_meta(density)
        if not self.tail:
            return rows
        return np.concatenate([rows, np.tile(np.asarray([[0, 1]], np.int32),
                                             (self.tail // self.block, 1))])


def layout_of(params: Params, block: int = 1024, mesh=None) -> FlatLayout:
    """The flat layout of a params tree: ``FlatLayout``, or with ``mesh``
    (``parallel.sharding.make_flat_mesh``) the ``ShardedFlatLayout``."""
    if mesh is None:
        return FlatLayout(params, block=block)
    return ShardedFlatLayout(params, mesh, block=block)


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
        self._kmax = (int(self._meta[:, 1].max()) if self.track_errors
                      else 0)

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
        if self.track_errors and self._meta.device != deltas.device:
            self._meta = self._meta.to(deltas.device)
        acc = torch.zeros_like(deltas[0])
        den = torch.zeros_like(acc) if masks is not None else None
        new_err = torch.empty_like(errors) if self.track_errors else None
        for i in range(deltas.shape[0]):
            m = masks[i] if masks is not None else None
            carried, sent = self._send(
                deltas[i], errors[i] if self.track_errors else None, m,
                self._meta)
            if m is not None:
                den = den + w[i] * m
            if self.track_errors:
                new_err[i] = carried - sent
            acc = acc + w[i] * sent
        return acc, den, new_err

    def _send(self, d: torch.Tensor, e: Optional[torch.Tensor],
              m: Optional[torch.Tensor], meta: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One client row (or its lanes of one model shard) through the
        wire: ``(carried, sent)``.  ``meta`` is the lanes' ``(valid, k)``
        table."""
        block = self.layout.block
        if m is not None:
            d = m * d
        carried = d + e if self.track_errors else d
        comp = (topk_compress_rows(carried[None], meta, self._kmax,
                                   block)[0]
                if self.track_errors else carried)
        if self.quantize:
            q, s = quantize_rows(comp.view(-1, block))
            sent = dequantize_rows(q, s).view(-1)
        else:
            sent = comp
        if m is not None:
            sent = m * sent
        return carried, sent

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


class ShardedServerStep(ServerStep):
    """``ServerStep`` over a ``ShardedFlatLayout``'s mesh: the same call
    contract (buffers on the mesh's home place) and the same numbers.

    Averaging (no top-k, no int8) is the inherited program.  The
    compression paths run once per place ``(i, j)``: the rows of data shard
    ``i`` (the ``K`` rows padded with zero rows of zero weight to a
    multiple of ``data``) over the lanes of model shard ``j``, sent to that
    place (views when the places coincide), through ``_send`` with the
    shard's slice of the block metadata, accumulated ``acc += w_i * sent``
    in row order.  Each model shard's partial sums then add over ``data``
    in place order and gather to the home place, where ``__call__``
    applies them (elementwise, so the values an apply per shard gives); the
    pad rows' EF rows are dropped.  Top-k and the int8 pair launch once per
    (padded row, model shard)."""

    def __init__(self, layout: ShardedFlatLayout, density: float = 1.0,
                 quantize: bool = False):
        if not isinstance(layout, ShardedFlatLayout):
            raise TypeError("ShardedServerStep needs a ShardedFlatLayout; "
                            "use ServerStep for the single-device layout")
        super().__init__(layout, density=density, quantize=quantize)
        self.mesh = layout.mesh
        self.data_size = layout.data_size
        self._metas = {}

    def _meta_on(self, place: torch.device) -> torch.Tensor:
        if place not in self._metas:
            self._metas[place] = self._meta.to(place)
        return self._metas[place]

    def _reduce_core(self, deltas, w, errors, masks):
        if not self.track_errors and not self.quantize:
            return super()._reduce_core(deltas, w, errors, masks)
        lay, home = self.layout, deltas.device
        K, data = int(deltas.shape[0]), self.data_size
        rows = (K + (-K) % data) // data         # padded rows a data shard
        S, nbs = lay.shard_elems, lay.shard_elems // lay.block
        new_err = torch.empty_like(errors) if self.track_errors else None
        accs, dens = [], []
        for j in range(lay.model_size):
            lanes = slice(j * S, (j + 1) * S)
            acc_j, den_j = [], []
            for i in range(data):
                place = self.mesh.devices[i, j]
                meta = (self._meta_on(place)[j * nbs:(j + 1) * nbs]
                        if self.track_errors else None)
                w_p = w.to(place)
                zero = torch.zeros(S, dtype=torch.float32, device=place)
                acc = zero
                den = zero if masks is not None else None
                for r in range(i * rows, (i + 1) * rows):
                    if r < K:
                        d = deltas[r, lanes].to(place)
                        e = (errors[r, lanes].to(place)
                             if self.track_errors else None)
                        m = (masks[r, lanes].to(place)
                             if masks is not None else None)
                        wr = w_p[r]
                    else:    # a pad row: zero delta, error and weight
                        d, wr = zero, w_p.new_zeros(())
                        e = zero if self.track_errors else None
                        m = zero if masks is not None else None
                    carried, sent = self._send(d, e, m, meta)
                    if m is not None:
                        den = den + wr * m
                    if self.track_errors and r < K:
                        new_err[r, lanes] = carried - sent
                    acc = acc + wr * sent
                acc_j.append(acc)
                den_j.append(den)
            first = self.mesh.devices[0, j]
            accs.append(psum(acc_j, first).to(home))
            if masks is not None:
                dens.append(psum(den_j, first).to(home))
        acc = accs[0] if len(accs) == 1 else torch.cat(accs)
        den = None
        if masks is not None:
            den = dens[0] if len(dens) == 1 else torch.cat(dens)
        return acc, den, new_err


def get_server_step(layout: FlatLayout, density: float = 1.0,
                    quantize: bool = False) -> ServerStep:
    """The server step for a layout: ``ShardedServerStep`` for a
    ``ShardedFlatLayout``, else ``ServerStep``."""
    cls = (ShardedServerStep if isinstance(layout, ShardedFlatLayout)
           else ServerStep)
    return cls(layout, density=density, quantize=quantize)


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
