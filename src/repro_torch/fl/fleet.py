"""Local training of one round (counterpart of ``repro/fl/fleet.py``):
K clients each run ``local_iters`` SGD steps from the same global params.
Two engines implement it (``FLConfig.engine``):

* ``SequentialEngine``: one client after another, one step per local
  iteration.
* ``BatchedEngine``: clients grouped by their planned OP and chunked to
  ``max_group``; each chunk trains as one batched step per local iteration,
  ``torch.func.vmap`` over the clients of ``torch.func.grad`` of the loss
  through the cut (the reference's ``jit(vmap(scan))``, with the scan a
  Python loop).  Batches are drawn host-side from the same per-client
  streams (``FleetLoader.next_batches``) and augmented by the same keyed
  flips, so a seed gives the sequential engine's history up to fp32
  summation order.  Under vmap the int8 cut quantizes the chunk's stacked
  activations in one call (``kernels.quant_transfer._FakeQuantInt8.vmap``).

With ``hetero`` (``fl/hetero.HeteroSpec``, HeteroFL widths) a client
starts from ``mask * params`` and steps ``p - lr * (mask * g)``: the
gradient is masked first, then scaled, as in the reference.  The batched
engine then groups by ``(OP, width)``, in the order the clients first
appear; a chunk shares one mask, which broadcasts over the client axis
like the params.  ``hetero=None`` is the homogeneous step, bit for bit.

Both train VGG on image batches and every LM family on token batches
(the VLM's patches and encdec's frames ride in the batch like any other
key; only images are flipped).  Under the batched engine's ``vmap`` an
LM's layers and CE chunks are rematerialised as in the sequential engine
(``models.layers.remat``: the forward and its recompute are each one
vmapped call), the flash-attention Functions fold the clients into their
kernels' batch axis, and the SSD scan's run once a client (each client
holds its own ``A``, and a kernel call takes one); the MoE dispatch
(``models.layers.moe_dispatch``) runs out of place with no host read, its
capacity counting one client's tokens.

With a mesh (``FLConfig.mesh_shape``, ``parallel.sharding
.make_flat_mesh``) the batched engine goes mesh-parallel
(``make_sharded_fleet_step``): chunks pad to a multiple of the ``data``
axis (``client_chunk_pad``; the pad rows repeat the first client's
augmented rows, draw nothing and are dropped after the step), each data
shard's clients train on place ``(i, 0)`` from params copied there, and the
outputs concatenate back on the home place.  Clients are independent, so
there are no collectives; model-axis places would only repeat the same
clients' work, so they compute nothing.  ``data = 1`` is the mesh-less
engine bit for bit.  The sequential engine accepts a mesh and ignores it.

Both return ``(idxs, rows)``: the trained clients and their parameters, a
list of per-client trees (sequential) or one ``StackedRows`` tree whose
leaves carry a leading client axis (batched).  ``take_rows`` and
``rows_as_list`` adapt either form for the aggregation paths.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.loader import FleetLoader
from repro_torch.fl.flatbuf import Params
from repro_torch.models.split_program import SplitProgram
from repro_torch.parallel.sharding import client_chunk_pad
from repro_torch.tree import tree_leaves, tree_map


def flip_augment(images: np.ndarray, seed: int, round_idx: int, client: int,
                 it: int) -> np.ndarray:
    """Horizontal flip with p=0.5 (paper §V-B), keyed by
    ``(seed, round, client, iter)``: the reference's exact stream."""
    rng = np.random.RandomState(
        (seed * 1_000_003 + round_idx * 1009 + client * 31 + it) % (2 ** 31))
    flip = rng.rand(len(images)) < 0.5
    return np.where(flip[:, None, None, None], images[:, :, ::-1, :], images)


def fleet_step(program: SplitProgram, quantize: bool, params: Params,
               batches: Dict[str, torch.Tensor], lr: torch.Tensor, op: int,
               mask: Params = None) -> Params:
    """One OP-group chunk's round: every client starts from ``params``
    (``mask * params`` under a width mask), copied once a client, then
    ``client_iterations``.  ``batches`` leaves are ``(C, I, B, ...)``.
    Returns the stacked final params."""
    C = batches["labels"].shape[0]
    if mask is not None:
        params = tree_map(lambda v, m: m * v, params, mask)
    start = tree_map(lambda v: v.detach().expand(C, *v.shape).clone(),
                     params)
    return client_iterations(program, quantize, start, batches, lr, op,
                             mask)


def client_iterations(program: SplitProgram, quantize: bool, p: Params,
                      batches: Dict[str, torch.Tensor], lr: torch.Tensor,
                      op: int, mask: Params = None) -> Params:
    """The clients' local iterations from their stacked start ``p`` (every
    leaf ``(C, ...)``): each one vmap over the clients of the loss's
    gradient and the SGD step ``p - lr * g`` (``p - lr * (mask * g)``,
    the unbatched mask broadcasting over the clients)."""

    def loss(p, batch):
        return program.loss_through_cut(p, batch, op, quantize=quantize)

    step = torch.func.vmap(torch.func.grad(loss))
    for it in range(batches["labels"].shape[1]):
        grads = step(p, {key: v[:, it] for key, v in batches.items()})
        if mask is None:
            p = tree_map(lambda q, g: q - lr * g, p, grads)
        else:
            p = tree_map(lambda q, g, m: q - lr * (m * g), p, grads, mask)
    return p


def _sharded_round(program: SplitProgram, quantize: bool, mesh,
                   params: Params, shards: List[Dict[str, torch.Tensor]],
                   lr: torch.Tensor, op: int, mask: Params = None
                   ) -> Params:
    """``fleet_step`` once per data shard, on place ``(i, 0)`` from params
    (and mask) copied there; the outputs concatenated on the home place
    in shard order."""
    home = mesh.home
    outs = []
    for i, batches in enumerate(shards):
        place = mesh.devices[i, 0]
        outs.append(fleet_step(
            program, quantize, tree_map(lambda v: v.to(place), params),
            batches, lr.to(place), op,
            tree_map(lambda v: v.to(place), mask) if mask is not None
            else None))
    if len(outs) == 1:
        return tree_map(lambda a: a.to(home), outs[0])
    return tree_map(lambda *xs: torch.cat([x.to(home) for x in xs]), *outs)


def make_sharded_fleet_step(program: SplitProgram, quantize: bool, mesh):
    """The mesh-parallel chunk round ``(params, shards, lr, op) ->
    stacked final params``: ``shards`` is ``SplitProgram.shard_batches``'s
    list, one batch dict a data shard on its place."""

    def step(params, shards, lr, op):
        return _sharded_round(program, quantize, mesh, params, shards, lr,
                              op)
    return step


def make_sharded_fleet_step_masked(program: SplitProgram, quantize: bool,
                                   mesh):
    """The width-masked variant ``(params, mask, shards, lr, op)``: the
    chunk's one mask goes to every shard with the params."""

    def step(params, mask, shards, lr, op):
        return _sharded_round(program, quantize, mesh, params, shards, lr,
                              op, mask)
    return step


class SequentialEngine:
    """One client at a time, one SGD step per local iteration.  ``mesh``
    is accepted and ignored, as the reference's engine does: the
    sequential engine trains on the run's device."""

    def __init__(self, program: SplitProgram, local_iters: int, seed: int,
                 augment: bool, quantize: bool, device: torch.device,
                 mesh=None):
        self.program = program
        self.local_iters = local_iters
        self.seed = seed
        self.augment = augment
        self.quantize = quantize
        self.device = device

    def _batch(self, loader: FleetLoader, k: int, round_idx: int, it: int):
        """Client ``k``'s next batch on the device, every key of it (VGG's
        images and labels; an LM's tokens and labels, with the VLM's
        patches or encdec's frames); only images are flipped."""
        batch = loader.next_batch(k)
        if self.augment and "images" in batch:
            batch["images"] = flip_augment(batch["images"], self.seed,
                                           round_idx, k, it)
        return {key: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for key, v in batch.items()}

    def run_round(self, params: Params, loader: FleetLoader,
                  ops: Sequence[int], alive_idx: Sequence[int],
                  round_idx: int, lr: float, hetero=None
                  ) -> Tuple[List[int], List[Params]]:
        # lr as an fp32 scalar on the device, as the reference passes it
        lr_t = torch.tensor(lr, dtype=torch.float32, device=self.device)
        out: List[Params] = []
        for k in alive_idx:
            # each client trains its own copy, updated in place
            start = hetero.apply(params, k) if hetero is not None else params
            p_k = tree_map(lambda v: v.detach().clone().requires_grad_(),
                           start)
            leaves = tree_leaves(p_k)
            masks = (tree_leaves(hetero.mask_tree(k)) if hetero is not None
                     else None)
            for it in range(self.local_iters):
                batch = self._batch(loader, k, round_idx, it)
                loss = self.program.loss_through_cut(
                    p_k, batch, int(ops[k]), quantize=self.quantize)
                grads = torch.autograd.grad(loss, leaves)
                if masks is not None:
                    grads = [m * g for m, g in zip(masks, grads)]
                with torch.no_grad():
                    for p, g in zip(leaves, grads):
                        p.sub_(lr_t * g)
            out.append(tree_map(lambda v: v.detach(), p_k))
        return list(alive_idx), out


@dataclasses.dataclass
class StackedRows:
    """Per-client parameters as one tree with a leading ``(K, ...)`` client
    axis on every leaf: a type of its own, since a params tree is itself a
    list (VGG's per-layer list) and must not be taken for a list of
    clients."""

    tree: Any

    def __len__(self) -> int:
        return int(tree_leaves(self.tree)[0].shape[0])


class BatchedEngine:
    """One batched step per (OP group chunk, local iteration).

    ``max_group`` caps the clients fused into one chunk (the reference's
    default of 8).  A short tail chunk of a group larger than that pads up
    to the chunk size by repeating its first client's (augmented) rows,
    drawing no extra batches, and the padding rows' results are dropped,
    so chunk shapes do not vary with K % max_group.  With ``mesh`` the
    chunk size rounds up to a multiple of the ``data`` axis, a group's one
    chunk pads to the next multiple of it (``client_chunk_pad``), and each
    chunk trains through ``make_sharded_fleet_step``."""

    def __init__(self, program: SplitProgram, local_iters: int, seed: int,
                 augment: bool, quantize: bool, device: torch.device,
                 max_group: int = 8, mesh=None):
        self.program = program
        self.local_iters = local_iters
        self.seed = seed
        self.augment = augment
        self.quantize = quantize
        self.device = device
        self.max_group = max(1, int(max_group))
        self.mesh = mesh
        self.data_size = int(mesh.shape["data"]) if mesh is not None else 1
        # the smallest multiple of the data axis >= max_group
        self.chunk = -(-self.max_group // self.data_size) * self.data_size
        if mesh is not None:
            self._step = make_sharded_fleet_step(program, quantize, mesh)
            self._step_masked = make_sharded_fleet_step_masked(
                program, quantize, mesh)

    def _group(self, ops: Sequence[int], alive_idx: Sequence[int],
               hetero=None) -> Dict[Tuple[int, float], List[int]]:
        """Clients that can share a chunk: the same OP and width, keyed in
        the order they first appear (the survivors' order, and so the
        server step's summation order)."""
        groups: Dict[Tuple[int, float], List[int]] = {}
        for k in alive_idx:
            width = hetero.width(k) if hetero is not None else 1.0
            groups.setdefault((int(ops[k]), width), []).append(k)
        return groups

    def _stack_round(self, loader: FleetLoader, ks: List[int],
                     round_idx: int, pad_to: int):
        """The chunk's whole round of data, drawn host-side iteration by
        iteration from each client's stream, augmented and stacked ``(C,
        I, B, ...)``: moved to the device once, or on a mesh split along
        ``data`` onto the shards' places (``SplitProgram.shard_batches``)."""
        per_iter = []
        for it in range(self.local_iters):
            nb = loader.next_batches(ks, pad_to=pad_to)       # (C, B, ...)
            if self.augment and "images" in nb:
                imgs = np.stack([flip_augment(nb["images"][i], self.seed,
                                              round_idx, k, it)
                                 for i, k in enumerate(ks)])
                if pad_to > len(ks):   # padding rows repeat augmented row 0
                    imgs = np.concatenate(
                        [imgs, np.repeat(imgs[:1], pad_to - len(ks), 0)])
                nb["images"] = imgs
            per_iter.append(nb)
        host = {key: torch.from_numpy(np.stack([b[key] for b in per_iter],
                                               axis=1))
                for key in per_iter[0]}
        if self.mesh is not None:
            return self.program.shard_batches(host, self.mesh)
        return {key: v.to(self.device) for key, v in host.items()}

    def _fleet_step(self, params: Params, batches, lr: torch.Tensor,
                    op: int, mask: Params = None) -> Params:
        if self.mesh is not None:
            if mask is None:
                return self._step(params, batches, lr, op)
            return self._step_masked(params, mask, batches, lr, op)
        return fleet_step(self.program, self.quantize, params, batches, lr,
                          op, mask)

    def run_round(self, params: Params, loader: FleetLoader,
                  ops: Sequence[int], alive_idx: Sequence[int],
                  round_idx: int, lr: float, hetero=None
                  ) -> Tuple[List[int], StackedRows]:
        lr_t = torch.tensor(lr, dtype=torch.float32, device=self.device)
        idxs: List[int] = []
        stacked: List[Params] = []
        for (op, _), all_ks in self._group(ops, alive_idx, hetero).items():
            mask = hetero.mask_tree(all_ks[0]) if hetero is not None else None
            for i in range(0, len(all_ks), self.chunk):
                ks = all_ks[i:i + self.chunk]
                # the tail chunk of a group split into several pads to the
                # chunk size; a group's one chunk only to the data axis
                pad_to = (self.chunk if len(all_ks) > len(ks) else
                          len(ks) + client_chunk_pad(len(ks),
                                                     self.data_size))
                finals = self._fleet_step(
                    params, self._stack_round(loader, ks, round_idx, pad_to),
                    lr_t, op, mask)
                if pad_to > len(ks):
                    finals = tree_map(lambda a: a[:len(ks)], finals)
                idxs.extend(ks)
                stacked.append(finals)
        if not stacked:
            return [], StackedRows(None)
        rows = stacked[0] if len(stacked) == 1 else tree_map(
            lambda *xs: torch.cat(xs, dim=0), *stacked)
        return idxs, StackedRows(rows)


ENGINES = {"sequential": SequentialEngine, "batched": BatchedEngine}


def get_engine(name: str, program: SplitProgram, local_iters: int, seed: int,
               augment: bool, quantize: bool, device: torch.device,
               mesh=None):
    """The configured fleet engine (the batched one with its default
    ``max_group``, as the reference builds it); ``mesh`` makes the batched
    engine mesh-parallel, and the sequential engine ignores it."""
    try:
        cls = ENGINES[name]
    except KeyError:
        raise ValueError(f"unknown fleet engine {name!r}; "
                         f"known: {sorted(ENGINES)}") from None
    return cls(program, local_iters, seed, augment, quantize, device,
               mesh=mesh)


# -----------------------------------------------------------------------------
# row adapters: the aggregation paths accept either engine's output
# -----------------------------------------------------------------------------
def take_rows(rows, positions: Sequence[int]):
    """Client rows by position in the engine's output order, keeping the
    representation: list -> sub-list, StackedRows -> gathered
    StackedRows."""
    if isinstance(rows, StackedRows):
        sel = list(positions)
        return StackedRows(tree_map(
            lambda a: a[torch.as_tensor(sel, dtype=torch.int64,
                                        device=a.device)], rows.tree))
    return [rows[i] for i in positions]


def rows_as_list(rows, positions: Sequence[int]) -> List[Params]:
    """Per-client trees, for the per-client reference server step."""
    if isinstance(rows, StackedRows):
        return [tree_map(lambda a: a[i], rows.tree) for i in positions]
    return [rows[i] for i in positions]
