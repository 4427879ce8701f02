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
LM's layers are not rematerialised (``models.layers.remat``), the
flash-attention Functions fold the clients into their kernels' batch
axis, and the SSD scan's run once a client (each client holds its own
``A``, and a kernel call takes one); the MoE dispatch
(``models.layers.moe_dispatch``) runs out of place with no host read, its
capacity counting one client's tokens.

Both return ``(idxs, rows)``: the trained clients and their parameters, a
list of per-client trees (sequential) or one ``StackedRows`` tree whose
leaves carry a leading client axis (batched).  ``take_rows`` and
``rows_as_list`` adapt either form for the aggregation paths.  (The
reference's mesh-parallel fleet step waits for the port's multi-device
item.)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.loader import FleetLoader
from repro_torch.fl.flatbuf import Params
from repro_torch.models.split_program import SplitProgram
from repro_torch.tree import tree_leaves, tree_map


def flip_augment(images: np.ndarray, seed: int, round_idx: int, client: int,
                 it: int) -> np.ndarray:
    """Horizontal flip with p=0.5 (paper §V-B), keyed by
    ``(seed, round, client, iter)``: the reference's exact stream."""
    rng = np.random.RandomState(
        (seed * 1_000_003 + round_idx * 1009 + client * 31 + it) % (2 ** 31))
    flip = rng.rand(len(images)) < 0.5
    return np.where(flip[:, None, None, None], images[:, :, ::-1, :], images)


class SequentialEngine:
    """One client at a time, one SGD step per local iteration."""

    def __init__(self, program: SplitProgram, local_iters: int, seed: int,
                 augment: bool, quantize: bool, device: torch.device):
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
    to ``max_group`` by repeating its first client's (augmented) rows,
    drawing no extra batches, and the padding rows' results are dropped,
    so chunk shapes do not vary with K % max_group."""

    def __init__(self, program: SplitProgram, local_iters: int, seed: int,
                 augment: bool, quantize: bool, device: torch.device,
                 max_group: int = 8):
        self.program = program
        self.local_iters = local_iters
        self.seed = seed
        self.augment = augment
        self.quantize = quantize
        self.device = device
        self.chunk = max(1, int(max_group))

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
                     round_idx: int, pad_to: int) -> Dict[str, torch.Tensor]:
        """The chunk's whole round of data, drawn host-side iteration by
        iteration from each client's stream, augmented, stacked
        ``(C, I, B, ...)`` and moved to the device once."""
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
        return {key: torch.from_numpy(np.stack([b[key] for b in per_iter],
                                               axis=1)).to(self.device)
                for key in per_iter[0]}

    def _fleet_step(self, params: Params, batches: Dict[str, torch.Tensor],
                    lr: torch.Tensor, op: int, mask: Params = None
                    ) -> Params:
        """Every client of the chunk starts from ``params`` (``mask *
        params`` under a width mask); each local iteration is one vmap over
        the clients of the loss's gradient and the SGD step ``p - lr * g``
        (``p - lr * (mask * g)``, the unbatched mask broadcasting over the
        clients).  Returns the stacked final params."""
        program, quantize = self.program, self.quantize

        def loss(p, batch):
            return program.loss_through_cut(p, batch, op, quantize=quantize)

        step = torch.func.vmap(torch.func.grad(loss))
        C = batches["labels"].shape[0]
        if mask is not None:
            params = tree_map(lambda v, m: m * v, params, mask)
        p = tree_map(lambda v: v.detach().expand(C, *v.shape).clone(),
                     params)
        for it in range(self.local_iters):
            grads = step(p, {key: v[:, it] for key, v in batches.items()})
            if mask is None:
                p = tree_map(lambda q, g: q - lr * g, p, grads)
            else:
                p = tree_map(lambda q, g, m: q - lr * (m * g), p, grads,
                             mask)
        return p

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
                # only the tail chunk of a group split into several pads
                pad_to = self.chunk if len(all_ks) > len(ks) else len(ks)
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
               augment: bool, quantize: bool, device: torch.device):
    """The configured fleet engine (the batched one with its default
    ``max_group``, as the reference builds it)."""
    try:
        cls = ENGINES[name]
    except KeyError:
        raise ValueError(f"unknown fleet engine {name!r}; "
                         f"known: {sorted(ENGINES)}") from None
    return cls(program, local_iters, seed, augment, quantize, device)


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
