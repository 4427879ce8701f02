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
        batch = loader.next_batch(k)
        images = batch["images"]
        if self.augment:
            images = flip_augment(images, self.seed, round_idx, k, it)
        return {"images": torch.from_numpy(np.ascontiguousarray(images)
                                           ).to(self.device),
                "labels": torch.from_numpy(batch["labels"]).to(self.device)}

    def run_round(self, params: Params, loader: FleetLoader,
                  ops: Sequence[int], alive_idx: Sequence[int],
                  round_idx: int, lr: float
                  ) -> Tuple[List[int], List[Params]]:
        # lr as an fp32 scalar on the device, as the reference passes it
        lr_t = torch.tensor(lr, dtype=torch.float32, device=self.device)
        out: List[Params] = []
        for k in alive_idx:
            # each client trains its own copy, updated in place
            p_k = [{n: v.detach().clone().requires_grad_()
                    for n, v in layer.items()} for layer in params]
            leaves = tree_leaves(p_k)
            for it in range(self.local_iters):
                batch = self._batch(loader, k, round_idx, it)
                loss = self.program.loss_through_cut(
                    p_k, batch, int(ops[k]), quantize=self.quantize)
                grads = torch.autograd.grad(loss, leaves)
                with torch.no_grad():
                    for p, g in zip(leaves, grads):
                        p.sub_(lr_t * g)
            out.append([{n: v.detach() for n, v in layer.items()}
                        for layer in p_k])
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

    def _group(self, ops: Sequence[int], alive_idx: Sequence[int]
               ) -> Dict[int, List[int]]:
        groups: Dict[int, List[int]] = {}
        for k in alive_idx:
            groups.setdefault(int(ops[k]), []).append(k)
        return groups

    def _stack_round(self, loader: FleetLoader, ks: List[int],
                     round_idx: int, pad_to: int) -> Dict[str, torch.Tensor]:
        """The chunk's whole round of data, drawn host-side iteration by
        iteration from each client's stream, augmented, stacked
        ``(C, I, B, ...)`` and moved to the device once."""
        per_iter = []
        for it in range(self.local_iters):
            nb = loader.next_batches(ks, pad_to=pad_to)       # (C, B, ...)
            if self.augment:
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
                    lr: torch.Tensor, op: int) -> Params:
        """Every client of the chunk starts from ``params``; each local
        iteration is one vmap over the clients of the loss's gradient and
        the SGD step ``p - lr * g``.  Returns the stacked final params."""
        program, quantize = self.program, self.quantize

        def loss(p, batch):
            return program.loss_through_cut(p, batch, op, quantize=quantize)

        step = torch.func.vmap(torch.func.grad(loss))
        C = batches["labels"].shape[0]
        p = tree_map(lambda v: v.detach().expand(C, *v.shape).clone(),
                     params)
        for it in range(self.local_iters):
            grads = step(p, {key: v[:, it] for key, v in batches.items()})
            p = tree_map(lambda q, g: q - lr * g, p, grads)
        return p

    def run_round(self, params: Params, loader: FleetLoader,
                  ops: Sequence[int], alive_idx: Sequence[int],
                  round_idx: int, lr: float
                  ) -> Tuple[List[int], StackedRows]:
        lr_t = torch.tensor(lr, dtype=torch.float32, device=self.device)
        idxs: List[int] = []
        stacked: List[Params] = []
        for op, all_ks in self._group(ops, alive_idx).items():
            for i in range(0, len(all_ks), self.chunk):
                ks = all_ks[i:i + self.chunk]
                # only the tail chunk of a group split into several pads
                pad_to = self.chunk if len(all_ks) > len(ks) else len(ks)
                finals = self._fleet_step(
                    params, self._stack_round(loader, ks, round_idx, pad_to),
                    lr_t, op)
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
