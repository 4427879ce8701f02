"""Local training of one round (counterpart of ``repro/fl/fleet.py``):
the sequential engine, K clients each running ``local_iters`` SGD steps
from the same global params, one client after another."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.loader import FleetLoader
from repro_torch.fl.flatbuf import Params, tree_leaves
from repro_torch.models.split_program import SplitProgram


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
