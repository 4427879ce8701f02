"""Per-client batching with deterministic shuffling (a copy of the
reference's ``ClientLoader`` / ``FleetLoader`` streams: the same seed gives
byte-identical numpy batches).  Batches stay numpy here; the fleet engine
moves them to the device."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


class ClientLoader:
    def __init__(self, data: Dict[str, np.ndarray], batch_size: int,
                 seed: int = 0):
        self.data = data
        self.n = len(next(iter(data.values())))
        self.batch_size = min(batch_size, self.n)
        self.seed = seed
        self.epoch = 0
        self.cursor = 0
        self._perm = self._permutation(0)

    def _permutation(self, epoch: int) -> np.ndarray:
        return np.random.RandomState(self.seed + epoch).permutation(self.n)

    def next_batch(self) -> Dict[str, np.ndarray]:
        if self.cursor + self.batch_size > self.n:
            self.epoch += 1
            self.cursor = 0
            self._perm = self._permutation(self.epoch)
        idx = self._perm[self.cursor:self.cursor + self.batch_size]
        self.cursor += self.batch_size
        return {k: v[idx] for k, v in self.data.items()}


class FleetLoader:
    """One ``ClientLoader(seed + k)`` per client, built on first draw."""

    def __init__(self, clients_data: Sequence[Dict[str, np.ndarray]],
                 batch_size: int, seed: int = 0):
        sizes = {min(batch_size, len(next(iter(d.values()))))
                 for d in clients_data}
        if len(sizes) > 1:
            raise ValueError(
                f"FleetLoader needs a uniform batch size to stack clients; "
                f"got {sorted(sizes)} (some client datasets are smaller than "
                f"the requested batch size)")
        self._data = clients_data
        self._batch_size = batch_size
        self._seed = seed
        self._loaders: Dict[int, ClientLoader] = {}

    def next_batch(self, k: int) -> Dict[str, np.ndarray]:
        """Client ``k``'s next batch (the sequential engine's draw)."""
        if k not in self._loaders:
            self._loaders[k] = ClientLoader(self._data[k], self._batch_size,
                                            seed=self._seed + k)
        return self._loaders[k].next_batch()
