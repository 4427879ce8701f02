"""Per-client batching with deterministic shuffling (a copy of the
reference's ``ClientLoader`` / ``FleetLoader`` streams: the same seed gives
byte-identical numpy batches).  Batches stay numpy here; the fleet engines
move them to the device.

A stream's state is ``(epoch, cursor)``: ``skip`` fast-forwards it without
drawing and ``state`` / ``restore`` carry it, so a resumed run sees the
batches of an uninterrupted one.  ``FleetLoader.next_batches`` stacks the
next draw of several clients ``(G, B, ...)`` for the batched engine; each
client's stream is the one the sequential engine draws, whatever the
grouping.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

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

    def state(self) -> Tuple[int, int]:
        return (self.epoch, self.cursor)

    def restore(self, state: Tuple[int, int]) -> None:
        self.epoch, self.cursor = state
        self._perm = self._permutation(self.epoch)

    def next_batch(self) -> Dict[str, np.ndarray]:
        if self.cursor + self.batch_size > self.n:
            self.epoch += 1
            self.cursor = 0
            self._perm = self._permutation(self.epoch)
        idx = self._perm[self.cursor:self.cursor + self.batch_size]
        self.cursor += self.batch_size
        return {k: v[idx] for k, v in self.data.items()}

    def skip(self, n: int) -> None:
        """Fast-forward ``n`` draws without materializing the batches."""
        for _ in range(n):
            if self.cursor + self.batch_size > self.n:
                self.epoch += 1
                self.cursor = 0
            self.cursor += self.batch_size
        self._perm = self._permutation(self.epoch)


class FleetLoader:
    """One ``ClientLoader(seed + k)`` per client, built on first draw (an
    untouched client's state is the initial ``(0, 0)``)."""

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

    @classmethod
    def for_clients(cls, clients_data: Sequence[Dict[str, np.ndarray]],
                    batch_size: int, seed: int = 0) -> "FleetLoader":
        """The reference's constructor name for the same lazy fleet."""
        return cls(clients_data, batch_size, seed=seed)

    def _get(self, k: int) -> ClientLoader:
        if k not in self._loaders:
            self._loaders[k] = ClientLoader(self._data[k], self._batch_size,
                                            seed=self._seed + k)
        return self._loaders[k]

    def __len__(self) -> int:
        return len(self._data)

    def next_batch(self, k: int) -> Dict[str, np.ndarray]:
        """Client ``k``'s next batch (the sequential engine's draw)."""
        return self._get(k).next_batch()

    def next_batches(self, k_indices: Sequence[int],
                     pad_to: Optional[int] = None) -> Dict[str, np.ndarray]:
        """The next batch of every listed client, stacked ``(G, B, ...)`` in
        ``k_indices`` order; each client advances one draw.  ``pad_to`` (>=
        ``len(k_indices)``) repeats the first client's draw up to that many
        rows without advancing any stream."""
        batches = [self._get(k).next_batch() for k in k_indices]
        if pad_to is not None and pad_to > len(batches):
            batches = batches + [batches[0]] * (pad_to - len(batches))
        return {key: np.stack([b[key] for b in batches])
                for key in batches[0]}

    def skip(self, n: int) -> None:
        """Fast-forward every client stream ``n`` draws."""
        for k in range(len(self)):
            self._get(k).skip(n)

    def skip_client(self, k: int, n: int) -> None:
        """Fast-forward one client's stream ``n`` draws."""
        if n:
            self._get(k).skip(n)

    def state(self) -> List[Tuple[int, int]]:
        """Per-client ``(epoch, cursor)``; unbuilt streams report ``(0, 0)``
        without being built."""
        return [self._loaders[k].state() if k in self._loaders else (0, 0)
                for k in range(len(self))]

    def restore(self, states: Sequence[Tuple[int, int]]) -> None:
        if len(states) != len(self):
            raise ValueError(
                f"fleet state has {len(states)} client streams, loader has "
                f"{len(self)}: a partial restore would break bitwise resume")
        for k, st in enumerate(states):
            if tuple(st) != (0, 0) or k in self._loaders:
                self._get(k).restore(tuple(st))
