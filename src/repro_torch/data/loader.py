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

``dirichlet_indices`` / ``dirichlet_partition`` split one dataset into K
label-skewed client shards, Dirichlet(alpha) proportions per class drawn
from a ``RandomState(seed)`` stream: the reference's index sets, array for
array, rebalancing included.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def dirichlet_indices(labels: np.ndarray, num_clients: int, alpha: float,
                      seed: int = 0, min_per_client: int = 1,
                      ) -> List[np.ndarray]:
    """Per-client sample indices of a seeded Dirichlet(alpha) label-skew
    partition.  Each class's samples are shuffled and split across the K
    clients in proportions ``p ~ Dirichlet(alpha 1_K)`` (a fresh draw a
    class; counts by floor plus largest remainder).  The index arrays are
    disjoint and cover ``arange(len(labels))``; a deterministic rebalance
    moves samples from the largest shard until every client has at least
    ``min_per_client``.  A pure function of ``(labels, K, alpha, seed)``."""
    if num_clients < 1:
        raise ValueError(f"num_clients={num_clients} must be >= 1")
    if alpha <= 0:
        raise ValueError(f"alpha={alpha} must be > 0 (Dirichlet "
                         f"concentration)")
    labels = np.asarray(labels)
    if labels.ndim > 1:
        # (N, T) token targets: each sequence's first target keys the skew
        labels = labels.reshape(len(labels), -1)[:, 0]
    n = len(labels)
    if n < num_clients * min_per_client:
        raise ValueError(
            f"{n} samples cannot give {num_clients} clients "
            f">= {min_per_client} each")
    rng = np.random.RandomState(seed)
    shards: List[List[np.ndarray]] = [[] for _ in range(num_clients)]
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        p = rng.dirichlet(np.full(num_clients, float(alpha)))
        raw = p * len(idx)
        counts = np.floor(raw).astype(np.int64)
        rem = len(idx) - int(counts.sum())
        if rem:
            order = np.argsort(-(raw - counts), kind="stable")
            counts[order[:rem]] += 1
        start = 0
        for k, stop in enumerate(np.cumsum(counts)):
            if stop > start:
                shards[k].append(idx[start:stop])
            start = int(stop)
    parts = [np.sort(np.concatenate(s)) if s
             else np.empty(0, np.int64) for s in shards]
    # donate from the largest shard to the smallest below the floor (ties
    # to the lower client index, as argmax / argmin break them)
    sizes = np.asarray([len(p) for p in parts])
    while sizes.min() < min_per_client:
        src = int(np.argmax(sizes))
        dst = int(np.argmin(sizes))
        give = min(min_per_client - sizes[dst], sizes[src] - min_per_client)
        if give <= 0:
            raise ValueError("rebalance stuck: not enough samples to give "
                             f"every client >= {min_per_client}")
        moved, parts[src] = parts[src][-give:], parts[src][:-give]
        parts[dst] = np.sort(np.concatenate([parts[dst], moved]))
        sizes[src] -= give
        sizes[dst] += give
    return parts


def dirichlet_partition(data: Dict[str, np.ndarray], num_clients: int,
                        alpha: float, seed: int = 0,
                        label_key: str = "labels",
                        min_per_client: int = 1,
                        ) -> List[Dict[str, np.ndarray]]:
    """K Dirichlet(alpha) label-skewed client shards of one dict dataset:
    every array is indexed by ``dirichlet_indices`` over
    ``data[label_key]``.  A drop-in for the IID ``split_clients``."""
    parts = dirichlet_indices(data[label_key], num_clients, alpha,
                              seed=seed, min_per_client=min_per_client)
    return [{k: v[idx] for k, v in data.items()} for idx in parts]


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

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """``next_batch`` forever."""
        while True:
            yield self.next_batch()


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

    @property
    def loaders(self) -> List[ClientLoader]:
        """All K streams as a list: builds every client's stream."""
        return [self._get(k) for k in range(len(self._data))]

    @property
    def materialized(self) -> int:
        """How many client streams have been built."""
        return len(self._loaders)

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
