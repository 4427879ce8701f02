"""Cohort sampling and host-side error-feedback state for fleets larger
than a device buffer (counterpart of ``repro/fl/cohort.py``).

* ``CohortSampler``: a seeded per-round subset of the registered fleet.
  ``members(round_idx)`` is a pure function of ``(seed, round_idx, K,
  cohort_size)`` (numpy draws identical to the reference's), so a resumed
  run re-derives every earlier cohort without a snapshot.
  ``pick(version, candidates, count)`` is the async refill, keyed by the
  server version.  With the cohort the whole fleet, both give the
  cohort-less loops' order exactly (``sorted(choice of all) == all``).
* ``EFStore``: the error-feedback (EF) rows in host numpy, zero by
  default; only touched rows are stored, and only the rows a step asks
  for reach the device (``fetch``).  ``prefetch`` runs the numpy gather of
  the next cohort on one worker thread while the cohort trains; ``fetch``
  takes the staged rows when they cover the ids asked for and gathers
  directly otherwise (bitwise the same), then copies to the store's
  device on the caller's thread and stream: the worker does no CUDA work.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["CohortSampler", "EFStore"]


class CohortSampler:
    """Seeded per-round cohorts over a registered fleet of ``K`` clients;
    every draw is keyed on ``(seed, index)``."""

    def __init__(self, num_clients: int, cohort_size: int, seed: int = 0):
        if not 1 <= cohort_size <= num_clients:
            raise ValueError(
                f"cohort_size={cohort_size} outside [1, K={num_clients}]")
        self.K = int(num_clients)
        self.size = int(cohort_size)
        self.seed = int(seed)

    def _rng(self, index: int) -> np.random.RandomState:
        # offset from FailureInjector's keys, so cohort draws and failure
        # masks never share a stream
        return np.random.RandomState(
            (self.seed * 1_000_003 + 7_919 * (index + 1)) % (2 ** 31))

    def members(self, round_idx: int) -> np.ndarray:
        """Sorted client ids of round ``round_idx``'s cohort (without
        replacement)."""
        rng = self._rng(int(round_idx))
        return np.sort(rng.choice(self.K, self.size, replace=False))

    def member_mask(self, round_idx: int) -> np.ndarray:
        """Boolean ``(K,)`` mask of ``members(round_idx)``."""
        mask = np.zeros(self.K, bool)
        mask[self.members(round_idx)] = True
        return mask

    def pick(self, version: int, candidates: np.ndarray,
             count: int) -> np.ndarray:
        """Async refill: ``count`` sorted clients drawn from ``candidates``
        (the idle ids), keyed on the server ``version``; all of them, sorted,
        when ``count == len(candidates)``."""
        candidates = np.asarray(candidates)
        if count > len(candidates):
            raise ValueError(
                f"cannot pick {count} clients from {len(candidates)} "
                f"candidates")
        rng = self._rng(int(version))
        sel = rng.choice(len(candidates), count, replace=False)
        return np.sort(candidates[sel])


class EFStore:
    """Host-side EF rows of ``K`` clients, ``padded`` fp32 each, zero by
    default and sparse; ``fetch`` returns rows on ``device`` (``None``: the
    card, raising if none is visible)."""

    def __init__(self, num_clients: int, padded: int, device=None):
        self.K = int(num_clients)
        self.padded = int(padded)
        self.device = resolve_device(device)
        self._rows: Dict[int, np.ndarray] = {}
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._staged_ids: Optional[Tuple[int, ...]] = None
        self._future = None

    def _gather(self, ids: Tuple[int, ...]) -> np.ndarray:
        out = np.zeros((len(ids), self.padded), np.float32)
        for i, k in enumerate(ids):
            row = self._rows.get(k)
            if row is not None:
                out[i] = row
        return out

    def prefetch(self, ids: Sequence[int]) -> None:
        """Stage the host gather of ``ids`` on the worker thread."""
        self._drain()
        self._staged_ids = tuple(int(k) for k in ids)
        self._future = self._pool.submit(self._gather, self._staged_ids)

    def _drain(self) -> Optional[np.ndarray]:
        if self._future is None:
            return None
        staged = self._future.result()
        self._future = None
        return staged

    def _host_rows(self, ids: Tuple[int, ...]) -> np.ndarray:
        staged_ids, staged = self._staged_ids, self._drain()
        if staged is not None and staged_ids is not None:
            if ids == staged_ids:
                return staged
            pos = {k: i for i, k in enumerate(staged_ids)}
            if all(k in pos for k in ids):
                return staged[[pos[k] for k in ids]]
        return self._gather(ids)

    def fetch(self, ids: Sequence[int]) -> torch.Tensor:
        """``(len(ids), padded)`` fp32 EF rows on the store's device."""
        rows = self._host_rows(tuple(int(k) for k in ids))
        return torch.from_numpy(rows).to(self.device)

    def store(self, ids: Sequence[int], rows) -> None:
        """Copy the updated EF rows back to host memory, one array a row."""
        arr = (rows.detach().cpu().numpy() if isinstance(rows, torch.Tensor)
               else np.asarray(rows))
        arr = arr.astype(np.float32, copy=False)
        if arr.shape != (len(ids), self.padded):
            raise ValueError(f"EF rows shape {arr.shape} != "
                             f"({len(ids)}, {self.padded})")
        for i, k in enumerate(ids):
            self._rows[int(k)] = np.array(arr[i])

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        """Touched rows as ``(ids (T,), rows (T, padded))``, sorted by id:
        the checkpoint's ``ef/ids`` and ``ef/rows``."""
        ids = np.asarray(sorted(self._rows), np.int64)
        rows = (np.stack([self._rows[int(k)] for k in ids])
                if len(ids) else np.zeros((0, self.padded), np.float32))
        return ids, rows.astype(np.float32)

    def restore(self, ids: Sequence[int], rows) -> None:
        arr = np.asarray(rows, np.float32)
        self._staged_ids, self._future = None, None
        self._rows = {int(k): np.array(arr[i]) for i, k in enumerate(ids)}

    def close(self) -> None:
        """Stop the worker thread (after waiting for a staged gather)."""
        self._drain()
        self._pool.shutdown()

    @property
    def touched(self) -> int:
        """Number of clients whose EF row has ever been written."""
        return len(self._rows)

    @property
    def host_bytes(self) -> int:
        """Host memory held by touched rows (zeros cost nothing)."""
        return sum(r.nbytes for r in self._rows.values())

    def dense_bytes(self) -> int:
        """What a dense ``(K, padded)`` fp32 array would cost."""
        return self.K * self.padded * 4
