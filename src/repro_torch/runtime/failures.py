"""Deterministic failure injection for fault-tolerance drills.

Models the two failure classes that matter at 1000+ nodes:
* client/pod failure  — the client misses the round (mask=False); FedAvg
  reweights over survivors (runtime/straggler.reweight);
* coordinator crash   — training resumes from the latest atomic checkpoint;
  tests/test_runtime.py asserts the resumed run is bitwise identical.

``round_mask(K, round_idx=r)`` keys the mask RNG on ``(seed, r)``, so a run
replayed from a mid-run checkpoint draws the *same* masks for the same
rounds without fast-forwarding a shared stream — the call-order-dependent
mode (``round_idx=None``) is kept for legacy callers but chaos drills and
the training loops always pass the round index.

A numpy copy of ``repro/runtime/failures.py``, so the port's results are
identical; the tests, benchmarks and modules named above are the JAX
package's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class FailureInjector:
    def __init__(self, fail_prob: float = 0.0, seed: int = 0):
        self.fail_prob = fail_prob
        self.seed = seed
        self.rng = np.random.RandomState(seed)

    def _round_rng(self, round_idx: int) -> np.random.RandomState:
        # keyed per (seed, round): replay of round r is a pure function of
        # the constructor seed, independent of how many masks were drawn
        return np.random.RandomState(
            (self.seed * 1_000_003 + round_idx) % (2 ** 31))

    def round_mask(self, num_clients: int,
                   round_idx: Optional[int] = None) -> np.ndarray:
        """True = alive this round. At least one client always survives.

        With ``round_idx`` the mask is a pure function of
        ``(seed, round_idx, num_clients)`` — checkpoint-restored runs replay
        identical masks.  Without it the legacy call-order stream is used.
        """
        if self.fail_prob <= 0:
            return np.ones(num_clients, bool)
        rng = self.rng if round_idx is None else self._round_rng(round_idx)
        mask = rng.rand(num_clients) >= self.fail_prob
        if not mask.any():
            mask[rng.randint(num_clients)] = True
        return mask
