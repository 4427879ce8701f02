"""Straggler mitigation beyond the paper's offloading: deadline-based
drop-and-reweight for synchronous rounds.

FedAdapt's offloading *shrinks* stragglers (the paper's core claim); this
module handles the residual tail at 1000-node scale, where a preempted or
failed node would otherwise stall the synchronous round: clients slower than
``factor x median`` are excluded from this round's FedAvg and their weight is
renormalized over the survivors.

A numpy copy of ``repro/runtime/straggler.py``, so the port's results are
identical; the tests, benchmarks and modules named above are the JAX
package's.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def deadline_value(times: Sequence[float], factor: float = 2.0) -> float:
    """The round deadline: ``factor x median`` over the *finite* times.
    ``inf`` entries (dead links — ``Transport.transfer_time`` at zero
    bandwidth) are excluded from the median so one stalled client can't
    push the deadline to infinity.  ``inf`` if no client has a finite
    time."""
    t = np.asarray(times, np.float64)
    finite = t[np.isfinite(t)]
    if finite.size == 0:
        return float("inf")
    return float(factor * np.median(finite))


def deadline_mask(times: Sequence[float], factor: float = 2.0) -> np.ndarray:
    """True = included.  Clients with infinite round time (dead links) are
    never kept; otherwise always keeps at least one (the fastest) client.
    All-``inf`` times yield an all-False mask — the round produced no
    update."""
    t = np.asarray(times, np.float64)
    finite = np.isfinite(t)
    if not finite.any():
        return np.zeros(len(t), bool)
    mask = (t <= deadline_value(t, factor)) & finite
    if not mask.any():
        mask[np.argmin(np.where(finite, t, np.inf))] = True
    return mask


def reweight(weights: Sequence[float], mask: np.ndarray) -> np.ndarray:
    """Renormalize ``weights`` over the kept clients.  An all-False mask
    (every client missed the deadline) returns all-zero weights rather than
    dividing by zero — the caller skips aggregation for such a round."""
    w = np.asarray(weights, np.float64) * mask
    s = w.sum()
    if s <= 0:
        w = np.asarray(mask, np.float64)
        s = w.sum()
        if s <= 0:
            return w
    return w / s
