"""Pre-/Post-processor (paper §III-A): state normalization, the continuous
action -> discrete Offloading Point mapping, and the Eq. 5 reward.

The action mu in (0, 1] is the fraction of the *computational workload*
(FLOPs) kept on the device.  The Post-processor picks the OP whose cumulative
FLOPs fraction is nearest; boundaries between OPs are the pairwise midpoints
(paper §V-B: VGG-5 fractions 0.1/0.66/0.94/1.0 give boundaries
0.38/0.79/0.96 — asserted in tests/test_core.py).

A numpy copy of ``repro/core/offload.py``, so the port's results are
identical; the tests, benchmarks and modules named above are the JAX
package's.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.costmodel import Workload


def op_fractions(w: Workload, ops: Sequence[int]) -> np.ndarray:
    """Cumulative device FLOPs fraction for each OP candidate."""
    return np.asarray([w.device_fraction(op) for op in ops], np.float64)


def op_boundaries(fractions: np.ndarray) -> np.ndarray:
    """Midpoints between adjacent OP fractions (paper §V-B)."""
    return (fractions[:-1] + fractions[1:]) / 2.0


def action_to_op(mu: float, fractions: np.ndarray,
                 ops: Sequence[int]) -> int:
    """Map a continuous action to the nearest OP (midpoint boundaries)."""
    idx = int(np.argmin(np.abs(fractions - mu)))
    return int(ops[idx])


def f_norm(t: float, baseline: float) -> float:
    """Eq. 5: positive when offloading beats the no-offload baseline."""
    if t <= baseline:
        return 1.0 - t / baseline
    return baseline / t - 1.0


def reward(times: Sequence[float], baselines: Sequence[float]) -> float:
    """R_t = sum_k f_norm(T_t^k, B^k)."""
    return float(sum(f_norm(t, b) for t, b in zip(times, baselines)))


def normalize_obs(group_times: np.ndarray, group_baselines: np.ndarray,
                  prev_actions: np.ndarray) -> np.ndarray:
    """State S_t = {T_t^g (normalized), mu_{t-1}^g} per group (Eq. 4)."""
    tnorm = group_times / np.maximum(group_baselines, 1e-9)
    return np.concatenate([tnorm, prev_actions]).astype(np.float32)
