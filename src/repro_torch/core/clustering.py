"""Device clustering (paper §IV): k-means over (training time, bandwidth),
an elbow heuristic for G, and the dedicated low-bandwidth group.

The clustering is what makes the RL agent's input/output dimensions
independent of the number of participating devices K — and therefore what
makes the controller *elastic*: devices can join/leave between rounds
(exercised by runtime/elastic.py and the hypothesis property tests).

A numpy copy of ``repro/core/clustering.py``, so the port's results are
identical; the tests, benchmarks and modules named above are the JAX
package's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Grouping:
    assignments: np.ndarray          # (K,) group index per device
    centers: np.ndarray              # (G, F)
    num_groups: int
    representative: np.ndarray       # (G,) device index with max training time
    low_bw_group: Optional[int] = None

    def members(self, g: int) -> np.ndarray:
        return np.flatnonzero(self.assignments == g)


def kmeans(points: np.ndarray, k: int, iters: int = 100,
           seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Plain k-means (deterministic given seed). points: (K, F)."""
    K = len(points)
    k = min(k, K)
    rng = np.random.RandomState(seed)
    # k-means++ init
    centers = [points[rng.randint(K)]]
    for _ in range(1, k):
        d2 = np.min(
            [np.sum((points - c) ** 2, axis=1) for c in centers], axis=0)
        total = d2.sum()
        if total <= 0 or not np.isfinite(total):
            centers.append(points[rng.randint(K)])   # degenerate: all equal
            continue
        centers.append(points[rng.choice(K, p=d2 / total)])
    centers = np.asarray(centers, np.float64)
    assign = np.zeros(K, np.int64)
    for _ in range(iters):
        dists = np.linalg.norm(points[:, None] - centers[None], axis=-1)
        new_assign = dists.argmin(axis=1)
        if np.array_equal(new_assign, assign) and _ > 0:
            break
        assign = new_assign
        for j in range(k):
            m = assign == j
            if m.any():
                centers[j] = points[m].mean(axis=0)
    return centers, assign


def elbow(points: np.ndarray, k_max: int = 6, seed: int = 0) -> int:
    """Pick G by the elbow method [Kodinariya & Makwana]: the knee is the k
    with the largest *relative* distortion drop (absolute second differences
    over-weight the k=1 -> 2 drop when clusters are well separated)."""
    K = len(points)
    k_max = min(k_max, K)
    if k_max <= 2:
        return k_max
    distortions = []
    for k in range(1, k_max + 1):
        centers, assign = kmeans(points, k, seed=seed)
        d = np.linalg.norm(points - centers[assign], axis=1)
        distortions.append(float(np.sum(d ** 2)))
    best_k, best_drop = 2, -1.0
    for k in range(2, k_max + 1):
        prev, cur = distortions[k - 2], distortions[k - 1]
        drop = (prev - cur) / max(prev, 1e-12)
        if drop > best_drop + 1e-9:
            best_k, best_drop = k, drop
    return best_k


def cluster_devices(
    train_times: Sequence[float],           # per-iteration time, last round
    bandwidths: Sequence[float],            # bits/s
    num_groups: Optional[int] = None,       # None -> elbow
    low_bw_threshold: Optional[float] = None,  # e.g. 25 Mbps (paper: <25)
    seed: int = 0,
) -> Grouping:
    """Paper §IV clustering.  Low-bandwidth devices form a dedicated extra
    group (paper §IV 'Optimizing for network bandwidth'); the rest are
    k-means'd on normalized training time."""
    times = np.asarray(train_times, np.float64)
    bw = np.asarray(bandwidths, np.float64)
    K = len(times)
    low = (bw < low_bw_threshold) if low_bw_threshold else np.zeros(K, bool)
    normal_idx = np.flatnonzero(~low)

    if len(normal_idx) == 0:
        assignments = np.zeros(K, np.int64)
        centers = np.asarray([[times.mean()]])
        G = 1
        low_group: Optional[int] = 0
    else:
        pts = times[normal_idx][:, None] / max(times.max(), 1e-12)
        G_normal = num_groups or elbow(pts, seed=seed)
        G_normal = min(G_normal, len(normal_idx))
        centers_n, assign_n = kmeans(pts, G_normal, seed=seed)
        # stable group ids: order groups by center (fastest first)
        order = np.argsort(centers_n[:, 0])
        remap = np.empty_like(order)
        remap[order] = np.arange(len(order))
        assignments = np.zeros(K, np.int64)
        assignments[normal_idx] = remap[assign_n]
        G = G_normal
        low_group = None
        if low.any():
            low_group = G
            assignments[low] = G
            G += 1
        centers = np.zeros((G, 1))
        for g in range(G):
            centers[g, 0] = times[assignments == g].mean()

    # representative: device with max training time per group (paper §IV)
    reps = np.asarray([
        int(np.flatnonzero(assignments == g)[
            np.argmax(times[assignments == g])])
        for g in range(G)
    ])
    return Grouping(assignments=assignments, centers=centers, num_groups=G,
                    representative=reps, low_bw_group=low_group)
