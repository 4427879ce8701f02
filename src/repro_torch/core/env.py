"""RL training environment: truncated FL rounds driven by the cost model.

The paper trains the agent offline against a real testbed with 5-iteration
truncated rounds; in this container the testbed is the Eq. 1 cost model
(paper-calibrated device speeds for the faithful runs, v5e roofline-derived
speeds for the datacenter runs) plus multiplicative jitter to emulate
real-world variance.  Bandwidths follow a per-round schedule so §V-C / §V-D
(changing network conditions) are reproducible.

A numpy copy of ``repro/core/env.py``, so the port's results are
identical; the tests, benchmarks and modules named above are the JAX
package's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.core.costmodel import (
    DeviceProfile,
    Workload,
    compute_time,
    iteration_time,
)

BandwidthFn = Callable[[int, int], float]     # (round, device_idx) -> bits/s


@dataclasses.dataclass
class SimulatedCluster:
    """The 'testbed': devices + server + workload, timed via Eq. 1."""
    workload: Workload
    devices: List[DeviceProfile]
    server_flops: float
    op_candidates: Sequence[int]
    iterations: int = 5                      # truncated FL rounds (paper §IV)
    jitter: float = 0.0                      # lognormal sigma on speeds
    overhead_s: float = 0.0
    bandwidth_fn: Optional[BandwidthFn] = None
    seed: int = 0

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    def _jittered_speed(self, dev_idx: int, round_idx: int) -> float:
        """Device speed with multiplicative lognormal jitter keyed by
        ``(seed, round, device)``: two calls for the same round return the
        same draw, and a checkpoint-resumed run replays the identical
        jitter stream (bitwise resume — tests/test_async.py), instead of
        consuming a shared mutable RNG whose position depends on call
        history."""
        speed = self.devices[dev_idx].flops_per_s
        if self.jitter > 0:
            rng = np.random.RandomState(
                (self.seed * 1_000_003 + round_idx * 10_007
                 + dev_idx * 101 + 17) % (2 ** 31))
            speed *= float(np.exp(rng.randn() * self.jitter))
        return speed

    def bandwidths(self, round_idx: int) -> np.ndarray:
        if self.bandwidth_fn is None:
            return np.asarray([d.bandwidth_bps for d in self.devices])
        return np.asarray([self.bandwidth_fn(round_idx, i)
                           for i in range(self.num_devices)])

    def round_times(self, ops: Sequence[int], round_idx: int) -> np.ndarray:
        """Per-device round time for the given per-device OPs."""
        bw = self.bandwidths(round_idx)
        out = []
        for i, op in enumerate(ops):
            speed = self._jittered_speed(i, round_idx)
            t = iteration_time(self.workload, op, speed, self.server_flops,
                               bw[i], self.overhead_s)
            out.append(t * self.iterations)
        return np.asarray(out)

    def round_compute_times(self, ops: Sequence[int],
                            round_idx: int) -> np.ndarray:
        """Per-device round time, compute terms only (no network): the
        transport path in fl/loop.py adds comm via fl/comm.Transport."""
        out = []
        for i, op in enumerate(ops):
            speed = self._jittered_speed(i, round_idx)
            t = compute_time(self.workload, op, speed, self.server_flops)
            if op < self.workload.num_layers:
                t += self.overhead_s
            out.append(t * self.iterations)
        return np.asarray(out)

    def native_ops(self) -> List[int]:
        return [self.workload.num_layers] * self.num_devices
