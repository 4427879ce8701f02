"""Pluggable per-round offloading planners for the federated loop.

A ``Planner`` decides each device's Offloading Point every round from the
observed round times (seconds per round, one entry per device) and the
current bandwidths (bits/s per device).  The protocol mirrors the paper's
control loop (Fig. 2): ``begin`` receives the classic-FL baseline times
B^k measured before round 0 (the §III-A state normalizer), ``plan`` maps
observations to one OP per device, and ``feedback`` receives the realized
round times the executed plan produced — the RL planner turns these into
the Eq. 5 reward.  ``run_federated`` (fl/loop.py) is generic over the
protocol, so the paper's RL controller, the static-OP baselines and simple
heuristics all drive the same loop:

* ``StaticPlanner``   — fixed OP for every device: classic FL at the native
  OP, or SplitFed [Thapa et al.] at a uniform cut (the paper's §V-B
  baselines);
* ``FedAdaptPlanner`` — wraps ``core.controller.FedAdaptController``, the
  paper's §IV pipeline: k-means device clustering + PPO actor emitting one
  workload fraction mu^g per group, post-processed to an OP;
* ``GreedyPlanner``   — bandwidth-greedy heuristic baseline: each device
  independently picks the Eq. 1 argmin OP for its current bandwidth.  No
  learning, no grouping; the natural ablation between static OPs and the RL
  agent.

Counterpart of ``repro/fl/planner.py``.  ``FedAdaptPlanner(explore=True)``
lets the agent explore and learn from the realized round times (PPO
updates every ``update_every`` rounds); the default deploys it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core import costmodel as cm
from repro_torch.core.controller import FedAdaptController


class Planner:
    """Protocol: per-round OP planning over K devices."""

    def begin(self, baseline_times: Sequence[float]) -> None:
        """Round-0 hook: classic-FL baseline times B^k."""

    def plan(self, round_idx: int, last_times: Sequence[float],
             bandwidths: Optional[Sequence[float]]) -> List[int]:
        """Per-device OPs for this round (len == len(last_times))."""
        raise NotImplementedError

    def feedback(self, times: Sequence[float]) -> None:
        """Observed round times for the plan just executed."""


class StaticPlanner(Planner):
    def __init__(self, op: int):
        self.op = int(op)

    def plan(self, round_idx, last_times, bandwidths) -> List[int]:
        return [self.op] * len(last_times)


class FedAdaptPlanner(Planner):
    def __init__(self, controller: FedAdaptController, explore: bool = False):
        self.controller = controller
        self.explore = explore

    def begin(self, baseline_times) -> None:
        if self.controller.baselines is None:
            self.controller.begin(baseline_times)

    def plan(self, round_idx, last_times, bandwidths) -> List[int]:
        assert bandwidths is not None, "FedAdapt planning needs bandwidths"
        return self.controller.plan(last_times, bandwidths,
                                    explore=self.explore).ops

    def feedback(self, times) -> None:
        self.controller.feedback(times)


class GreedyPlanner(Planner):
    def __init__(
        self,
        workload: cm.Workload,
        op_candidates: Sequence[int],
        device_flops: Sequence[float],
        server_flops: float,
        overhead_s: float = 0.0,
    ):
        self.workload = workload
        self.ops = list(op_candidates)
        self.device_flops = list(device_flops)
        self.server_flops = server_flops
        self.overhead_s = overhead_s

    def plan(self, round_idx, last_times, bandwidths) -> List[int]:
        K = len(last_times)
        if bandwidths is None:
            return [self.workload.num_layers] * K
        out = []
        for k in range(K):
            pred = [cm.iteration_time(self.workload, op, self.device_flops[k],
                                      self.server_flops, bandwidths[k],
                                      self.overhead_s)
                    for op in self.ops]
            out.append(self.ops[int(np.argmin(pred))])
        return out
