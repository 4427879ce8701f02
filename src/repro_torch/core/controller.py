"""The FedAdapt per-round control loop (paper Fig. 2):

    observe (times, bandwidths)  ->  Pre-processor (normalize)
      ->  Clustering Module (k-means + low-bandwidth group)
        ->  Trained RL Agent (PPO actor)  ->  action mu^g per group
          ->  Post-processor (action -> OP, mapped onto every group member)

The controller is *elastic*: because the agent sees G groups, not K devices,
devices may join or leave between rounds (the reference's
runtime/elastic.py drills this).
Counterpart of ``repro/core/controller.py``.  The agent acts without
exploration (deployment, as ``run_federated`` uses it); the offline PPO
training ``train_rl_agent`` is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core import offload
from repro_torch.core.agent import PPOAgent, PPOConfig
from repro_torch.core.clustering import Grouping, cluster_devices
from repro_torch.core.costmodel import Workload


@dataclasses.dataclass
class RoundPlan:
    ops: List[int]                 # per-device OP for the next round
    actions: np.ndarray            # per-group mu
    grouping: Grouping
    obs: np.ndarray


class FedAdaptController:
    def __init__(
        self,
        workload: Workload,
        op_candidates: Sequence[int],
        num_groups: int = 3,
        low_bw_threshold: Optional[float] = 25e6,   # paper: < 25 Mbps
        agent: Optional[PPOAgent] = None,
        seed: int = 0,
    ):
        self.workload = workload
        self.ops = list(op_candidates)
        self.fractions = offload.op_fractions(workload, self.ops)
        self.G = num_groups
        self.low_bw_threshold = low_bw_threshold
        self.agent = agent or PPOAgent(PPOConfig(num_groups=num_groups),
                                       seed=seed)
        self.baselines: Optional[np.ndarray] = None
        self.prev_actions = np.ones(num_groups, np.float32)   # native
        self._last_grouping: Optional[Grouping] = None

    # ------------------------------------------------------------------
    def begin(self, baseline_times: Sequence[float]):
        """Round 0: classic FL (no offloading) measures the B^k baselines.
        Groups are formed from these round-0 times (paper §V-B: 'the device
        training time in the first round is used to cluster'); only the
        low-bandwidth group membership is re-evaluated every round."""
        # np.array (not asarray): always copy, so a caller that keeps
        # mutating its times buffer (the reference's async loop does, in
        # place) can't silently corrupt the stored round-0 baselines
        self.baselines = np.array(baseline_times, np.float64)
        self.prev_actions = np.ones(self.G, np.float32)

    def _cluster(self, bandwidths: np.ndarray) -> Grouping:
        assert self.baselines is not None
        if self.low_bw_threshold is not None and self.G >= 2:
            # paper §IV: the low-bandwidth group is an *additional reserved*
            # group — normal devices always cluster into G-1 groups and the
            # last slot's semantics stay 'low-bandwidth' even when empty
            # (otherwise the deployed agent's per-slot policy shifts meaning
            # between rounds with and without throttled devices).  Reserving
            # the slot requires G >= 2: at G == 1 the reserved group would
            # push num_groups past G, overflowing the agent's fixed obs and
            # action width (every overflow group would silently share the
            # last slot), so a single-group agent clusters everyone together.
            has_low = bool((bandwidths < self.low_bw_threshold).any())
            grouping = cluster_devices(
                self.baselines, bandwidths, num_groups=self.G - 1,
                low_bw_threshold=self.low_bw_threshold if has_low else None)
        else:
            grouping = cluster_devices(
                self.baselines, bandwidths, num_groups=self.G,
                low_bw_threshold=None)
        assert grouping.num_groups <= self.G, \
            f"clustering produced {grouping.num_groups} groups for a " \
            f"G={self.G} agent"
        return grouping

    def _group_obs(self, grouping: Grouping, times: np.ndarray) -> np.ndarray:
        """Fixed-width obs: G slots; empty slots zero-padded."""
        assert self.baselines is not None, "call begin() first"
        g_times = np.zeros(self.G)
        g_base = np.ones(self.G)
        for g in range(grouping.num_groups):
            rep = grouping.representative[g]
            slot = min(g, self.G - 1)
            g_times[slot] = times[rep]
            g_base[slot] = self.baselines[rep] if rep < len(self.baselines) \
                else max(times[rep], 1e-9)
        return offload.normalize_obs(g_times, g_base, self.prev_actions)

    # ------------------------------------------------------------------
    def plan(self, last_times: Sequence[float], bandwidths: Sequence[float],
             explore: bool = True) -> RoundPlan:
        times = np.asarray(last_times, np.float64)
        bw = np.asarray(bandwidths, np.float64)
        grouping = self._cluster(bw)
        obs = self._group_obs(grouping, times)
        actions = self.agent.act(obs, explore=explore)
        ops: List[int] = [0] * len(times)
        for g in range(grouping.num_groups):
            slot = min(g, self.G - 1)
            op = offload.action_to_op(float(actions[slot]), self.fractions,
                                      self.ops)
            for k in grouping.members(g):
                ops[k] = op
        self.prev_actions = np.asarray(actions, np.float32)[: self.G]
        self._last_grouping = grouping
        return RoundPlan(ops=ops, actions=np.asarray(actions),
                         grouping=grouping, obs=obs)

    def feedback(self, times: Sequence[float]):
        """Reward the agent with Eq. 5 vs. the round-0 baselines.

        Factored agents (beyond-paper, see PPOConfig.factored) receive the
        per-group decomposition of the same sum instead of the scalar."""
        assert self.baselines is not None
        k = min(len(times), len(self.baselines))
        r = offload.reward(list(times)[:k], self.baselines[:k])
        factored = getattr(getattr(self.agent, "cfg", None), "factored", False)
        if factored and self._last_grouping is not None:
            vec = np.zeros(self.G, np.float32)
            for g in range(self._last_grouping.num_groups):
                slot = min(g, self.G - 1)
                for dev in self._last_grouping.members(g):
                    if dev < k:
                        vec[slot] += offload.f_norm(times[dev],
                                                    self.baselines[dev])
            if hasattr(self.agent, "observe"):
                self.agent.observe(vec)
            return r
        if hasattr(self.agent, "observe"):
            self.agent.observe(r)
        return r
