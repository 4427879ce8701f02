"""Chaos drills: seeded production-shaped churn against the async runtime
(counterpart of ``repro/runtime/chaos.py``; the scripts are the
reference's numpy draws, so the same ``(K, rounds, seed)`` gives the same
tables).

The IoT-FL surveys (arXiv:2308.13157, arXiv:2307.09182) call client churn
and link volatility the dominant failure modes at fleet scale — and they
are exactly what the virtual-clock scheduler, staleness weighting and
buffered aggregation exist to absorb.  This module scripts those failure
modes deterministically and proves the runtime survives them:

* ``ChaosScript`` — a precomputed ``(rounds, K)`` table of link up/down
  states and compute slow-factors, built by seeded scenario constructors
  (``flapping`` links, ``mass_waves`` of correlated join/leave,
  ``straggler_storm`` compute degradation, or ``combined``).  Pure data:
  a script is a function of ``(scenario, K, rounds, seed)`` and nothing
  else, so every drill replays bitwise.  Every round keeps >= 1 client
  up (an all-dead fleet would just end the run — a different drill).
* ``ScriptedCluster`` — the matching compute side: fixed per-client base
  times scaled by the script's slow factors (one modeled "iteration" per
  dispatch, like the async tests' FixedSim).
* ``run_chaos_drill`` — builds the transport (zero bandwidth while a link
  is down -> ``Transport.transfer_time`` returns ``inf`` -> the client
  simply never reports; the virtual clock never blocks on it), runs
  ``fl.async_loop.run_federated_async`` through the script, and checks
  the runtime invariants on the resulting history with
  ``check_invariants``: monotone finite virtual clock, finite non-negative
  staleness, conserved aggregation weight mass, bounded drop counts.

Membership churn at the *controller* level (clients joining a FedAdapt
fleet mid-run) composes through ``runtime.elastic.admit_client`` /
``remove_client`` between drill segments; the failure-mask flavor of churn
(``FailureInjector``) stays on the synchronous loop, where round-keyed
masks (``round_mask(K, round_idx=r)``) make checkpoint replay exact.
Determinism and mid-drill checkpoint/resume are drilled in
tests/test_torch_chaos.py.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.fl.comm import Transport


class ChaosScript:
    """A deterministic churn scenario: per-(round, client) link state and
    compute slow-factor tables, plus the base link bandwidth.

    ``up[r, k]`` — link up (True) or dead (False) while the server is at
    version ``r``; ``slow[r, k]`` — multiplier >= 1 on client ``k``'s
    compute time.  Lookups clamp the round index to the last row, so a run
    longer than the script holds the final state.  Scripts guarantee at
    least one live client per row."""

    def __init__(self, up: np.ndarray, slow: np.ndarray,
                 base_bps: float = 75e6, name: str = "custom"):
        up = np.asarray(up, bool)
        slow = np.asarray(slow, np.float64)
        if up.ndim != 2 or up.shape != slow.shape:
            raise ValueError(f"up {up.shape} and slow {slow.shape} must be "
                             f"matching (rounds, K) tables")
        if not up.any(axis=1).all():
            raise ValueError("script has a round with every link dead")
        if (slow < 1.0).any():
            raise ValueError("slow factors must be >= 1")
        self.up = up
        self.slow = slow
        self.base_bps = float(base_bps)
        self.name = name
        self.rounds, self.num_clients = up.shape

    # -- seeded scenario constructors -----------------------------------
    @classmethod
    def flapping(cls, num_clients: int, rounds: int, seed: int = 0,
                 p_down: float = 0.3, base_bps: float = 75e6
                 ) -> "ChaosScript":
        """Independently flapping links: each (round, client) link is down
        with probability ``p_down`` — the memoryless worst case for the
        scheduler's in-flight bookkeeping."""
        rng = np.random.RandomState(seed)
        up = rng.rand(rounds, num_clients) >= p_down
        cls._force_survivor(up, seed)
        return cls(up, np.ones_like(up, np.float64), base_bps,
                   name=f"flapping(p={p_down})")

    @classmethod
    def mass_waves(cls, num_clients: int, rounds: int, seed: int = 0,
                   wave_len: int = 3, wave_frac: float = 0.5,
                   period: int = 8, base_bps: float = 75e6) -> "ChaosScript":
        """Correlated join/leave waves: every ``period`` rounds a seeded
        ``wave_frac`` subset of the fleet drops for ``wave_len`` rounds and
        then rejoins — the mass-disconnect shape of fleet-wide pushes,
        NAT rebinds or regional outages."""
        rng = np.random.RandomState(seed)
        up = np.ones((rounds, num_clients), bool)
        n_out = min(num_clients - 1, max(1, int(round(wave_frac
                                                      * num_clients))))
        for start in range(0, rounds, max(period, 1)):
            out = rng.choice(num_clients, size=n_out, replace=False)
            up[start:start + wave_len, out] = False
        cls._force_survivor(up, seed)
        return cls(up, np.ones_like(up, np.float64), base_bps,
                   name=f"mass_waves(frac={wave_frac})")

    @classmethod
    def straggler_storm(cls, num_clients: int, rounds: int, seed: int = 0,
                        storm_frac: float = 0.5, slow_factor: float = 8.0,
                        storm_len: int = 4, period: int = 10,
                        base_bps: float = 75e6) -> "ChaosScript":
        """Compute degradation storms: a seeded subset periodically runs
        ``slow_factor`` x slower (thermal throttling, co-tenant load) while
        every link stays up — pure staleness pressure."""
        rng = np.random.RandomState(seed)
        up = np.ones((rounds, num_clients), bool)
        slow = np.ones((rounds, num_clients), np.float64)
        n_slow = max(1, int(round(storm_frac * num_clients)))
        for start in range(0, rounds, max(period, 1)):
            hit = rng.choice(num_clients, size=n_slow, replace=False)
            slow[start:start + storm_len, hit] = float(slow_factor)
        return cls(up, slow, base_bps,
                   name=f"straggler_storm(x{slow_factor})")

    @classmethod
    def combined(cls, num_clients: int, rounds: int, seed: int = 0,
                 base_bps: float = 75e6) -> "ChaosScript":
        """Everything at once: flapping links + leave waves + straggler
        storms, on decorrelated sub-seeds."""
        a = cls.flapping(num_clients, rounds, seed=seed * 3 + 1,
                         p_down=0.15, base_bps=base_bps)
        b = cls.mass_waves(num_clients, rounds, seed=seed * 3 + 2,
                           base_bps=base_bps)
        c = cls.straggler_storm(num_clients, rounds, seed=seed * 3 + 3,
                                base_bps=base_bps)
        up = a.up & b.up
        cls._force_survivor(up, seed)
        return cls(up, c.slow, base_bps, name="combined")

    @staticmethod
    def _force_survivor(up: np.ndarray, seed: int) -> None:
        """Deterministically force >= 1 live client per round (in place):
        round ``r`` revives client ``(seed + r) % K`` if all are dead."""
        rounds, K = up.shape
        for r in np.flatnonzero(~up.any(axis=1)):
            up[r, (seed + int(r)) % K] = True

    # -- lookups (round index clamped to the script length) -------------
    def _row(self, round_idx: int) -> int:
        return min(max(int(round_idx), 0), self.rounds - 1)

    def bandwidths(self, round_idx: int) -> np.ndarray:
        """Per-client bits/s at this round (0.0 while the link is down)."""
        return np.where(self.up[self._row(round_idx)], self.base_bps, 0.0)

    def slow_factors(self, round_idx: int) -> np.ndarray:
        return self.slow[self._row(round_idx)]

    def bandwidth_fn(self, round_idx: int, device: int) -> float:
        return float(self.base_bps
                     if self.up[self._row(round_idx), device] else 0.0)

    def transport(self, latency_s: float = 0.0) -> Transport:
        """The drill's Transport: zero bandwidth while down -> ``inf``
        transfer time -> the client never reports (no special-casing in
        the scheduler)."""
        return Transport(bandwidth_fn=self.bandwidth_fn, latency_s=latency_s)


class ScriptedCluster:
    """FixedSim-style compute model for drills: per-client base times scaled
    by the script's slow factors; one modeled iteration per dispatch.  Duck-
    typed to the ``SimulatedCluster`` surface the loops touch
    (``iterations``, ``bandwidths``, ``round_times``,
    ``round_compute_times``)."""

    def __init__(self, base_times: Sequence[float], script: ChaosScript):
        self.base = np.asarray(base_times, np.float64)
        if len(self.base) != script.num_clients:
            raise ValueError(f"{len(self.base)} base times for "
                             f"{script.num_clients} scripted clients")
        self.script = script
        self.iterations = 1

    def bandwidths(self, round_idx: int) -> np.ndarray:
        return self.script.bandwidths(round_idx)

    def round_compute_times(self, ops, round_idx: int) -> np.ndarray:
        return self.base * self.script.slow_factors(round_idx)

    def round_times(self, ops, round_idx: int) -> np.ndarray:
        return self.round_compute_times(ops, round_idx)


def check_invariants(history: Dict[str, np.ndarray], num_clients: int
                     ) -> List[str]:
    """Runtime invariants every chaos drill must satisfy; returns violation
    descriptions (empty = healthy).

    * the run made progress and the virtual clock is finite and
      non-decreasing across aggregations;
    * per-aggregation wall time is non-negative;
    * staleness is finite and non-negative (staleness weighting never saw
      a time-travelling update);
    * aggregation weight mass is conserved: ~1.0 whenever any update was
      applied, exactly 0.0 when the whole buffer was discarded;
    * drop counts stay within the fleet size;
    * the eval metric never went NaN/inf (training survived numerically).
    """
    v: List[str] = []
    n = len(history.get("accuracy", []))
    if n == 0:
        v.append("no aggregations happened (deadlocked or instantly dead)")
        return v
    vt = np.asarray(history["virtual_time"], np.float64)
    if not np.isfinite(vt).all():
        v.append("virtual_time has non-finite entries")
    if (np.diff(vt) < 0).any():
        v.append("virtual clock went backwards")
    rt = np.asarray(history["round_time"], np.float64)
    if (rt < 0).any() or not np.isfinite(rt).all():
        v.append("negative or non-finite per-aggregation wall time")
    st = np.asarray(history["staleness"], np.float64)
    if (st < 0).any() or not np.isfinite(st).all():
        v.append("negative or non-finite staleness")
    if "agg_weight_sum" in history:
        ws = np.asarray(history["agg_weight_sum"], np.float64)
        bad = ~(np.isclose(ws, 1.0, atol=1e-9) | (ws == 0.0))
        if bad.any():
            v.append(f"aggregation weight mass not conserved: "
                     f"{ws[bad][:3].tolist()}")
    dropped = np.asarray(history["dropped"])
    if (dropped < 0).any() or (dropped > num_clients).any():
        v.append("drop count outside [0, K]")
    acc = np.asarray(history["accuracy"], np.float64)
    if not np.isfinite(acc).all():
        v.append("eval metric went non-finite")
    return v


@dataclasses.dataclass
class DrillResult:
    """One drill's outcome: the full training history, the invariant
    violations (empty = passed) and the script that produced it."""
    history: Dict[str, np.ndarray]
    violations: List[str]
    script: ChaosScript

    def ok(self) -> bool:
        return not self.violations


def run_chaos_drill(
    cfg,
    clients_data: List[Dict[str, np.ndarray]],
    test_data: Dict[str, np.ndarray],
    fl,
    script: ChaosScript,
    base_times: Optional[Sequence[float]] = None,
    controller=None,
    planner=None,
    resume: bool = False,
    latency_s: float = 0.0,
    init_params=None,
    device=None,
) -> DrillResult:
    """Run ``run_federated_async`` through a churn script and check the
    runtime invariants.  ``base_times`` defaults to a spread of per-client
    compute times so buffers actually interleave (all-equal times would
    degenerate to synchronous rounds).  All arguments are deterministic, so
    the whole drill is a pure function of ``(cfg, data, fl, script)`` —
    tests replay it bitwise from the seed and from mid-drill checkpoints
    (``fl.checkpoint_dir`` + ``resume=True``).  ``init_params`` and
    ``device`` (``None``: the card) go to ``run_federated_async``."""
    from repro_torch.fl.async_loop import run_federated_async
    K = len(clients_data)
    if script.num_clients != K:
        raise ValueError(f"script is for {script.num_clients} clients, "
                         f"data has {K}")
    if base_times is None:
        base_times = 1.0 + np.arange(K, dtype=np.float64) / max(1, K - 1)
    sim = ScriptedCluster(base_times, script)
    hist = run_federated_async(cfg, clients_data, test_data, fl, sim=sim,
                               controller=controller, planner=planner,
                               transport=script.transport(latency_s),
                               resume=resume, init_params=init_params,
                               device=device)
    return DrillResult(history=hist,
                       violations=check_invariants(hist, K),
                       script=script)
