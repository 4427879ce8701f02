"""Virtual-clock event scheduler (a copy of the reference's
``runtime/scheduler.py``; pure Python, ``heapq``).

The serving loop (``serving/queue.py``) schedules request arrivals on it
and advances the clock by modeled prefill/decode costs, so its latency
results are a pure function of the traffic seed and the cost model; the
async federated loop (``fl/async_loop.py``) schedules client reports.

The contract: a monotonic virtual clock plus a priority queue of
timestamped events, with deterministic FIFO tie-breaking (two events at
the same virtual time pop in push order), so a run's event order is a pure
function of the pushed times — no wall-clock, no RNG.  ``push`` schedules,
``pop`` delivers the earliest event and advances the clock to its time,
``advance`` moves the clock through a modeled service duration between
events, ``peek_time`` inspects without advancing.

Infinite timestamps are legal: a client behind a dead link
(``Transport.transfer_time`` returns ``inf`` at zero bandwidth) simply
never completes.  Consumers should check ``peek_time`` before popping —
popping an ``inf`` event would advance the clock to ``inf`` — which is how
the async loop detects a fully-stalled fleet.
"""
from __future__ import annotations

import heapq
import math
from typing import Any, List, Tuple

__all__ = ["EventQueue"]


class EventQueue:
    """Min-heap of ``(time, payload)`` events on a monotonic virtual clock."""

    def __init__(self, start_time: float = 0.0):
        self._heap: List[Tuple[float, int, Any]] = []
        self._seq = 0
        self.now = float(start_time)

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, time: float, payload: Any) -> None:
        """Schedule ``payload`` at virtual ``time`` (>= now; inf allowed)."""
        t = float(time)
        if math.isnan(t):
            raise ValueError("event time is NaN")
        if t < self.now:
            raise ValueError(
                f"causality violation: event at t={t} pushed when the "
                f"virtual clock is already at {self.now}")
        heapq.heappush(self._heap, (t, self._seq, payload))
        self._seq += 1

    def peek_time(self) -> float:
        """Timestamp of the next event (``inf`` if the queue is empty)."""
        return self._heap[0][0] if self._heap else float("inf")

    def pop(self) -> Tuple[float, Any]:
        """Remove the earliest event and advance the clock to its time."""
        if not self._heap:
            raise IndexError("pop from an empty EventQueue")
        t, _, payload = heapq.heappop(self._heap)
        self.now = max(self.now, t)
        return t, payload

    def snapshot(self) -> List[Tuple[float, int, Any]]:
        """Every pending event as ``(time, seq, payload)`` in pop order —
        the checkpoint view of the scheduler (fl/async_loop.py snapshots
        the in-flight report table through this instead of reaching into
        the heap).  Re-pushing the payloads in this order reproduces the
        original FIFO tie-breaking."""
        return sorted(self._heap)

    def drop_unreachable(self) -> List[Any]:
        """Remove every event scheduled at ``t=inf`` and return their
        payloads in push order.

        An ``inf`` event is a client that can never report under its
        dispatch-time conditions (dead link).  The async loop calls this at
        aggregation boundaries to re-dispatch those clients against the
        *current* conditions — reconnection semantics: a client behind a
        flapping link rejoins with the current model once the link
        recovers, instead of being lost to the fleet forever."""
        dropped = [e for e in self._heap if math.isinf(e[0])]
        if dropped:
            self._heap = [e for e in self._heap if not math.isinf(e[0])]
            heapq.heapify(self._heap)
        return [payload for _, _, payload in sorted(dropped)]

    def advance(self, dt: float) -> float:
        """Move the clock forward by a modeled duration ``dt >= 0`` (e.g.
        one decode step of the serving loop); returns the new ``now``.
        Events whose time has passed are still delivered by ``pop`` — the
        clock never rewinds to them."""
        dt = float(dt)
        if not math.isfinite(dt) or dt < 0:
            raise ValueError(f"advance needs a finite dt >= 0, got {dt}")
        self.now += dt
        return self.now
