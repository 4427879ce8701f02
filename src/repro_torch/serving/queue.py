"""Admission queue, seeded traffic generator, and the virtual-clock serve
loop (counterpart of ``repro/serving/queue.py``).

Latency numbers from a benchmark are only comparable when the load is
reproducible, so traffic here is *modeled*, not measured: arrivals are a
seeded Poisson process with mixed prompt/generation lengths, and the serve
loop runs on the same virtual clock as the async federated runtime
(``runtime.scheduler.EventQueue`` — one clock implementation, not a fork).
Each engine operation advances the clock by a fixed modeled cost
(``ServeCosts``; the benchmark calibrates the costs from real wall-clock
once, then the simulation is a pure function of ``(traffic seed, costs)``).

The loop models a single-server continuous-batching executor:

* arrivals sit in a FIFO admission queue until a slot frees up;
* every free slot is claimed immediately (one prefill each, admitted
  requests join the *current* decode batch — continuous batching, no
  round barrier);
* one decode step serves every active slot at once and costs
  ``costs.decode`` regardless of occupancy (the fixed-shape pool computes
  all rows — exactly how the real engine behaves);
* a hot swap (``ParamStore`` version bump between iterations) costs
  ``costs.swap`` once, on the iteration that adopts it.

``serve`` returns per-request records (arrival / admit / first-token /
done virtual times plus the generated tokens) and aggregate stats
(latency percentiles, slot occupancy, queue depth, swap count).

A copy of the reference's ``serving/queue.py`` over the port's engine and
``EventQueue``: the same seed gives the same requests, bitwise.  Passing a
``store`` (``serving.hotswap.ParamStore``) swaps params live through
``ServeEngine.maybe_swap``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.runtime.scheduler import EventQueue
from repro_torch.serving.engine import ServeEngine


@dataclasses.dataclass
class Request:
    """One inference request.  ``arrival`` is virtual seconds; the t_*
    result fields are filled by ``serve``."""
    rid: int
    arrival: float
    prompt: np.ndarray              # (prompt_len,) int32
    gen: int                        # total tokens to generate (>= 1)
    t_admit: float = -1.0           # claimed a slot (prefill started)
    t_first: float = -1.0           # first token out (prefill done)
    t_done: float = -1.0            # last token out
    tokens: Optional[List[int]] = None

    @property
    def latency(self) -> float:
        return self.t_done - self.arrival

    @property
    def ttft(self) -> float:
        return self.t_first - self.arrival


class TrafficGenerator:
    """Deterministic Poisson arrivals with mixed prompt/generation lengths.

    Inter-arrival gaps are exponential with mean ``1/rate`` (virtual
    seconds); prompt and generation lengths are drawn uniformly from the
    given grids; prompt tokens are uniform over the vocabulary.  Everything
    comes from one seeded ``RandomState``, so the same ``(seed, rate, n)``
    reproduces the same workload bitwise — the reproducibility contract of
    BENCH_serving.json.
    """

    def __init__(self, rate: float, n_requests: int, vocab_size: int,
                 prompt_lens=(4, 8, 16), gen_lens=(2, 4, 8), seed: int = 0):
        if rate <= 0:
            raise ValueError(f"arrival rate must be positive, got {rate}")
        self.rate = float(rate)
        self.n_requests = int(n_requests)
        self.vocab_size = int(vocab_size)
        self.prompt_lens = tuple(int(p) for p in prompt_lens)
        self.gen_lens = tuple(int(g) for g in gen_lens)
        self.seed = int(seed)

    def generate(self) -> List[Request]:
        rng = np.random.RandomState(self.seed)
        t, out = 0.0, []
        for rid in range(self.n_requests):
            t += float(rng.exponential(1.0 / self.rate))
            plen = int(rng.choice(self.prompt_lens))
            gen = int(rng.choice(self.gen_lens))
            prompt = rng.randint(0, self.vocab_size, size=plen,
                                 dtype=np.int64).astype(np.int32)
            out.append(Request(rid=rid, arrival=t, prompt=prompt, gen=gen))
        return out


@dataclasses.dataclass
class ServeCosts:
    """Modeled virtual-time cost of each engine operation (seconds).  The
    benchmark calibrates these from measured medians; tests pin them."""
    prefill: float = 1.0
    decode: float = 1.0
    swap: float = 0.0


def serve(engine: ServeEngine, requests: List[Request], costs: ServeCosts,
          store=None, on_tick: Optional[Callable[[float], None]] = None,
          ) -> Dict:
    """Run ``requests`` through ``engine`` on the virtual clock.

    ``store`` enables live hot swapping (checked every iteration, adopted
    between decode steps).  ``on_tick(now)`` fires once per loop iteration —
    the benchmark uses it to publish new param versions mid-run, emulating
    the training loop aggregating concurrently.

    Returns ``{"requests", "occupancy", "queue_depth", "swaps",
    "makespan", "decode_steps"}``; every request in the result has its
    timing fields and generated tokens filled.
    """
    clock = EventQueue()
    for r in sorted(requests, key=lambda r: (r.arrival, r.rid)):
        clock.push(r.arrival, r)
    pending: deque = deque()
    done: List[Request] = []
    by_rid = {r.rid: r for r in requests}
    occupancy: List[int] = []
    queue_depth: List[int] = []
    swap_times: List[float] = []
    decode_steps = 0

    def drain_arrivals() -> None:
        while len(clock) and clock.peek_time() <= clock.now:
            _, r = clock.pop()
            pending.append(r)

    while len(done) < len(requests):
        drain_arrivals()
        if engine.num_active == 0 and not pending:
            # idle: jump the clock to the next arrival
            _, r = clock.pop()
            pending.append(r)
        # admission: claim every free slot (continuous batching — admitted
        # requests join the in-flight decode batch immediately)
        while pending and engine.free_slots > 0:
            r = pending.popleft()
            r.t_admit = clock.now
            fin = engine.submit(r.rid, r.prompt, r.gen)
            clock.advance(costs.prefill)
            r.t_first = clock.now
            if fin is not None:               # gen == 1: done at prefill
                r.tokens, r.t_done = fin.tokens, clock.now
                done.append(r)
            drain_arrivals()
        if on_tick is not None:
            on_tick(clock.now)
        if store is not None and engine.maybe_swap(store):
            clock.advance(costs.swap)
            swap_times.append(clock.now)
        if engine.num_active:
            occupancy.append(engine.num_active)
            queue_depth.append(len(pending))
            finished = engine.step()
            clock.advance(costs.decode)
            decode_steps += 1
            for fin in finished:
                r = by_rid[fin.rid]
                r.tokens, r.t_done = fin.tokens, clock.now
                done.append(r)

    return {"requests": requests, "occupancy": np.asarray(occupancy),
            "queue_depth": np.asarray(queue_depth), "swaps": swap_times,
            "makespan": clock.now, "decode_steps": decode_steps}


def latency_stats(result: Dict) -> Dict[str, float]:
    """Aggregate the ``serve`` result into the benchmark's headline row."""
    reqs: List[Request] = result["requests"]
    lat = np.asarray([r.latency for r in reqs])
    ttft = np.asarray([r.ttft for r in reqs])
    tokens = int(sum(len(r.tokens) for r in reqs))
    occ = result["occupancy"]
    return {
        "n_requests": len(reqs),
        "tokens": tokens,
        "p50_latency": float(np.percentile(lat, 50)),
        "p95_latency": float(np.percentile(lat, 95)),
        "p99_latency": float(np.percentile(lat, 99)),
        "mean_latency": float(lat.mean()),
        "p50_ttft": float(np.percentile(ttft, 50)),
        "p99_ttft": float(np.percentile(ttft, 99)),
        "tokens_per_s": tokens / result["makespan"],
        "mean_occupancy": float(occ.mean()) if len(occ) else 0.0,
        "mean_queue_depth": (float(result["queue_depth"].mean())
                             if len(result["queue_depth"]) else 0.0),
        "swaps": len(result["swaps"]),
    }
