"""Inference side of the port (counterpart of ``repro/serving``):
continuous-batching serving of a dense transformer.

    engine.py   ServeEngine: fixed slot pool, per-slot decode positions;
                reference_decode, the sequential oracle
    hotswap.py  ParamStore: versioned flat-buffer snapshots published by
                fl/async_loop's on_aggregate hook, adopted by
                ServeEngine.maybe_swap
    queue.py    Request / TrafficGenerator / ServeCosts / serve: seeded
                Poisson traffic and the virtual-clock serve loop
"""
from repro_torch.serving.engine import (  # noqa: F401
    FinishedRequest,
    ServeEngine,
    reference_decode,
)
from repro_torch.serving.hotswap import ParamStore  # noqa: F401
from repro_torch.serving.queue import (  # noqa: F401
    Request,
    ServeCosts,
    TrafficGenerator,
    latency_stats,
    serve,
)
