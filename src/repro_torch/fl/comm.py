"""Simulated transport between clients and the server (paper §V-A/§V-D);
a copy of ``repro/fl/comm.py``.

The paper emulates Wi-Fi / 4G by throttling a real link with Linux ``tc``;
here the transport is a bandwidth schedule plus time accounting, and the
payloads themselves can be compressed (int8 smashed data via
kernels/quant_transfer, top-k weight deltas via kernels/topk_compress).
The same abstraction models cross-pod DCN links in the datacenter runs.

Units, fixed across the codebase: ``bandwidth_fn(round, device)`` returns
**bits/s** (the paper quotes Mbps; 75 Mbps == ``75e6``); ``transfer_time``
takes payload **bytes** and returns **seconds** (``latency_s`` added per
transfer, so a round trip pays it twice); ``compression_ratio`` < 1 scales
the modelled bytes of *every* transfer (use the explicit quantize/density
knobs in ``FLConfig`` for payload-specific compression instead).

``run_federated`` charges, per device per round,
``local_iters x round_comm_time(cut up, cut down)`` for the smashed-data
round trips (activations up, gradients back — zero at the native OP) plus
one ``round_comm_time(delta up, model down)`` weight sync; see
``fl/loop.py``.  ``paper_schedule`` reproduces §V-D's
5-slot throttling: from ``start_round`` each device in turn drops to
``low_bps`` for ``slot_len`` rounds (Jetson first, Pi3-2 last).

Two-hop accounting (``fl/hierarchy.py``): under the two-tier server the
client-side ``transport`` above is the client->edge hop, and an optional
``edge_transport`` is the edge->root hop: one pre-reduced fp32 row up and
the model down per *edge* per aggregation, charged by
``RoundClock.edge_hop_times`` with the edge index as the ``device``
argument (``indexed_bandwidths`` builds per-edge links).  No
``edge_transport`` means a free root hop, which keeps single-tier runs
bit for bit as they were.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

BandwidthFn = Callable[[int, int], float]


@dataclasses.dataclass
class Transport:
    bandwidth_fn: BandwidthFn                     # (round, device) -> bits/s
    compression_ratio: float = 1.0                # <1 => compressed payloads
    latency_s: float = 0.0

    def transfer_time(self, nbytes: float, round_idx: int,
                      device: int) -> float:
        bw = self.bandwidth_fn(round_idx, device)
        if bw <= 0.0:
            # dead link: the transfer never completes.  The sync loop's
            # deadline path drops inf clients; the async runtime leaves them
            # in flight forever (runtime/scheduler.py).
            return float("inf")
        return self.latency_s + (nbytes * self.compression_ratio * 8.0) / bw

    def round_comm_time(self, up_bytes: float, down_bytes: float,
                        round_idx: int, device: int) -> float:
        return (self.transfer_time(up_bytes, round_idx, device)
                + self.transfer_time(down_bytes, round_idx, device))


def constant_bandwidth(bps: float) -> BandwidthFn:
    return lambda r, d: bps


def indexed_bandwidths(bps) -> BandwidthFn:
    """Constant per-index bandwidths from a plain sequence: the edge
    uplinks of the two-tier server (index = edge id), or any fleet slice
    without a ``DeviceProfile``."""
    bps = [float(b) for b in bps]
    return lambda r, d: bps[d]


def device_bandwidths(devices) -> BandwidthFn:
    """Per-device constant bandwidths from ``costmodel.DeviceProfile``s."""
    bps = [d.bandwidth_bps for d in devices]
    return lambda r, d: bps[d]


def paper_schedule(base_bps: float = 75e6, low_bps: float = 10e6,
                   start_round: int = 50, slot_len: int = 10) -> BandwidthFn:
    """Paper §V-D: rounds [start, start+5*slot_len) are divided into 5 slots;
    in slot i, device i is throttled to ``low_bps`` (Jetson first, Pi3-2
    last); all other devices keep ``base_bps``."""
    def fn(round_idx: int, device: int) -> float:
        if round_idx < start_round:
            return base_bps
        slot = (round_idx - start_round) // slot_len
        return low_bps if slot == device else base_bps
    return fn
