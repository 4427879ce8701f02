"""The device trace of a traced sub-window: ``torch.profiler`` started and
stopped by the harness around whole rounds (a sync at each edge), read
into kernel intervals, the device's busy time, the longest device
operations and the longest idle gaps by what the host was doing."""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

MARK = "portbench.subwindow"


@dataclasses.dataclass
class Trace:
    start_ns: int
    end_ns: int
    device_ops: List[Tuple[str, int, int]]   # (name, start, end), ns
    host_ops: List[Tuple[str, int, int]]
    rounds: int                              # whole rounds traced

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def merged(self) -> List[Tuple[int, int]]:
        """The device's busy intervals, clipped to the sub-window."""
        spans = sorted((max(s, self.start_ns), min(e, self.end_ns))
                       for _, s, e in self.device_ops)
        out: List[Tuple[int, int]] = []
        for s, e in spans:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) * 1e-9

    def device_seconds(self, names: List[str]) -> float:
        """Device seconds of the operations whose name holds one of
        ``names``."""
        return sum(e - s for n, s, e in self.device_ops
                   if any(k in n for k in names)) * 1e-9

    def gaps(self) -> List[Tuple[int, int]]:
        busy, out, t = self.merged(), [], self.start_ns
        for s, e in busy:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.end_ns > t:
            out.append((t, self.end_ns))
        return out

    def host_at(self, t: int) -> str:
        """The innermost host operation running at ``t``."""
        best: Optional[Tuple[int, str]] = None
        for name, s, e in self.host_ops:
            if s <= t < e and name != MARK and (best is None
                                                 or e - s < best[0]):
                best = (e - s, name)
        return best[1] if best is not None else "(between host operations)"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_name: Dict[str, int] = collections.defaultdict(int)
        for n, s, e in self.device_ops:
            by_name[short(n)] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, ns * 1e-9] for n, ns in ops],
                "idle_gaps": [[self.host_at((s + e) // 2), (e - s) * 1e-9]
                              for s, e in gaps]}


def short(name: str) -> str:
    """A kernel's name without its return type and parameter list, at
    most 120 letters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].strip()[:120]


class Tracer:
    """``torch.profiler`` over CPU and CUDA activity between ``start`` and
    ``stop``, the sub-window marked by a host annotation."""

    def __init__(self, device: torch.device, rounds: int):
        self.device, self.rounds = device, rounds
        self.prof = None
        self.mark = None
        self.result: Optional[Trace] = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.mark = torch.profiler.record_function(MARK)
        self.mark.__enter__()

    def stop(self) -> None:
        if self.prof is None:
            return
        self._sync()
        self.mark.__exit__(None, None, None)
        self.prof.stop()
        self.result = read_events(self.prof.profiler.kineto_results.events(),
                                  self.rounds)
        self.prof = None


def read_events(events, rounds: int) -> Trace:
    """The profiler's events as a ``Trace``: device operations (kernels,
    copies, sets; not the device-side ranges of host annotations), host
    operations and the sub-window's mark."""
    dev, host, window = [], [], None
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        on_device = ev.device_type() == torch.autograd.DeviceType.CUDA
        if ev.name() == MARK:
            if not on_device:
                window = (s, e)
        elif on_device:
            if not ev.is_user_annotation():
                dev.append((ev.name(), s, e))
        else:
            host.append((ev.name(), s, e))
    if window is None:
        raise RuntimeError(f"the trace holds no {MARK!r} annotation")
    return Trace(window[0], window[1], dev, host, rounds)
