"""Host or device: where a mamba2-780m prefill's time goes, by prompt length.

    python3 scripts/mamba2_prefill_host.py [--src DIR] [--tag NAME]

A development script, outside the port's package: nothing the port runs
calls it.  mamba2-780m at full width (random fp32 weights from seed 0) on
one GPU, TF32 off as in ``chip_smoke.py``.  For seeded prompts of 300, 1000
and 4096 tokens:

- the wall time of ``api.prefill`` (host clock around the call and a device
  sync): median, min and max of 10 calls after 2 warm-up calls;
- one more prefill under ``torch.profiler``: its wall and device busy
  time, its device kernels (launches), and the SSD scan's part of both;
- the SSD-scan wrapper alone on layer 0's inputs of that prefill: host
  microseconds per call (100 calls issued back to back, the clock read
  before the sync) and wall microseconds per call (to the sync).

Then 20 decode steps at 1 row, which never reach the SSD scan: a yardstick
of the host's speed.  ``--src`` names the ``src`` directory whose
``repro_torch`` is imported (default: this checkout's), so that two trees
can be compared on one card, each in a process of its own.  Prints the
card's name and power limit, then one JSON object on the last line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

PROMPTS = (300, 1000, 4096)


def prefill_profile(torch, fn):
    """Wall ms, device busy ms, device kernels, and the ``ssd_scan_*``
    kernels' ms and count, of one ``fn()`` under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    stats = [(e.key, e.self_device_time_total, e.count)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and e.self_device_time_total > 0]
    ssd = [(t, c) for k, t, c in stats if "ssd_scan" in k]
    return {"wall_ms": wall,
            "device_busy_ms": sum(t for _, t, _ in stats) / 1e3,
            "device_kernels": sum(c for _, _, c in stats),
            "ssd_scan_ms": sum(t for t, _ in ssd) / 1e3,
            "ssd_scan_kernels": sum(c for _, c in ssd)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--tag", default="tree")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("mamba2_prefill_host: no CUDA device")
    from repro_torch.configs.mamba2_780m import CONFIG as cfg
    from repro_torch.kernels import _build
    from repro_torch.models import api
    from repro_torch.models import ssm as S_model
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all(["ssd_scan"])
    dev = torch.device("cuda")
    params = api.init(cfg, seed=0, device=dev)
    out = {"tag": args.tag, "src": args.src, "prefill": {}}
    for L in PROMPTS:
        tokens = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab_size, L)[None]).to(dev)

        def run():
            return api.prefill(cfg, params, {"tokens": tokens})
        walls = []
        for i in range(12):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            if i >= 2:
                walls.append((time.perf_counter() - t0) * 1e3)
        row = {"wall_ms_median": statistics.median(walls),
               "wall_ms_min": min(walls), "wall_ms_max": max(walls),
               "profile": prefill_profile(torch, run)}
        # layer 0's SSD-scan inputs, then the wrapper alone on them
        kernel, caught = S_model.ssd_scan, []

        def capture(*a, **kw):
            if not caught:
                caught.append((a, kw))
            return kernel(*a, **kw)
        S_model.ssd_scan = capture
        try:
            run()
        finally:
            S_model.ssd_scan = kernel
        a, kw = caught[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            kernel(*a, **kw)
        host = (time.perf_counter() - t0) * 1e4
        torch.cuda.synchronize()
        row["ssd_scan_host_us"] = host
        row["ssd_scan_wall_us"] = (time.perf_counter() - t0) * 1e4
        out["prefill"][str(L)] = row
        print(f"{args.tag} prefill {L}: {json.dumps(row)}", flush=True)
    cache = api.init_cache(cfg, 1, 1, torch.float32, dev)
    token = torch.zeros((1, 1), dtype=torch.long, device=dev)
    steps = []
    for i in range(22):
        t0 = time.perf_counter()
        _, cache = api.decode(cfg, params, cache, token, i)
        torch.cuda.synchronize()
        if i >= 2:
            steps.append((time.perf_counter() - t0) * 1e3)
    out["decode_ms_median"] = statistics.median(steps)
    out["decode_ms_min"] = min(steps)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
