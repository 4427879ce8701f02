"""Ablations of the SSD-scan kernel on the card: where its time goes.

    python3 scripts/ssd_ablation.py      # from the repository root, one GPU

A development script, outside the port's package: nothing the port runs
calls it.  Each variant is ``src/repro_torch/kernels/csrc/ssd_scan.cu`` with
one textual change, built by ``scripts/variants.py``, called through the
port's own wrapper ``ssd_scan`` (the variant's library in place of the
kernel's, so the wrapper's checks and scratch hold) and timed by
``chip_smoke.time_ms`` (CUDA events over CUDA-graph replays) at
mamba2-780m's prefill shape (B=1, S=4096, H=48, P=64, N=128, chunk 128) on
seeded inputs, in turns, beside ``ssd_scan_plain``; each pass's device time
comes from ``torch.profiler``.  A variant that changes the arithmetic
prints its error against the plain version: it is a measurement of the
kernel's parts, never a kernel the port calls.

- ``kernel``: the source as it is.
- ``1xTF32``: only the hi.hi products (a third of the mma instructions,
  the split unchanged): ~1e-3 off.
- ``no split``: the three products on the raw fp32 bits, without the
  rounding work (the mma instructions unchanged): wrong results.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from chip_smoke import time_ms  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import ssd_scan as ts  # noqa: E402
from variants import build_variants  # noqa: E402

VARIANTS = {
    "kernel": [],
    "1xTF32": [("  mma_tf32(sl, a.lo, b.hi);\n  mma_tf32(sl, a.hi, b.lo);\n",
                "")],
    "no split": [("  hi = to_tf32(x);\n"
                  "  lo = to_tf32(x - __uint_as_float(hi));",
                  "  hi = __float_as_uint(x);\n"
                  "  lo = __float_as_uint(x) ^ 1u;")],
}
SHAPE = (1, 4096, 48, 64, 128)   # B, S, H, P, N
CHUNK = 128


def pass_ms(fn, calls: int = 10) -> dict:
    """Device ms per call of each ``ssd_scan_*`` kernel, from the
    profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "ssd_scan_" in e.key:
            name = "ssd_scan_" + e.key.split("ssd_scan_", 1)[1].split("(")[0]
            out[name] = e.self_device_time_total / calls / 1e3
    return out


def main(rounds: int = 2) -> None:
    if not torch.cuda.is_available():
        sys.exit("ssd_ablation: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    libs = build_variants("ssd_scan", VARIANTS, ts._SIGNATURES)
    gen = torch.Generator().manual_seed(0)
    B, S, H, P, N = SHAPE
    x = torch.randn((B, S, H, P), generator=gen).cuda()
    # dt in the range of mamba2's init (softplus of the bias: 1e-3 .. 1e-1)
    dt = (torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen))
          * 0.05).cuda()
    A = -torch.exp(torch.randn((H,), generator=gen) * 0.5).cuda()
    Bm = torch.randn((B, S, N), generator=gen).cuda()
    Cm = torch.randn((B, S, N), generator=gen).cuda()
    want = ts.ssd_scan_plain(x, dt, A, Bm, Cm, CHUNK)[0]
    def run():
        return ts.ssd_scan(x, dt, A, Bm, Cm, CHUNK)[0]
    kernel_lib = ts._lib
    try:
        for _ in range(rounds):
            for name, lib in libs.items():
                ts._lib = lambda lib=lib: lib
                err = float((run() - want).abs().max())
                ms = time_ms(run, reps=7, inner=5)
                parts = ", ".join(f"{k} {v:.4f}"
                                  for k, v in pass_ms(run).items())
                print(f"{name:8s} | {ms:.4f} ms (max abs err {err:.3g}, "
                      f"max|want| {float(want.abs().max()):.3g}) | {parts}",
                      flush=True)
    finally:
        ts._lib = kernel_lib
    plain = time_ms(lambda: ts.ssd_scan_plain(x, dt, A, Bm, Cm, CHUNK),
                    reps=7, inner=5)
    print(f"ssd_scan_plain: {plain:.4f} ms")


if __name__ == "__main__":
    main()
