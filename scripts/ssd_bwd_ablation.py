"""Ablations of the SSD scan's backward kernel on the card: where its time
goes.

    python3 scripts/ssd_bwd_ablation.py      # from the repository root
    python3 scripts/ssd_bwd_ablation.py --source OTHER.cu --tag parent

A development script, outside the port's package: nothing the port runs
calls it.  Each variant is ``src/repro_torch/kernels/csrc/ssd_scan.cu``
with textual changes, built by ``scripts/variants.py``, called through the
port's own wrapper ``ssd_scan_bwd`` (the variant's library in place of the
kernel's, so the wrapper's checks and scratch hold) and timed by
``chip_smoke.time_ms`` (CUDA events over CUDA-graph replays) at
mamba2-780m's layer shape (B=1, S=4096, H=48, P=64, N=128, chunk 128) on
seeded inputs (dt in mamba2's range, A from -1 to -16), in turns; each of
its device kernels' time comes from ``torch.profiler``.  Each variant
prints its max abs error over y's gradients against
``ssd_scan_bwd_plain``, relative to the largest value: a variant that
changes the arithmetic is a measurement of the kernel's parts, never a
kernel the port calls.  ``--source`` adds another tree's ``ssd_scan.cu``
(same C interface; the parent's, for the backward's fp32 passes on the
CUDA cores before the redesign) as one more variant.

- ``kernel``: the source as it is.
- ``1xTF32``: only the hi.hi products (a third of the mma instructions,
  every split unchanged), in every pass (the forward's too, which the
  backward runs again): the cost of the two extra products; ~1e-3 off.
- ``no overlap``: every streamed copy is waited for right after it is
  issued, before the current chunk's products (B3's B/G and C/S stages,
  B5's k-chunks): what the cp.async double buffering buys.
- ``no head split``: B5 sums the heads' whole k-range (H P terms) in one
  CTA a tile, in one accumulator pair (one group: as many CTAs as the PR
  24 kernel, 256 at this shape): what the head groups buy, and the
  truncation that their fresh accumulators avoid.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from chip_smoke import time_ms  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import ssd_scan as ts  # noqa: E402
from ssd_ablation import pass_ms  # noqa: E402
from variants import build_sources, build_variants  # noqa: E402

VARIANTS = {
    "kernel": [],
    "1xTF32": [("  mma_tf32(sl, a.lo, b.hi);\n  mma_tf32(sl, a.hi, b.lo);\n",
                "")],
    "no overlap": [('  asm volatile("cp.async.wait_group 1;\\n" ::: '
                    '"memory");',
                    '  asm volatile("cp.async.wait_group 0;\\n" ::: '
                    '"memory");')],
    "no head split": [("constexpr int kGroupChunks = 4;",
                       "constexpr int kGroupChunks = 1 << 20;")],
}
SHAPE = (1, 4096, 48, 64, 128)   # B, S, H, P, N: mamba2-780m's layer
CHUNK = 128


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", type=Path, default=None,
                    help="another ssd_scan.cu to time beside")
    ap.add_argument("--tag", default="other")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("ssd_bwd_ablation: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    libs = build_variants("ssd_scan", VARIANTS, ts._SIGNATURES)
    if args.source is not None:
        libs.update(build_sources({args.tag: (args.source.resolve(),
                                              ts._SIGNATURES)}))
    gen = torch.Generator().manual_seed(0)
    B, S, H, P, N = SHAPE
    x = torch.randn((B, S, H, P), generator=gen).cuda()
    # dt in the range of mamba2's init (softplus of the bias: 1e-3 .. 1e-1)
    dt = (torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen))
          * 0.05).cuda()
    A = -torch.linspace(1.0, 16.0, H).cuda()
    Bm = torch.randn((B, S, N), generator=gen).cuda()
    Cm = torch.randn((B, S, N), generator=gen).cuda()
    dy = torch.randn((B, S, H, P), generator=gen).cuda()
    want = ts.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, CHUNK, None, dy)

    def run():
        return ts.ssd_scan_bwd(x, dt, A, Bm, Cm, CHUNK, None, dy)
    kernel_lib = ts._lib
    try:
        for _ in range(args.rounds):
            for name, lib in libs.items():
                ts._lib = lambda lib=lib: lib
                got = run()
                err = max(float((g - w).abs().max())
                          / max(1.0, float(w.abs().max()))
                          for g, w in zip(got[:5], want[:5]))
                ms = time_ms(run, reps=7, inner=5)
                parts = ", ".join(f"{k} {v:.4f}"
                                  for k, v in pass_ms(run).items())
                print(f"{name:13s} | {ms:.4f} ms (max err / max|want| "
                      f"{err:.3g}) | {parts}", flush=True)
    finally:
        ts._lib = kernel_lib
    plain = time_ms(lambda: ts.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, CHUNK,
                                                  None, dy),
                    reps=7, inner=5)
    print(f"ssd_scan_bwd_plain: {plain:.4f} ms")


if __name__ == "__main__":
    main()
