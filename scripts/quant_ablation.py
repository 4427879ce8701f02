"""The int8 quantize and dequantize kernels against the parent tree's, on
the card.

    mkdir -p archive_check/parent
    git archive <parent commit> | tar -x -C archive_check/parent
    python3 scripts/quant_ablation.py [--parent archive_check/parent]

A development script, outside the port's package: nothing the port runs
calls it.  It builds ``src/repro_torch/kernels/csrc/quant_transfer.cu`` of
the parent (from the unpacked tree; ``archive_check/`` is git-ignored) and
of this tree with the kernels' own ``nvcc`` flags (``scripts/variants.py``),
calls each library directly on the same inputs and outputs at the main
path's shapes (the VGG-5 cut at B=100, OP1 (25600, 32) and OP2 (6400, 64);
the delta wire, (580, 1024)) and at (1, 4), the fixed cost of a launch,
requires the codes, scales and values of both
to equal the plain version's bit for bit, and times them in turns (parent,
this tree, this tree, parent) with ``chip_smoke.time_ms``: CUDA events over
CUDA-graph replays, the inputs resident in L2 as on the main path.  This
tree's kernels also run under the scalar plan (what ``_quant_plan`` /
``_dequant_plan`` give a misaligned input), to show what the 16- and
4-byte accesses buy; ``--sweep`` first times them under every plan
that holds a row in one pass (the data the plans' rules were chosen on).
The bound is the bytes each call must move over 3.35 TB/s.  The record
goes to ``chiprun_out/quant_ablation.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import HBM_BYTES_PER_S, time_ms  # noqa: E402  (src/ on path)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import quant_transfer as tq  # noqa: E402
from variants import build_sources  # noqa: E402

SHAPES = [(25600, 32), (6400, 64), (580, 1024)]
# one row of 4: a launch that does almost nothing, the fixed cost of a
# kernel in a graph that the main path's shapes pay besides their bytes
FLOOR = (1, 4)
SOURCE = Path("src/repro_torch/kernels/csrc/quant_transfer.cu")
# the parent's entry points took no plan
PARENT_SIGNATURES = {
    "repro_quantize_rows": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p),
    "repro_dequantize_rows": (ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_int, ctypes.c_void_p),
}


def calls(lib, R, C, x, q, s, out, quant_plan, dequant_plan):
    """The two kernels of one library as closures over fixed buffers;
    ``*_plan`` None for the parent's entry points."""
    def stream():
        return torch.cuda.current_stream().cuda_stream

    def plan_args(plan):
        return () if plan is None else plan.args()

    def quantize():
        _build.check_launch(lib.repro_quantize_rows(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), R, C,
            *plan_args(quant_plan), stream()), "quantize")

    def dequantize():
        _build.check_launch(lib.repro_dequantize_rows(
            q.data_ptr(), s.data_ptr(), out.data_ptr(), R, C,
            *plan_args(dequant_plan), stream()), "dequantize")
    return quantize, dequantize


def candidate_plans(C, widths):
    """Every plan the kernels take that holds the row in one pass and is
    less than twice as wide as the row."""
    for width in widths:
        if C % width:
            continue
        n = C // width
        for group in (1 << i for i in range(9)):
            for vecs in (1, 2, 4, 8):
                span = group * vecs
                if span >= n and (span < 2 * n or span == 1):
                    yield tq.Plan(group, width, vecs, tq.cta_threads(group))


def sweep(libs, dev) -> list:
    """This tree's kernels under every candidate plan at each shape, each
    checked bit for bit against the plain version; fastest first."""
    gen = torch.Generator().manual_seed(2)
    rows = []
    for R, C in SHAPES:
        x = torch.randn((R, C), generator=gen).to(dev)
        qp, sp = tq.quantize_rows_plain(x)
        dp = tq.dequantize_rows_plain(qp, sp)
        q, s, out = (torch.empty_like(t) for t in (qp, sp, dp))
        found = []
        for kernel in ("quantize", "dequantize"):
            for plan in candidate_plans(C, (4, 1)):
                quantize, dequantize = calls(libs["new"], R, C, x, q, s, out,
                                             plan, plan)
                if kernel == "dequantize":
                    q.copy_(qp)
                    s.copy_(sp)
                fn = quantize if kernel == "quantize" else dequantize
                fn()
                torch.cuda.synchronize()
                ok = (torch.equal(q, qp) and torch.equal(s, sp)
                      if kernel == "quantize" else torch.equal(out, dp))
                if not ok:
                    sys.exit(f"quant_ablation: {kernel} under {plan} at "
                             f"({R}, {C}) differs from the plain version")
                found.append({"shape": [R, C], "kernel": kernel,
                              "plan": list(plan), "ms": time_ms(fn)})
        for kernel in ("quantize", "dequantize"):
            mine = sorted((r for r in found if r["kernel"] == kernel),
                          key=lambda r: r["ms"])
            chosen = list((tq._quant_plan if kernel == "quantize"
                           else tq._dequant_plan)(C, 0))
            for r in mine:
                mark = "  <- the wrapper's plan" if r["plan"] == chosen else ""
                print(f"sweep ({R}, {C}) {kernel:10s} plan (group, width, "
                      f"vecs, threads) {tuple(r['plan'])}: {r['ms']:.5f} ms"
                      f"{mark}", flush=True)
            rows += mine
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default="archive_check/parent",
                    help="the parent tree, unpacked from git archive")
    ap.add_argument("--rounds", type=int, default=2,
                    help="turns of (parent, this tree) and back")
    ap.add_argument("--sweep", action="store_true",
                    help="first time this tree's kernels under every "
                         "candidate plan")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("quant_ablation: no CUDA device")
    parent_cu = ROOT / args.parent / SOURCE
    if not parent_cu.exists():
        sys.exit(f"quant_ablation: no {parent_cu}; unpack the parent tree "
                 f"there with git archive")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    libs = build_sources({"parent": (parent_cu, PARENT_SIGNATURES),
                          "new": (ROOT / SOURCE, tq._SIGNATURES)})
    gen = torch.Generator().manual_seed(1)
    dev = torch.device("cuda", 0)
    record = {"card": card, "rows": []}
    if args.sweep:
        record["sweep"] = sweep(libs, dev)
    for R, C in SHAPES + [FLOOR]:
        x = torch.randn((R, C), generator=gen).to(dev)
        qp, sp = tq.quantize_rows_plain(x)
        dp = tq.dequantize_rows_plain(qp, sp)
        n = R * C
        nbytes = n * 4 + n + R * 4          # the same for both directions
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        qplan, dplan = tq._quant_plan(C, 0), tq._dequant_plan(C, 0)
        runs = {"parent": (libs["parent"], None, None),
                "new": (libs["new"], qplan, dplan),
                "new, scalar": (libs["new"], tq._row_plan(C, 1),
                                tq._row_plan(C, 1))}
        fns = {}
        for name, (lib, qpl, dpl) in runs.items():
            q = torch.empty_like(qp)
            s = torch.empty_like(sp)
            out = torch.empty_like(dp)
            quantize, dequantize = calls(lib, R, C, x, q, s, out, qpl, dpl)
            quantize()
            dequantize()
            torch.cuda.synchronize()
            for what, got, want in [("codes", q, qp), ("scales", s, sp),
                                    ("values", out, dp)]:
                if not torch.equal(got.view(torch.int8),
                                   want.view(torch.int8)):
                    sys.exit(f"quant_ablation: {name} {what} at ({R}, {C}) "
                             f"differ from the plain version")
            fns[name] = (quantize, dequantize)
        order = ["parent", "new", "new", "parent"] * args.rounds
        for name in order + ["new, scalar"]:
            for kernel, fn in zip(("quantize", "dequantize"), fns[name]):
                row = {"shape": [R, C], "tree": name, "kernel": kernel,
                       "ms": time_ms(fn), "call_ms": time_ms(fn, graph=False),
                       "bound_ms": bound}
                record["rows"].append(row)
                print(f"({R}, {C}) {kernel:10s} {name:20s} "
                      f"{row['ms']:.5f} ms (eager {row['call_ms']:.5f}), "
                      f"bound {bound:.5f} ({bound / row['ms']:.0%})",
                      flush=True)
        print(f"({R}, {C}) plans: quantize {tuple(qplan)}, dequantize "
              f"{tuple(dplan)}", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "quant_ablation.json").write_text(json.dumps(record, indent=1))


if __name__ == "__main__":
    main()
