"""The port's benchmark, one run of one cell:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, then ``compared``: each number the check
compared beside its limit); the last lines of standard error repeat the
compared numbers.  It needs the cell's cards and exits 2 without them;
it exits 3, with no result, where JAX or the JAX package was loaded in
its process by the end of the run.

``--readings tf32,half_batch,token,unchanged`` measures, at the cell's
size and with no window, what the check reads when the plain reference
in TF32, or with a fault planted, stands in the program's place: the
readings that the limits under ``portbench/limits/`` are set from.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    """Caches at fixed paths inside the checkout, one host thread for the
    CPU's math libraries (idle worker threads would compete with the
    thread that launches the card's work), and the checkout's packages on
    the path."""
    cache = ROOT / "portbench" / ".cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--readings", default="")
    args = p.parse_args(argv)
    _environment()
    import torch
    torch.set_num_threads(1)
    from portbench import harness, registry
    cell = registry.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"card: {harness.card_note()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", file=sys.stderr)
    if args.readings:
        out = harness.readings(cell, args.seed, args.readings.split(","),
                               device)
        print(json.dumps({"workload": args.workload, "seed": args.seed,
                          "readings": out}))
        return 0
    return report(lambda: harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), device, T_START))


def report(run) -> int:
    """Make the run (``run()`` returns the result object), look once more
    for JAX and the JAX package, now that the reference, the check and the
    metrics' readers have run too, and print the result only where neither
    was loaded (else exit 3, naming what was found)."""
    from portbench import check, harness
    try:
        result = run()
        harness.check_imports("by the end of the run")
    except harness.ForbiddenImport as e:
        print(str(e), file=sys.stderr)
        return 3
    sys.stdout.flush()
    print("\n".join(check.lines(result["compared"])), file=sys.stderr,
          flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
