"""Peak card memory of one qwen3-0.6b training step, full width and depth,
4096 tokens a client, on one card.

    python3 scripts/remat_memory.py [--clients 1 2 3] [--seq 4096]

A development script, outside the port's package: nothing the port runs
calls it.  For each client count C it runs the batched engine's step
(``torch.func.vmap(torch.func.grad(loss_through_cut))`` at phase 5g's OP
14 with the int8 cut, C stacked copies of the params) and prints the peak
``max_memory_allocated`` with the step's seconds; then the sequential
engine's step (plain autograd, one client).  A step that runs out of the
card prints the live allocations at that moment, summed by the port's
frame that made them (``torch.cuda.memory._record_memory_history``; not
for the sequential step, whose checkpoint hooks fail under it).  The
record goes to ``chiprun_out/remat_memory.json``.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

OP = 14


def live_by_frame(snapshot, top=25):
    """The live blocks of a memory snapshot, summed by the innermost
    frame in the port (and the innermost frame overall)."""
    sums = collections.Counter()
    for seg in snapshot["segments"]:
        for block in seg["blocks"]:
            if block["state"] != "active_allocated":
                continue
            frames = block.get("frames") or []
            ours = next((f for f in frames
                         if "repro_torch" in f["filename"]), None)
            where = (f"{Path(ours['filename']).name}:{ours['line']} "
                     f"{ours['name']}" if ours else "?")
            inner = (f"{frames[0]['name']}" if frames else "?")
            sums[f"{where} <- {inner}"] += block["size"]
    return [(k, v / 2**30) for k, v in sums.most_common(top)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--seq", type=int, default=4096)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device is visible")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs.qwen3_0_6b import CONFIG as cfg
    from repro_torch.kernels import _build
    from repro_torch.models.split_program import get_split_program
    from repro_torch.tree import tree_leaves, tree_map
    _build.build_all(verbose=False)
    dev = torch.device("cuda", 0)
    program = get_split_program(cfg)
    params = program.init(0, device=dev)
    gen = torch.Generator().manual_seed(0)

    def rows(C):
        toks = torch.randint(0, cfg.vocab_size, (C, 1, args.seq + 1),
                             generator=gen)
        return {"tokens": toks[..., :-1].to(dev),
                "labels": toks[..., 1:].to(dev)}

    def loss(p, b):
        return program.loss_through_cut(p, b, OP, quantize=True)
    record = {"card": card, "seq": args.seq, "runs": {}}

    def measure(name, fn, history=True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2**30
        if history:
            torch.cuda.memory._record_memory_history(max_entries=200000)
        t0 = time.perf_counter()
        try:
            out = fn()
            torch.cuda.synchronize()
            r = {"seconds": time.perf_counter() - t0,
                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "before_gib": base}
            del out
        except torch.OutOfMemoryError:
            live = live_by_frame(torch.cuda.memory._snapshot())
            r = {"oom": True, "before_gib": base, "live_gib": live}
            for where, gib in live:
                print(f"  {gib:8.3f} GiB  {where}", flush=True)
        torch.cuda.memory._record_memory_history(enabled=None)
        torch.cuda.empty_cache()
        record["runs"][name] = r
        print(f"{name}: {r} ({card})", flush=True)

    for C in args.clients:
        pp = tree_map(lambda v: v.expand(C, *v.shape).clone(), params)
        b = rows(C)
        step = torch.func.vmap(torch.func.grad(loss))
        measure(f"batched C={C}", lambda: tree_leaves(step(pp, b)))
        del pp, b
    one = {k: v[0] for k, v in rows(1).items()}

    def sequential():
        p = tree_map(lambda v: v.detach().requires_grad_(), params)
        return torch.autograd.grad(loss(p, one), tree_leaves(p),
                                   allow_unused=True)
    # checkpoint's recompute hook fails (SystemError) while the history
    # records, so the sequential step runs without it
    measure("sequential", sequential, history=False)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "remat_memory.json").write_text(json.dumps(record, indent=1))


if __name__ == "__main__":
    main()
