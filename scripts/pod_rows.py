"""chip_smoke.py's pod pair (phase 5j (a): qwen3-0.6b at full width and
depth, 2 pods of POD_ROWS rows of POD_SEQ tokens) on this tree's package
and on another tree's, in turns, on one card.

    python3 scripts/pod_rows.py --src archive_check/parent/src --tag parent

A development script, outside the port's package: nothing the port runs
calls it.  Each run is a process of its own (``--one SRC``) that builds
that tree's kernels and runs ``chip_smoke.pod_pair_path`` over its package
with ``strict=False``: the per-row param copies of the first local step
are recorded, not failed on (a package without ``launch.steps
.ParamCopyRecorder`` is lent this tree's).  Then the loss's gradient
alone (``torch.func.vmap`` of ``grad_and_value`` over the pods, the
optimizer left out) at the same rows, with its peak above the params it
starts from: where a per-row copy of the unembedding would live.  The
order is the other tree, this one, this one, the other.  Every check of
the phase is chip_smoke.py's own; the record goes to
``chiprun_out/pod_rows.json``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def one(src: str) -> dict:
    """The pod pair and the loss's gradient over ``src``'s package."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs        # puts this tree's src/ on the path
    sys.path.insert(0, str(Path(src).resolve()))
    import torch
    from repro_torch.kernels import LAUNCHES, _build, reset_launches
    from repro_torch.launch import steps as S
    if not hasattr(S, "ParamCopyRecorder"):
        spec = importlib.util.spec_from_file_location(
            "_pod_rows_steps", ROOT / "src/repro_torch/launch/steps.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        S.ParamCopyRecorder = mod.ParamCopyRecorder
    if not torch.cuda.is_available():
        cs.fail("no CUDA device is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all(verbose=False)
    built = time.perf_counter() - t0
    card = card_name()
    dev = torch.device("cuda", 0)
    pods, params = cs.pod_pair_path(torch, dev, LAUNCHES, reset_launches,
                                    card, strict=False)
    from repro_torch.configs.qwen3_0_6b import CONFIG as cfg
    from repro_torch.models import api
    from repro_torch.tree import tree_map
    batch_of = cs.lm_batches(torch, cfg, dev)
    rows = [batch_of(cs.POD_SEQ, r) for r in range(2 * cs.POD_ROWS)]
    batch = {k: torch.cat([r[k] for r in rows]).reshape(
        2, cs.POD_ROWS, cs.POD_SEQ) for k in rows[0]}
    pp = tree_map(lambda x: torch.stack([x, x]), params)
    del params
    grad = torch.func.vmap(torch.func.grad_and_value(
        lambda p, b: api.loss(cfg, p, b)))
    out = {"src": src, "card": card, "build_s": built, "pods": pods,
           "grad": []}
    for _ in range(2):
        cs.free_card(torch)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        g, loss = grad(pp, batch)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        out["grad"].append({"s": s, "peak_above_params_gib": peak,
                            "loss": loss.tolist()})
        del g, loss
        print(f"the loss's gradient over 2 pods of {cs.POD_ROWS} x "
              f"{cs.POD_SEQ} tokens: {s:.3f} s, peak {peak:.2f} GiB above "
              f"the params ({card})", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "archive_check/parent/src"))
    ap.add_argument("--tag", default="parent")
    ap.add_argument("--one", default=None)
    ap.add_argument("--json", default=None)
    a = ap.parse_args()
    if a.one is not None:
        Path(a.json).write_text(json.dumps(one(a.one), default=str))
        return
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    record = {"card": card_name(), "runs": []}
    print(record["card"], flush=True)
    order = [(a.tag, a.src), ("this", str(ROOT / "src")),
             ("this", str(ROOT / "src")), (a.tag, a.src)]
    for i, (tag, src) in enumerate(order):
        path = out_dir / f"pod_rows_{i}.json"
        t0 = time.perf_counter()
        rc = subprocess.run([sys.executable, __file__, "--one", src,
                             "--json", str(path)]).returncode
        if rc:
            sys.exit(f"pod_rows: the run over {tag} ({src}) failed: {rc}")
        run = json.loads(path.read_text())
        run.update(tag=tag, wall_s=time.perf_counter() - t0)
        record["runs"].append(run)
        p = run["pods"]
        print(f"{tag}: local steps {[round(t, 3) for t in p['local_step_s']]}"
              f" s, peak {p['peak_memory_gib']:.2f} GiB (a step "
              f"{[round(x, 2) for x in p['step_peak_gib']]}), per-row "
              f"copies {len(p['per_row_copies'])}, the step alone "
              f"{[round(r['step_s'], 3) for r in p['lone']]} s; the "
              f"gradient alone {[round(g['s'], 3) for g in run['grad']]} s, "
              f"peak {[round(g['peak_above_params_gib'], 2) for g in run['grad']]}"
              f" GiB above the params", flush=True)
    (out_dir / "pod_rows.json").write_text(json.dumps(record, indent=1,
                                                      default=str))
    print(f"pod_rows: done ({record['card']})")


if __name__ == "__main__":
    main()
