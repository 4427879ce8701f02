"""chip_smoke.py's mesh phases alone, on one card.

    python3 scripts/mesh_phases.py [--skip-vgg] [--skip-lm]

A development script, outside the port's package: nothing the port runs
calls it.  It builds the kernels as chip_smoke.py does, switches TF32 off,
then runs phase 4f (``vgg5_mesh_path``: VGG-5 over meshes of places that
all are this card, and the async run's resume) and phase 5i's yardstick
and body (phase 5g's qwen3-0.6b run through ``fed_lm_run``, then
``lm_mesh_path``: the same run over ``FED_MESH`` and the MoE layers of
mixtral-8x22b and arctic-480b at full width).  Every check is
chip_smoke.py's own; the record goes to ``chiprun_out/mesh_phases.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-vgg", action="store_true")
    ap.add_argument("--skip-lm", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device is visible")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import LAUNCHES, _build, reset_launches
    t0 = time.perf_counter()
    _build.build_all(verbose=False)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    record = {"card": card}
    if not args.skip_vgg:
        cs.phase("4f. VGG-5 on a mesh")
        record["mesh"] = cs.vgg5_mesh_path(torch, dev, LAUNCHES,
                                           reset_launches, card)
    if not args.skip_lm:
        from repro_torch.configs.qwen3_0_6b import CONFIG as qwen_cfg
        from repro_torch.fl.loop import FLConfig
        cs.phase("5g's qwen3-0.6b run (the yardstick)")
        fl = FLConfig(rounds=2, local_iters=2, batch_size=1, lr=cs.FED_LR,
                      augment=False, mode="sfl", static_op=cs.FED_OP,
                      quantize_transfer=True, delta_density=0.1,
                      quantize_deltas=True, seed=0)
        fed_ref = {}
        fed_ref["record"] = cs.fed_lm_run(
            torch, qwen_cfg, fl, cs.FED_K, dev, LAUNCHES, reset_launches,
            "qwen3-0.6b", wrap=lambda: cs.ServerStepProbe(torch),
            keep=fed_ref)
        record["fed-qwen3-0.6b"] = fed_ref["record"]
        cs.free_card(torch)
        cs.phase("5i. the LM on a mesh")
        record["lm_mesh"] = cs.lm_mesh_path(torch, dev, LAUNCHES,
                                            reset_launches, card, fed_ref)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "mesh_phases.json").write_text(json.dumps(record, indent=1,
                                                     default=str))
    print(f"mesh phases passed ({card})")


if __name__ == "__main__":
    main()
