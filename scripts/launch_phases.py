"""chip_smoke.py's launch-driver phase (5j) alone, on one card.

    python3 scripts/launch_phases.py [--federated]

A development script, outside the port's package: nothing the port runs
calls it.  It builds the kernels as chip_smoke.py does, switches TF32 off,
then runs ``launch_drivers_path``: the FedAdapt pod pair at qwen3-0.6b's
full width and depth against the train step alone, the step builders
against the api, the dry runs on meta and the fleet simulation.  With
``--federated`` phase 5g (``federated_lm_path``: qwen3-0.6b through both
engines, the widths run and mamba2-780m) runs first.  Every check is
chip_smoke.py's own; the record goes to ``chiprun_out/launch_phases.json``.
"""
from __future__ import annotations

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
    if not torch.cuda.is_available():
        cs.fail("no CUDA device is visible")
    t_start = time.perf_counter()
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
    if "--federated" in sys.argv[1:]:
        cs.phase("5g. federated LM training")
        record["5g"] = cs.federated_lm_path(torch, dev, LAUNCHES,
                                            reset_launches, card)
        cs.free_card(torch)
    cs.phase("5j. the launch drivers")
    record["5j"] = cs.launch_drivers_path(torch, dev, LAUNCHES,
                                          reset_launches, card)
    record["wall_s"] = time.perf_counter() - t_start
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "launch_phases.json").write_text(json.dumps(record, indent=1,
                                                       default=str))
    print(f"launch phases passed in {record['wall_s']:.1f} s ({card})")


if __name__ == "__main__":
    main()
