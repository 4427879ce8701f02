"""Quickstart: FedAdapt end to end on the paper's testbed (the port's
counterpart of ``examples/quickstart.py``).

Reconstructs the paper's 5-device testbed (speeds calibrated to Table
VIII), trains the PPO agent offline on truncated rounds (§IV), deploys it,
and prints the per-device round times against classic FL, the paper's
Fig. 6::

    PYTHONPATH=src python -m repro_torch.launch.quickstart            # card
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu

The agent's weights and exploration noise come from ``--seed`` through the
port's own generator (on the CPU, so the card and the CPU train alike), so
the numbers differ from the reference's example for the same seed.  The
wall seconds of training are host clock.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.vgg import VGG5
from repro_torch.core.agent import PPOAgent, PPOConfig
from repro_torch.core.controller import (
    FedAdaptController,
    run_fl_with_controller,
    train_rl_agent,
)
from repro_torch.core.env import SimulatedCluster
from repro_torch.core.testbed import paper_testbed


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the agent (default: the card)")
    ap.add_argument("--train-rounds", type=int, default=400)
    ap.add_argument("--deploy-rounds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- 1. the testbed: one fast device, three mid Pis, one straggler ----
    w, devices, server, overhead = paper_testbed(VGG5)

    # --- 2. train the RL agent offline on truncated rounds ----------------
    sim = SimulatedCluster(w, devices, server, VGG5.ops, iterations=5,
                           jitter=0.03, seed=1, overhead_s=overhead)
    agent = PPOAgent(PPOConfig(num_groups=3, factored=True), seed=args.seed,
                     device=device)
    ctl = FedAdaptController(w, VGG5.ops, num_groups=3,
                             low_bw_threshold=None, agent=agent,
                             seed=args.seed)
    print(f"training the RL agent ({args.train_rounds} truncated rounds) "
          f"on {device}...")
    t0 = time.perf_counter()
    hist = train_rl_agent(sim, ctl, rounds=args.train_rounds)
    train_s = time.perf_counter() - t0
    print(f"  {train_s:.2f} s; final actions per group: "
          f"{np.round(hist['actions'][-1], 2)} (G1 native, G2/G3 -> OP1)")

    # --- 3. deploy: FedAdapt vs classic FL ---------------------------------
    deploy = SimulatedCluster(w, devices, server, VGG5.ops, iterations=100,
                              jitter=0.0, seed=2, overhead_s=overhead)
    ctl2 = FedAdaptController(w, VGG5.ops, num_groups=3,
                              low_bw_threshold=None, agent=agent)
    out = run_fl_with_controller(deploy, ctl2, rounds=args.deploy_rounds)
    fed = out["times"][-1]
    fl = deploy.round_times(deploy.native_ops(), 0)
    print(f"\n{'device':<14}{'classic FL':>12}{'FedAdapt':>12}{'saving':>9}")
    for d, a, b in zip(devices, fl, fed):
        print(f"{d.name:<14}{a:>11.1f}s{b:>11.1f}s{1 - b / a:>8.0%}")
    reduction = 1 - fed.max() / fl.max()
    print(f"{'ROUND (max)':<14}{fl.max():>11.1f}s{fed.max():>11.1f}s"
          f"{reduction:>8.0%}   <- paper: -40%")
    return {"train": hist, "deploy": out, "classic_fl_times": fl,
            "reduction": float(reduction), "train_s": train_s,
            "agent": agent}


if __name__ == "__main__":
    main()
