"""The paper's §V-D scenario, changing network bandwidth (Fig. 8): the
port's counterpart of ``examples/bandwidth_adaptation.py``.

The agent is trained with a low-bandwidth group present (§V-C), then
deployed for 100 FL rounds; after round 50 each device in turn is
throttled to 10 Mbps for 10 rounds (Jetson first, Pi3-b last).  The
trained FedAdapt agent re-plans every round from the previous round's
observations: the OP of the throttled device flips to native (or stays
put for the Jetson, whose optimum is native anyway, the paper's
observation).  Prints the OP table and the total time against classic
FL::

    PYTHONPATH=src python -m repro_torch.launch.bandwidth_adaptation         # card
    PYTHONPATH=src python -m repro_torch.launch.bandwidth_adaptation --device cpu

The agent's weights and exploration noise come from ``--seed`` through the
port's own generator, so the numbers differ from the reference's example
for the same seed; ``main(agent_params=, agent_noise=)`` takes the
reference's instead.
"""
from __future__ import annotations

import argparse
from typing import Dict

from repro_torch import resolve_device
from repro_torch.configs.vgg import VGG5
from repro_torch.core import costmodel as cm
from repro_torch.core.agent import PPOAgent, PPOConfig
from repro_torch.core.controller import (
    FedAdaptController,
    run_fl_with_controller,
    train_rl_agent,
)
from repro_torch.core.env import SimulatedCluster
from repro_torch.core.testbed import paper_testbed
from repro_torch.fl.comm import paper_schedule

TABLE_ROUNDS = (10, 49, 52, 62, 72, 82, 92)


def main(argv=None, agent_params=None, agent_noise=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the agent (default: the card)")
    ap.add_argument("--train-rounds", type=int, default=400)
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    w, devices, server, overhead = paper_testbed(VGG5)

    # train with a low-bandwidth group present (paper §V-C)
    train_devices = [cm.DeviceProfile(d.name, d.flops_per_s,
                                      10e6 if d.name == "pi3_2" else 75e6)
                     for d in devices]
    sim_train = SimulatedCluster(w, train_devices, server, VGG5.ops,
                                 iterations=5, jitter=0.03, seed=1,
                                 overhead_s=overhead)
    agent = PPOAgent(PPOConfig(num_groups=3, factored=True), seed=args.seed,
                     params=agent_params, noise=agent_noise, device=device)
    ctl = FedAdaptController(w, VGG5.ops, num_groups=3, low_bw_threshold=25e6,
                             agent=agent, seed=args.seed)
    print(f"training agent with a low-bandwidth group (§V-C), "
          f"{args.train_rounds} rounds on {device}...")
    train = train_rl_agent(sim_train, ctl, rounds=args.train_rounds)

    # deploy against the §V-D schedule
    sched = paper_schedule(base_bps=75e6, low_bps=10e6, start_round=50,
                           slot_len=10)
    deploy = SimulatedCluster(w, devices, server, VGG5.ops, iterations=100,
                              jitter=0.0, seed=2, overhead_s=overhead,
                              bandwidth_fn=lambda r, d: sched(r, d))
    ctl2 = FedAdaptController(w, VGG5.ops, num_groups=3,
                              low_bw_threshold=25e6, agent=agent)
    hist = run_fl_with_controller(deploy, ctl2, rounds=args.rounds)

    fl_total = 0.0
    for r in range(1, args.rounds + 1):
        bw = deploy.bandwidths(r)
        fl_total += max(cm.iteration_time(w, w.num_layers, d.flops_per_s,
                                          server, bw[i], overhead) * 100
                        for i, d in enumerate(devices))
    fed_total = float(hist["round_time"].sum())
    print("\nround  throttled   ops (per device)             round time")
    for r in (r for r in TABLE_ROUNDS if r <= args.rounds):
        slot = (r - 50) // 10 if r >= 50 else -1
        thr = devices[slot].name if 0 <= slot < 5 else "-"
        print(f"{r:>5}  {thr:<10} {str(hist['ops'][r - 1]):<28} "
              f"{hist['round_time'][r - 1]:>8.1f}s")
    print(f"\ntotal {args.rounds}-round time: FedAdapt {fed_total:.0f}s vs "
          f"classic FL {fl_total:.0f}s  (-{1 - fed_total / fl_total:.0%}; "
          f"paper: ~-30%)")
    return {"train": train, "deploy": hist, "fedadapt_total_s": fed_total,
            "classic_fl_total_s": fl_total, "agent": agent}


if __name__ == "__main__":
    main()
