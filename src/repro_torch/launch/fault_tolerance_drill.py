"""Fault-tolerance drill: failures, straggler deadlines, crash and resume
(the port's counterpart of ``examples/fault_tolerance_drill.py``).

1. Train federated VGG-5 with a 40% per-round client failure probability
   and a 2x-median straggler deadline: training still converges.
2. 'Crash' after round 3 (checkpoint), restart, and check that the resumed
   run's last rounds are bitwise those of an uninterrupted run::

    PYTHONPATH=src python -m repro_torch.launch.fault_tolerance_drill  # card
    PYTHONPATH=src python -m repro_torch.launch.fault_tolerance_drill \
        --device cpu
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.vgg import VGG5
from repro_torch.core import costmodel as cm
from repro_torch.core.env import SimulatedCluster
from repro_torch.data import make_cifar_like, split_clients
from repro_torch.fl.loop import FLConfig, run_federated


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the training (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    data = make_cifar_like(600, seed=0)
    test = make_cifar_like(200, seed=9)
    clients = split_clients(data, 5)

    # --- failures + straggler deadline -----------------------------------
    w = cm.vgg_workload(VGG5)
    devices = [cm.DeviceProfile(f"d{i}", 2e9, 75e6) for i in range(4)]
    devices.append(cm.DeviceProfile("straggler", 2e8, 75e6))
    sim = SimulatedCluster(w, devices, 8e9, VGG5.ops, iterations=10)

    print("1) 40% client failures + straggler deadline:")
    h = run_federated(VGG5, clients, test, FLConfig(
        rounds=6, local_iters=4, batch_size=40, mode="fl", augment=False,
        fail_prob=0.4, deadline_factor=2.0, seed=0), sim=sim, device=device)
    print(f"   accuracy: {np.round(h['accuracy'], 3)}")
    print(f"   clients dropped per round: {h['dropped'].tolist()}")
    if not h["accuracy"][-1] > h["accuracy"][0]:
        raise RuntimeError("training stalled under failures")

    # --- crash + bitwise resume --------------------------------------------
    print("\n2) crash after round 3, resume from checkpoint:")
    base = dict(local_iters=4, batch_size=40, mode="fl", augment=False,
                seed=0)
    full = run_federated(VGG5, clients, test, FLConfig(rounds=6, **base),
                         device=device)
    with tempfile.TemporaryDirectory() as ck:
        run_federated(VGG5, clients, test, FLConfig(
            rounds=3, checkpoint_dir=ck, checkpoint_every=3, **base),
            device=device)
        resumed = run_federated(VGG5, clients, test, FLConfig(
            rounds=6, checkpoint_dir=ck, checkpoint_every=3, **base),
            resume=True, device=device)
    match = (np.array_equal(resumed["accuracy"], full["accuracy"][-3:])
             and all(torch.equal(a[k], b[k])
                     for a, b in zip(resumed["params"], full["params"])
                     for k in a))
    print(f"   uninterrupted rounds 4-6: {np.round(full['accuracy'][-3:], 4)}")
    print(f"   resumed       rounds 4-6: {np.round(resumed['accuracy'], 4)}")
    print(f"   bitwise resume: {'OK' if match else 'MISMATCH'}")
    if not match:
        raise RuntimeError("the resumed run differs from the uninterrupted")
    return {"failures": h, "full": full, "resumed": resumed,
            "bitwise": match}


if __name__ == "__main__":
    main()
