"""Asynchronous federated training on a virtual clock (the port's
counterpart of ``examples/async_federated.py``).

A 4-client fleet with one extreme straggler (~40x slower) trains VGG-5
two ways:

* synchronous (``fl.loop.run_federated``): every round waits for the
  straggler, so the virtual time of a round is the straggler's;
* asynchronous (``fl.async_loop.run_federated_async``): the server
  aggregates as soon as ``buffer_size=2`` reports arrive, discounting stale
  ones by ``(1+s)^-0.5``, and re-dispatches each reporter with a freshly
  planned OP: the straggler's update lands late but never blocks the fast
  clients.

Both runs make the same number of server steps of real training; only the
virtual clock (Eq. 1 compute + ``Transport`` comm) differs::

    PYTHONPATH=src python -m repro_torch.launch.async_federated   # card
    PYTHONPATH=src python -m repro_torch.launch.async_federated \
        --device cpu

The weights come from the port's generator of ``--seed``, so the
accuracies differ from the reference's example; the virtual times do not.
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.vgg import VGG5
from repro_torch.core import costmodel as cm
from repro_torch.core.env import SimulatedCluster
from repro_torch.data import make_cifar_like, split_clients
from repro_torch.fl.async_loop import run_federated_async
from repro_torch.fl.loop import FLConfig, run_federated

K = 4


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the training (default: the card)")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rounds = args.rounds

    w = cm.vgg_workload(VGG5, batch_size=20)
    devices = [cm.DeviceProfile(f"dev{i}", 2e9, 75e6) for i in range(K - 1)]
    devices.append(cm.DeviceProfile("straggler", 5e7, 75e6))
    sim = SimulatedCluster(w, devices, 8e9, VGG5.ops, iterations=2, seed=0)
    clients = split_clients(make_cifar_like(K * 60, seed=0), K)
    test = make_cifar_like(80, seed=9)
    base = dict(rounds=rounds, local_iters=2, batch_size=20, mode="sfl",
                static_op=2, augment=False, seed=args.seed)

    h_sync = run_federated(VGG5, clients, test, FLConfig(**base), sim=sim,
                           device=device)
    h_async = run_federated_async(
        VGG5, clients, test,
        FLConfig(buffer_size=2, staleness_discount=0.5, **base), sim=sim,
        device=device)

    print(f"{'step':>4} {'sync_t':>8} {'async_t':>8} "
          f"{'sync_acc':>8} {'async_acc':>9} {'staleness':>9}")
    sync_t = np.cumsum(h_sync["round_time"])
    for r in range(rounds):
        print(f"{r:>4} {sync_t[r]:>8.2f} {h_async['virtual_time'][r]:>8.2f} "
              f"{h_sync['accuracy'][r]:>8.3f} {h_async['accuracy'][r]:>9.3f} "
              f"{h_async['staleness'][r]:>9.1f}")
    speedup = sync_t[-1] / h_async["virtual_time"][-1]
    print(f"\nvirtual time for {rounds} server steps: "
          f"sync {sync_t[-1]:.1f}s vs async "
          f"{h_async['virtual_time'][-1]:.1f}s ({speedup:.1f}x): the sync "
          f"barrier pays the straggler every round, the async buffer never "
          f"waits for it")
    return {"sync": h_sync, "async": h_async, "speedup": float(speedup)}


if __name__ == "__main__":
    main()
