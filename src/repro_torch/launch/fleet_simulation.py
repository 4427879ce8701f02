"""Fleet-scale simulation with the batched engine: the port's counterpart
of ``examples/fleet_simulation.py``.

Trains a small LM (lm16m) federated at K = 32 simulated clients, far past
the paper's 5-device testbed, through both fleet engines
(``fl/fleet.py``) from the same seed, and prints each engine's rounds/s
and the largest per-round drift of the metric between them:

* ``sequential``: one step per (client, local iteration);
* ``batched``: clients grouped by planned OP, each group one
  ``torch.func.vmap`` over its clients per local iteration.

    PYTHONPATH=src python -m repro_torch.launch.fleet_simulation              # card
    PYTHONPATH=src python -m repro_torch.launch.fleet_simulation --device cpu

Rounds/s are host clock over whole runs (the first includes the kernels'
first calls).  Both engines differentiate ``silu`` by one kernel
(``layers.silu``): on the CPU their runs agree bit for bit (a drift of
0).  On the card the batched engine's vmapped products may sum fp32 in
another order than one client's, so the drift is an fp32 tolerance there.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.lm_small import LM16M
from repro_torch.data.synthetic import split_clients, token_dataset
from repro_torch.fl.loop import FLConfig, run_federated


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    K, rounds = args.clients, args.rounds
    clients = split_clients(
        token_dataset(K * 8, 16, LM16M.vocab_size, seed=0), K)
    test = token_dataset(16, 16, LM16M.vocab_size, seed=9)
    hists, rates = {}, {}
    for engine in ("sequential", "batched"):
        fl = FLConfig(rounds=rounds, local_iters=2, batch_size=2, lr=0.3,
                      mode="sfl", static_op=3, augment=False, engine=engine)
        t0 = time.perf_counter()
        hists[engine] = run_federated(LM16M, clients, test, fl,
                                      device=device)
        rates[engine] = rounds / (time.perf_counter() - t0)
        print(f"{engine:>10}: {rates[engine]:.3f} rounds/s  -CE loss "
              f"{hists[engine]['accuracy'][0]:+.3f} -> "
              f"{hists[engine]['accuracy'][-1]:+.3f}")
    drift = float(np.abs(hists["batched"]["accuracy"]
                         - hists["sequential"]["accuracy"]).max())
    print(f"max per-round metric drift between engines: {drift:.2e} "
          f"(same seed, float32 tolerance)")
    return {"hists": hists, "rounds_per_s": rates, "drift": drift}


if __name__ == "__main__":
    main()
