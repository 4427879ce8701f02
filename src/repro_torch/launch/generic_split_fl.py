"""One federated loop, every model family: the ``SplitProgram`` tour (the
port's counterpart of ``examples/generic_split_fl.py``).

Trains the paper's VGG-5, a dense transformer (lm16m) and an
attention-free SSM (mamba2's smoke config) through the *same*
``run_federated`` loop: per-family split execution is resolved by
``get_split_program(cfg)``, per-round OPs by the bandwidth-greedy
planner, and all communication (int8 smashed data and weight deltas) is
timed through ``fl.comm.Transport``::

    PYTHONPATH=src python -m repro_torch.launch.generic_split_fl   # card
    PYTHONPATH=src python -m repro_torch.launch.generic_split_fl --device cpu

The data, planner, transport, ``FLConfig`` and printed lines are the
reference example's.  The initial weights come from the port's own
generators (VGG from ``torch.Generator().manual_seed(0)``, the LMs from
``program.init(0)``), so the metrics differ from the reference's for the
same seed; ``run_family(name, init_params=params)`` starts a family from
given weights (the reference's, to replay its run).
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.configs.lm_small import LM16M
from repro_torch.configs.vgg import VGG5
from repro_torch.core import costmodel as cm
from repro_torch.core.env import SimulatedCluster
from repro_torch.data.synthetic import (
    make_cifar_like,
    split_clients,
    token_dataset,
)
from repro_torch.fl.comm import Transport, device_bandwidths
from repro_torch.fl.loop import FLConfig, run_federated
from repro_torch.fl.planner import GreedyPlanner
from repro_torch.models.split_program import get_split_program

K = 3
DEVICES = [cm.DeviceProfile("jetson", 8e9, 75e6),
           cm.DeviceProfile("pi4", 2e9, 75e6),
           cm.DeviceProfile("pi3", 8e8, 10e6)]   # slow device, slow link
SERVER = 1e11


def one_family(name, cfg, clients, test, seq, batch, lr, quantize,
               device=None, init_params=None,
               log: Callable[[str], None] = print) -> Dict[str, np.ndarray]:
    """One family's federated run: 4 rounds of 3 local iterations over the
    three devices, the greedy planner and the transport; logs the
    reference's line and returns the history."""
    program = get_split_program(cfg)
    w = cm.program_workload(program, batch, seq)
    sim = SimulatedCluster(w, DEVICES, SERVER, program.op_candidates(),
                           iterations=3)
    planner = GreedyPlanner(w, program.op_candidates(),
                            [d.flops_per_s for d in DEVICES], SERVER)
    transport = Transport(device_bandwidths(DEVICES))
    fl = FLConfig(rounds=4, local_iters=3, batch_size=batch, lr=lr,
                  augment=False, quantize_transfer=quantize)
    h = run_federated(cfg, clients, test, fl, sim=sim, planner=planner,
                      transport=transport, init_params=init_params,
                      device=device)
    log(f"{name:>12}  metric {h['accuracy'][0]:+.3f} -> "
        f"{h['accuracy'][-1]:+.3f}   ops={h['ops'][-1]}   "
        f"round={h['round_time'][-1]:.3f}s "
        f"(comm {np.max(h['comm_time'][-1]):.3f}s, int8={quantize})")
    return h


def _vgg5():
    cifar = make_cifar_like(360, seed=0)
    return (VGG5, split_clients(cifar, K), make_cifar_like(120, seed=9),
            None, 30, 0.01)


def _dense_lm():
    toks = token_dataset(240, 32, LM16M.vocab_size, seed=0)
    return (LM16M, split_clients(toks, K),
            token_dataset(24, 32, LM16M.vocab_size, seed=9), 32, 4, 0.3)


def _mamba2_ssm():
    cfg = get_smoke_config("mamba2-780m")
    toks = token_dataset(240, 32, cfg.vocab_size, seed=0)
    return (cfg, split_clients(toks, K),
            token_dataset(24, 32, cfg.vocab_size, seed=9), 32, 8, 0.5)


# each family's config, data, sequence length, batch and learning rate,
# in the reference example's order
FAMILIES = {"vgg5": _vgg5, "dense-lm": _dense_lm, "mamba2-ssm": _mamba2_ssm}


def run_family(name: str, device=None, init_params=None,
               log: Callable[[str], None] = print) -> Dict[str, np.ndarray]:
    """The tour's run of one family (``FAMILIES``), the int8 cut on."""
    cfg, clients, test, seq, batch, lr = FAMILIES[name]()
    return one_family(name, cfg, clients, test, seq, batch, lr, True,
                      device, init_params, log)


def main(argv=None) -> Dict[str, Dict]:
    """The tour over every family; returns each family's history."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print("family        metric first -> last     greedy plan      round time")
    return {name: run_family(name, device) for name in FAMILIES}


if __name__ == "__main__":
    main()
