"""End-to-end driver: FedAdapt-train a ~100M-parameter LM (the port's
counterpart of ``examples/train_lm_fedadapt.py``).

Full stack: 4 heterogeneous client slices, the PPO controller picking each
group's offloading point every round, split execution with int8 smashed
data, FedAvg, checkpoints: ``repro_torch.launch.train.main`` with the
example's default flags::

    PYTHONPATH=src python -m repro_torch.launch.train_lm_fedadapt   # 100M
    PYTHONPATH=src python -m repro_torch.launch.train_lm_fedadapt \\
        --arch lm16m                                                # quick

The model trains on the card unless ``main(..., device="cpu")`` is given.
Checkpoints go to ``--ckpt-dir``, by default a fresh temporary directory
(under ``TMPDIR``) of the run's own.  Flags given on the command line
override the defaults.
"""
from __future__ import annotations

import sys
import tempfile

from repro_torch.launch.train import main as train_main

DEFAULTS = ["--arch", "lm100m", "--rounds", "40", "--local-steps", "5",
            "--batch", "2", "--seq", "64", "--quantize-transfer",
            "--ckpt-every", "10"]


def arguments(argv) -> list:
    """The driver's arguments: the defaults, then ``argv`` (a later flag
    wins in argparse; ``--arch`` given replaces the default arch), then a
    temporary ``--ckpt-dir`` unless one is given."""
    args = list(argv)
    defaults = list(DEFAULTS)
    if any(a.startswith("--arch") for a in args):
        defaults = defaults[2:]
    if not any(a.startswith("--ckpt-dir") for a in args):
        defaults += ["--ckpt-dir", tempfile.mkdtemp(prefix="fedadapt_lm_")]
    return defaults + args


def main(argv=None, device=None):
    """``launch.train.main`` over ``arguments(argv)``; returns the final
    params."""
    argv = sys.argv[1:] if argv is None else argv
    return train_main(arguments(argv), device=device)


if __name__ == "__main__":
    main()
