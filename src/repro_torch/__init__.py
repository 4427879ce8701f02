"""PyTorch/CUDA port of the FedAdapt system (``src/repro`` is the JAX
reference it is held against).

This package imports ``torch`` and ``numpy`` only: never ``jax`` and never
anything of ``repro``.  Module names mirror the reference's
(``repro_torch/models/vgg.py`` <-> ``repro/models/vgg.py``, ...).  The
kernels of the main path are hand-written CUDA for ``sm_90a``
(``kernels/csrc``), built with ``nvcc`` at first use; a tensor on the CPU
takes each kernel's plain PyTorch version instead.

    from repro_torch.configs.vgg import VGG5
    from repro_torch.fl.loop import FLConfig, run_federated
    hist = run_federated(VGG5, clients, test, FLConfig(...))   # on "cuda"
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """An entry point's device: the card unless the caller asks for the CPU.
    ``None`` means ``"cuda"``, which raises when no GPU is visible."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to "
                           "run the port on the CPU")
    return device


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a reference feature the port does not run yet; ``item``
    names its entry in ROADMAP.md's "Modules to port" queue."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, "
        f"'Modules to port': {item})")
