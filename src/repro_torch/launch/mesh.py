"""The production mesh (counterpart of ``repro/launch/mesh.py``).

A function, not a module-level constant, so that importing this module
touches no CUDA state and sets no environment variable.  A mesh is a grid
of places (``parallel.sharding.Mesh``) and a place may repeat: the dry runs
pass 256 or 512 ``meta`` places, which cost nothing, where the reference
forces 512 host devices through ``XLA_FLAGS`` before JAX starts.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.parallel.sharding import Mesh, default_places


def _grid(shape, axes, devices: Optional[Sequence]) -> Mesh:
    n = int(np.prod(shape))
    devs = [torch.device(d) for d in
            (devices if devices is not None else default_places())]
    if len(devs) < n:
        raise RuntimeError(
            f"need {n} places, have {len(devs)}: pass devices= with {n} "
            f"places (a place may repeat, e.g. [torch.device('meta')] * "
            f"{n} for a dry run, which allocates nothing)")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devs[:n]):
        grid[i] = d
    return Mesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """16 x 16 = 256 places over ``("data", "model")``, or 2 x 16 x 16 =
    512 over ``("pod", "data", "model")``, from the first of ``devices``
    (default: ``default_places()``, the visible cards or one CPU); raises
    when fewer are given."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _grid(shape, axes, devices)


def make_debug_mesh(data: int = 1, model: int = 1, pod: int = 0,
                    devices: Optional[Sequence] = None) -> Mesh:
    """A small mesh: ``(pod, data, model)`` when ``pod``, else ``(data,
    model)``."""
    if pod:
        return _grid((pod, data, model), ("pod", "data", "model"), devices)
    return _grid((data, model), ("data", "model"), devices)
