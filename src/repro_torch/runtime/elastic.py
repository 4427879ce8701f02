"""Elastic client membership (counterpart of ``repro/runtime/elastic.py``).

The clustering design (paper §IV) exists precisely so the RL agent's I/O
dims do not depend on K — which makes membership changes free: a joining
client runs one native round to measure its baseline B^k, then joins the
grouping; a leaving client is just removed from the baseline vector.  The
trained agent is reused unchanged (the paper reuses agents across *models*;
across K is strictly easier).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.controller import FedAdaptController


def admit_client(controller: FedAdaptController, baseline_time: float) -> int:
    """Register a new client; returns its index."""
    assert controller.baselines is not None, "controller.begin() first"
    controller.baselines = np.append(controller.baselines, baseline_time)
    return len(controller.baselines) - 1


def remove_client(controller: FedAdaptController, idx: int) -> None:
    assert controller.baselines is not None
    controller.baselines = np.delete(controller.baselines, idx)
