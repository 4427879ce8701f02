"""The checkpoint trees of the sync and async loops (counterpart of
``repro/fl/state.py``), leaf for leaf the reference's keys and dtypes, so
either package restores the other's files.

The error feedback (EF) comes in three representations:

* ``None``: the run keeps no EF (``delta_density == 1``);
* a dense ``(K, padded)`` fp32 tensor, stored under ``delta_errors``;
* an ``fl.cohort.EFStore``, stored sparse as ``ef/ids (T,)`` and
  ``ef/rows (T, padded)`` for its ``T`` touched rows.  ``T`` varies, so a
  restore template is sized from the file on disk
  (``CheckpointManager.latest_shapes`` and ``ef_template_len``).

The cohort draws need no snapshot: they are pure functions of the seed
and the round or version, as the failure masks are.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.fl.cohort import EFStore

__all__ = ["base_state_tree", "async_state_tree", "ef_template_len"]


def ef_template_len(shapes: Optional[dict]) -> int:
    """Touched-row count of the ``ef/ids`` leaf in a checkpoint's shape
    map; 0 when absent."""
    if shapes and "ef/ids" in shapes:
        return int(shapes["ef/ids"][0])
    return 0


def base_state_tree(params, errors, ctl, K: int, *, template: bool = False,
                    ef_len: int = 0):
    """The sync checkpoint tree: the params and the run's other state (EF in
    any representation, the controller's normalizer).  A template keeps the
    tensors (restore places them like these) and zero-fills the rest."""
    tree = {"params": params}
    if isinstance(errors, EFStore):
        if template:
            tree["ef"] = {
                "ids": np.zeros(int(ef_len), np.int64),
                "rows": np.zeros((int(ef_len), errors.padded), np.float32),
            }
        else:
            ids, rows = errors.snapshot()
            tree["ef"] = {"ids": ids, "rows": rows}
    elif errors is not None:
        tree["delta_errors"] = errors
    if ctl is not None:
        tree["controller"] = {
            "baselines": (np.zeros(K, np.float64) if template
                          else np.asarray(ctl.baselines, np.float64)),
            "prev_actions": (np.zeros(ctl.G, np.float32) if template
                             else np.asarray(ctl.prev_actions, np.float32)),
        }
    return tree


def async_state_tree(params, errors, ctl, K: int, C: int, layout, *,
                     template: bool = False, ef_len: int = 0,
                     clock: Optional[Sequence[float]] = None,
                     times: Optional[np.ndarray] = None,
                     comm: Optional[np.ndarray] = None,
                     ops: Optional[Sequence[int]] = None,
                     loader_state: Optional[Sequence[Tuple[int, int]]] = None,
                     events: Optional[Sequence[Tuple[float, Any,
                                                     torch.Tensor]]] = None):
    """The async checkpoint tree: the sync tree plus the scheduler table.

    At an aggregation boundary exactly ``C`` (the in-flight set; ``K``
    without a cohort) report events are in flight, so the scheduler's
    state is ``C`` timestamped rows (``inf`` for dead links) with their
    deltas as flat layout rows.  ``events`` are ``(t, report, flat_row)``
    in pop order (``EventQueue.snapshot``)."""
    tree = base_state_tree(params, errors, ctl, K, template=template,
                           ef_len=ef_len)
    if template:
        tree["async"] = {
            "clock": np.zeros(2, np.float64),   # [now, last_agg_clock]
            "times": np.zeros(K, np.float64),
            "comm": np.zeros(K, np.float64),
            "ops": np.zeros(K, np.int32),
            "loader_state": np.zeros((K, 2), np.int64),
            "ev_t": np.zeros(C, np.float64),
            "ev_client": np.zeros(C, np.int32),
            "ev_version": np.zeros(C, np.int32),
            "ev_op": np.zeros(C, np.int32),
            "ev_dur": np.zeros(C, np.float64),
            "ev_comm": np.zeros(C, np.float64),
            "ev_delta": np.zeros((C, layout.padded), np.float32),
        }
        return tree
    if len(events) != C:
        raise AssertionError(
            f"checkpoint off an aggregation boundary: {len(events)} "
            f"in-flight events, expected {C}")
    tree["async"] = {
        "clock": np.asarray(clock, np.float64),
        "times": np.asarray(times, np.float64),
        "comm": np.asarray(comm, np.float64),
        "ops": np.asarray(ops, np.int32),
        "loader_state": np.asarray(loader_state, np.int64),
        "ev_t": np.asarray([t for t, _, _ in events], np.float64),
        "ev_client": np.asarray([r.client for _, r, _ in events], np.int32),
        "ev_version": np.asarray([r.version for _, r, _ in events],
                                 np.int32),
        "ev_op": np.asarray([r.op for _, r, _ in events], np.int32),
        "ev_dur": np.asarray([r.time for _, r, _ in events], np.float64),
        "ev_comm": np.asarray([r.comm for _, r, _ in events], np.float64),
        "ev_delta": torch.stack([row for _, _, row in events]),
    }
    return tree
