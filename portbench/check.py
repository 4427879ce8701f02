"""The comparison that decides ``correct``.

The program's checked rounds against the plain reference's:

* ``batch_gap``: how many local steps trained on rows other than the
  reference's (an exact comparison: a token altered where the feed makes
  it shows here);
* ``loss_gap``: each local step's loss (every client, every step, every
  checked round), the widest gap relative to the reference's loss;
* ``round0_loss_gap``: the same over round 0's steps alone, before any
  server step: no top-k or int8-wire flip of a delta has reached the
  weights yet, so round-off has only the int8 cut to cross;
* ``eval_gap``: each round's eval (the negative test loss), likewise;
* ``update_gap``: round 0's update of the global weights, leaf by leaf,
  the gap between the program's norm and the reference's, over the
  larger of that leaf's reference norm and the median leaf's; the worst
  leaf;
* ``median_update_gap``: the median leaf's gap of round 0's update, a
  number steady from seed to seed where the worst leaf is one small
  leaf's round-off;
* ``change_gap``: the worst leaf's gap for the whole change over the
  checked rounds.

Leaves whose reference update is under a thousandth of the median leaf's
move by round-off alone and are left out of the leaf numbers (a rule on
the reference's update, not on names).  A cell compares the numbers its
file under ``portbench/limits/`` gives a limit; a number is correct when
it is finite and at most its limit.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

import numpy as np

NOUGHT = 1e-3
NAMES = ("batch_gap", "loss_gap", "round0_loss_gap", "eval_gap", "update_gap",
         "median_update_gap", "change_gap")


def batch_gap(got: list, want: list) -> float:
    """How many local steps trained on other rows (tokens or labels) than
    the reference's; all of them where the counts differ."""
    if len(got) != len(want):
        return float(max(len(got), len(want)))
    return float(sum(not (np.array_equal(gt, wt) and np.array_equal(gl, wl))
                     for (gt, gl), (wt, wl) in zip(got, want)))


def value_gap(got: List[float], want: List[float]) -> float:
    if len(got) != len(want) or not want:
        return math.inf
    gaps = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    return max(gaps) if all(map(math.isfinite, gaps)) else math.inf


def leaf_gaps(got: Optional[Dict[str, float]], want: Dict[str, float],
              moved: Dict[str, float]) -> Optional[List[float]]:
    """Each counted leaf's gap of norms (None where the leaves differ);
    ``moved`` (the reference's round-0 update norms) decides which leaves
    count."""
    if got is None or set(got) != set(want):
        return None
    scale = statistics.median(want.values())
    floor = NOUGHT * statistics.median(moved.values())
    return [abs(got[k] - want[k]) / max(want[k], scale)
            for k in want if moved[k] >= floor]


def leaf_gap(got, want, moved, reduce=max) -> float:
    """The worst counted leaf's gap (or ``reduce`` of the gaps)."""
    gaps = leaf_gaps(got, want, moved)
    if gaps is None or not all(map(math.isfinite, gaps)):
        return math.inf
    return float(reduce(gaps))


def worst_leaves(got: dict, want: dict) -> Dict[str, str]:
    """Which leaf sets each leaf number, for the log."""
    out = {}
    for name, key in (("update_gap", "update0"), ("change_gap", "change")):
        g, w = got[key], want[key]
        if g is None or set(g) != set(w):
            continue
        scale = statistics.median(w.values())
        k = max(w, key=lambda k: abs(g[k] - w[k]) / max(w[k], scale))
        out[name] = f"{k} ({g[k]!r} against {w[k]!r})"
    return out


def compare(got: dict, want: dict, limits: Dict[str, float],
            steps_per_round: int) -> dict:
    """``{name: {"value", "limit"}}``; a value that is not finite (a
    missing or NaN reading) is given as null."""
    first = slice(0, steps_per_round)
    values = {
        "batch_gap": batch_gap(got["batches"], want["batches"]),
        "loss_gap": value_gap(got["losses"], want["losses"]),
        "round0_loss_gap": value_gap(got["losses"][first],
                                     want["losses"][first]),
        "eval_gap": value_gap(got["evals"], want["evals"]),
        "update_gap": leaf_gap(got["update0"], want["update0"],
                               want["update0"]),
        "median_update_gap": leaf_gap(got["update0"], want["update0"],
                                      want["update0"], statistics.median),
        "change_gap": leaf_gap(got["change"], want["change"],
                               want["update0"]),
    }
    return {name: {"value": v if math.isfinite(v) else None,
                   "limit": limits[name]}
            for name, v in values.items() if name in limits}


def readings(got: dict, want: dict, steps_per_round: int) -> dict:
    """Every number, compared or not: for the log and the limits."""
    return {k: v["value"] for k, v in compare(
        got, want, dict.fromkeys(NAMES, 0.0), steps_per_round).items()}


def correct(compared: dict) -> bool:
    """Every number read and within its limit."""
    return all(c["value"] is not None and c["limit"] is not None
               and c["value"] <= c["limit"] for c in compared.values())


def step_gaps(got: dict, want: dict) -> List[float]:
    """Each local step's relative loss gap, for the log."""
    return [abs(g - w) / abs(w) for g, w in zip(got["losses"],
                                                  want["losses"])]


def lines(compared: dict) -> List[str]:
    return [f"{name}: {c['value']!r} (limit {c['limit']!r})"
            for name, c in compared.items()]
