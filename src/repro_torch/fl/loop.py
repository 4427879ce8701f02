"""The synchronous federated round loop: classic FL, SplitFed (static OP)
and FedAdapt (counterpart of ``repro/fl/loop.py``).

Each round the planner picks every device's offloading point, the fleet
engine (``engine``: sequential, or batched by OP group) trains the clients
through that cut (the smashed data optionally crossing as int8), and the
server step aggregates the survivors' deltas (optionally top-k sparsified
with error feedback and sent as int8): the fused flat-buffer
``ServerStep`` by default, or with ``server_step="reference"`` the
per-leaf, per-client pipeline it is held against (the batched engine's
plain average then stays one stacked ``tensordot`` per leaf).  Round times
come from the Eq. 1 cost model (``SimulatedCluster``) and, when a
``Transport`` is given, its communication accounting.

The reference's knobs that the port does not run yet (HeteroFL widths,
cohorts, the two-tier server, a device mesh, checkpoints) raise
``NotImplementedError`` naming their ROADMAP item rather than being
ignored.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import not_ported, resolve_device
from repro_torch.core.controller import FedAdaptController
from repro_torch.core.env import SimulatedCluster
from repro_torch.data.loader import FleetLoader
from repro_torch.fl.comm import Transport
from repro_torch.fl.fedavg import fedavg_delta_stacked, model_bytes
from repro_torch.fl.flatbuf import (
    FlatLayout,
    ServerStep,
    reference_server_step,
)
from repro_torch.fl.fleet import (
    StackedRows,
    get_engine,
    rows_as_list,
    take_rows,
)
from repro_torch.fl.planner import FedAdaptPlanner, Planner, StaticPlanner
from repro_torch.models.split_program import get_split_program
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.straggler import (
    deadline_mask,
    deadline_value,
    reweight,
)
from repro_torch.tree import tree_map


@dataclasses.dataclass
class FLConfig:
    rounds: int = 100
    local_iters: int = 10
    batch_size: int = 100
    lr: float = 0.01
    lr_drop_round: int = 50          # paper: 0.001 from round 50
    lr_drop_factor: float = 0.1
    mode: str = "fl"                 # fl | sfl | fedadapt
    static_op: Optional[int] = None  # sfl: uniform OP for all devices
    deadline_factor: float = 0.0     # >0 enables straggler drop
    fail_prob: float = 0.0
    augment: bool = True             # horizontal flip p=0.5 (paper §V-B)
    quantize_transfer: bool = False  # int8 smashed data across the cut
    delta_density: float = 1.0       # <1: top-k sparsified weight deltas
    quantize_deltas: bool = False    # int8 wire format for the delta sync
    seed: int = 0
    engine: str = "sequential"       # sequential | batched
    server_step: str = "fused"       # fused | reference
    # the reference's knobs the port does not run yet: any other value
    # than these defaults raises
    client_widths: Optional[Sequence[float]] = None
    cohort_size: int = 0
    num_edges: int = 0
    mesh_shape: Optional[Sequence[int]] = None
    checkpoint_dir: Optional[str] = None


_UNPORTED = (
    # (field, default, what, ROADMAP item)
    ("client_widths", None, "client_widths (HeteroFL)",
     "heterogeneity, cohorts and hierarchy"),
    ("cohort_size", 0, "cohort_size", "heterogeneity, cohorts and hierarchy"),
    ("num_edges", 0, "num_edges (two-tier server)",
     "heterogeneity, cohorts and hierarchy"),
    ("mesh_shape", None, "mesh_shape", "multi-device"),
    ("checkpoint_dir", None, "checkpoint_dir", "checkpoints"),
)


def _check_ported(fl: FLConfig) -> None:
    for field, default, what, item in _UNPORTED:
        if getattr(fl, field) != default:
            raise not_ported(what, item)
    if fl.mode not in ("fl", "sfl", "fedadapt"):
        raise ValueError(f"unknown mode {fl.mode!r}")
    if fl.server_step not in ("fused", "reference"):
        raise ValueError(f"unknown server_step {fl.server_step!r}; "
                         f"known: fused, reference")


def _resolve_planner(fl: FLConfig, native_op: int,
                     planner: Optional[Planner],
                     controller: Optional[FedAdaptController],
                     sim: Optional[SimulatedCluster]) -> Planner:
    if planner is not None:
        return planner
    if fl.mode == "fedadapt" and controller is not None and sim is not None:
        return FedAdaptPlanner(controller, explore=False)
    if fl.mode == "sfl":
        return StaticPlanner(fl.static_op if fl.static_op is not None
                             else native_op)
    return StaticPlanner(native_op)


def _delta_trees(params, client_params: List) -> List:
    """Per-client fp32 weight deltas against the current global (the
    reference server step's per-leaf input)."""
    return [tree_map(lambda c, g: c.to(torch.float32) - g.to(torch.float32),
                     cp, params) for cp in client_params]


class RoundClock:
    """Per-device round times: compute from the Eq. 1 cost model
    (``SimulatedCluster``); with a ``Transport``, communication is charged
    through it instead of Eq. 1's network term: per-iteration cut round
    trips (activations up, optionally int8, gradients back) plus one weight
    sync (``model_bytes * delta_density`` up, a quarter of that as int8,
    the full model down)."""

    def __init__(self, program, fl: FLConfig, K: int, params,
                 sim: Optional[SimulatedCluster] = None,
                 transport: Optional[Transport] = None):
        self.program = program
        self.fl = fl
        self.K = K
        self.sim = sim
        self.transport = transport
        self.native_op = program.native_op
        self.model_bytes = float(model_bytes(params))

    def comm_times(self, ops: List[int], round_idx: int) -> np.ndarray:
        fl, sim = self.fl, self.sim
        iters = sim.iterations if sim is not None else fl.local_iters
        out = []
        for k, op in enumerate(ops):
            t = 0.0
            if op < self.native_op:
                up = self.program.cut_bytes(op, fl.batch_size,
                                            quantize=fl.quantize_transfer)
                down = self.program.cut_bytes(op, fl.batch_size)
                t += iters * self.transport.round_comm_time(
                    up, down, round_idx, k)
            up = self.model_bytes * fl.delta_density
            if fl.quantize_deltas:
                up *= 0.25
            t += self.transport.round_comm_time(up, self.model_bytes,
                                                round_idx, k)
            out.append(t)
        return np.asarray(out)

    def times(self, ops: List[int], round_idx: int):
        """(total per-device round times, comm component)."""
        if self.transport is not None:
            comm = self.comm_times(ops, round_idx)
            comp = (self.sim.round_compute_times(ops, round_idx)
                    if self.sim is not None else np.zeros(self.K))
            return comp + comm, comm
        if self.sim is not None:
            return self.sim.round_times(ops, round_idx), np.zeros(self.K)
        return np.ones(self.K), np.zeros(self.K)


def run_federated(
    cfg,
    clients_data: List[Dict[str, np.ndarray]],
    test_data: Dict[str, np.ndarray],
    fl: FLConfig,
    sim: Optional[SimulatedCluster] = None,
    controller: Optional[FedAdaptController] = None,
    planner: Optional[Planner] = None,
    transport: Optional[Transport] = None,
    init_params=None,
    device=None,
) -> Dict[str, np.ndarray]:
    """Train ``cfg`` (a ``VGGConfig``) federated with per-round offloading.

    ``device=None`` runs on the card and raises if none is visible; pass
    ``device="cpu"`` for the CPU.  ``init_params`` (the reference's per-layer
    list of dicts, numpy or tensors) starts the run from given weights;
    by default they are drawn from ``torch.Generator().manual_seed(seed)``.
    Returns the history: per-round accuracy, modelled round and comm times,
    per-device OPs and drop counts, the measured wall time of each round
    (``wall_s``), plus the final ``params``.
    """
    device = resolve_device(device)
    _check_ported(fl)
    program = get_split_program(cfg)
    K = len(clients_data)
    if init_params is None:
        params = program.init(torch.Generator().manual_seed(fl.seed), device)
    else:
        params = [{k: (v.detach().to(device, torch.float32).clone()
                       if isinstance(v, torch.Tensor) else
                       torch.tensor(np.asarray(v, np.float32), device=device))
                   for k, v in layer.items()} for layer in init_params]
    fused = fl.server_step == "fused"
    layout = FlatLayout(params)
    loaders = FleetLoader.for_clients(clients_data, fl.batch_size,
                                      seed=fl.seed)
    engine = get_engine(fl.engine, program, fl.local_iters, fl.seed,
                        fl.augment, fl.quantize_transfer, device)
    injector = FailureInjector(fl.fail_prob, seed=fl.seed)
    native_op = program.native_op
    sizes = np.asarray([len(d["labels"]) for d in clients_data], np.float64)
    track_errors = fl.delta_density < 1.0
    delta_errors = (torch.zeros((K, layout.padded), dtype=torch.float32,
                                device=device) if track_errors else None)
    clock = RoundClock(program, fl, K, params, sim=sim, transport=transport)
    step = (ServerStep(layout, fl.delta_density, fl.quantize_deltas)
            if fused else None)
    g_flat = layout.flatten(params) if fused else None

    # round-0 baselines (classic FL, no offloading)
    times, _ = clock.times([native_op] * K, 0)
    if controller is not None and controller.baselines is None:
        controller.begin(times)
    plan = _resolve_planner(fl, native_op, planner, controller, sim)
    plan.begin(times)

    hist: Dict[str, list] = {"accuracy": [], "round_time": [], "ops": [],
                             "times": [], "comm_time": [], "dropped": [],
                             "wall_s": []}
    test_batch = {k: torch.from_numpy(v).to(device)
                  for k, v in test_data.items()}

    for r in range(fl.rounds):
        t0 = time.perf_counter()
        lr = fl.lr * (fl.lr_drop_factor if r >= fl.lr_drop_round else 1.0)
        bandwidths = sim.bandwidths(r) if sim is not None else None
        ops = plan.plan(r, times, bandwidths)
        alive = injector.round_mask(K, round_idx=r)
        idxs, rows = engine.run_round(params, loaders, ops,
                                      [int(k) for k in np.flatnonzero(alive)],
                                      r, lr)
        times, comm = clock.times(ops, r)
        keep = np.ones(K, bool)
        if fl.deadline_factor > 0:
            keep = deadline_mask(times, fl.deadline_factor)
        keep &= alive
        weights = reweight(sizes, keep)
        kept_pos = [i for i, k in enumerate(idxs) if keep[k]]
        surv_idx = [idxs[i] for i in kept_pos]
        surv_w = [weights[k] for k in surv_idx]
        if kept_pos and not fused and not track_errors and \
                not fl.quantize_deltas and isinstance(rows, StackedRows):
            # reference path, plain averaging, batched engine: one stacked
            # tensordot per leaf rather than a per-client loop
            params = fedavg_delta_stacked(
                params, take_rows(rows, kept_pos).tree, surv_w)
        elif kept_pos:
            ids = torch.as_tensor(surv_idx, dtype=torch.int64, device=device)
            err_rows = delta_errors[ids] if track_errors else None
            if fused:
                deltas = layout.rows_to_deltas(take_rows(rows, kept_pos),
                                               g_flat)
                g_flat, new_err = step(g_flat, deltas, surv_w, err_rows)
                params = layout.unflatten(g_flat)
            else:
                # the per-leaf, per-client reference server step
                params, new_err = reference_server_step(
                    layout, params, _delta_trees(
                        params, rows_as_list(rows, kept_pos)),
                    surv_w, err_rows, density=fl.delta_density,
                    quantize=fl.quantize_deltas)
            if track_errors:
                delta_errors[ids] = new_err
        plan.feedback(times)
        with torch.no_grad():
            acc = float(program.eval_metric(params, test_batch))
        hist["accuracy"].append(acc)
        # host seconds for the whole round; reading the accuracy back has
        # waited for the device
        hist["wall_s"].append(time.perf_counter() - t0)
        # the modelled round time: the slowest kept client (or the deadline
        # every client missed)
        if keep.any():
            slowest = float(np.max(times[keep]))
        elif fl.deadline_factor > 0:
            slowest = deadline_value(times, fl.deadline_factor)
        else:
            finite = times[np.isfinite(times)]
            slowest = float(finite.max()) if finite.size else 0.0
        hist["round_time"].append(slowest)
        hist["ops"].append(list(ops))
        hist["times"].append(times.copy())
        hist["comm_time"].append(comm.copy())
        hist["dropped"].append(int(K - keep.sum()))

    hist_np = {k: np.asarray(v) for k, v in hist.items()}
    hist_np["params"] = params
    return hist_np
