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

A seeded cohort (``cohort_size``) trains in place of the whole fleet
each round, its error feedback kept host-side in an ``EFStore``; every
``checkpoint_every`` rounds the run's state goes to ``checkpoint_dir``
(``fl/state.py``), and ``resume=True`` restores the latest checkpoint,
replays the loaders' draws of the rounds before it and returns the rest of
the history.

``client_widths`` gives each client a HeteroFL width (``fl/hetero.py``):
masked local training, the coverage-count server step, and Eq. 1 compute
scaled by ``width**2``.  ``num_edges > 0`` aggregates through the two-tier
server (``fl/hierarchy.py``, fused step only); with an ``edge_transport``
the slowest edge's hop to the root is the ``edge_time`` column and extends
the round.  ``mesh_shape=(data, model)`` runs the round over a device mesh
(``parallel.sharding.make_flat_mesh`` over ``mesh_devices``, by default
the visible cards, or the one CPU device of a CPU run): the flat layout
gains its shard tail, the fused server step shards over the mesh
(``ShardedServerStep``, the edges' ``reduce`` too) and the batched engine
trains each data shard's clients on its own place; ``mesh_shape=(1, 1)``
is the mesh-less run bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.controller import FedAdaptController
from repro_torch.core.env import SimulatedCluster
from repro_torch.data.loader import FleetLoader
from repro_torch.fl.cohort import CohortSampler, EFStore
from repro_torch.fl.comm import Transport
from repro_torch.fl.fedavg import fedavg_delta_stacked, model_bytes
from repro_torch.fl.flatbuf import (
    FlatLayout,
    get_root_step,
    get_server_step,
    reference_server_step,
)
from repro_torch.fl.fleet import (
    StackedRows,
    get_engine,
    rows_as_list,
    take_rows,
)
from repro_torch.fl.hetero import resolve_hetero
from repro_torch.fl.hierarchy import hierarchical_apply
from repro_torch.fl.planner import FedAdaptPlanner, Planner, StaticPlanner
from repro_torch.fl.state import base_state_tree, ef_template_len
from repro_torch.models.split_program import get_split_program
from repro_torch.parallel.sharding import default_places, make_flat_mesh
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
    cohort_size: int = 0             # >0: a seeded cohort of this many
                                     # clients trains each round (EF rows
                                     # in a host EFStore); 0: every client
    # the async runtime (fl/async_loop.run_federated_async)
    buffer_size: int = 0             # aggregate once this many reports
                                     # arrive; 0: the in-flight set (K)
    staleness_discount: float = 0.0  # a in the weight discount (1 + s)^-a
    max_staleness: Optional[int] = None  # drop staler reports (None: none)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0        # rounds (aggregations) between saves
    client_widths: Optional[Sequence[float]] = None  # each client's
                                     # HeteroFL width in (0, 1]; None: full
    num_edges: int = 0               # >0: the two-tier server's edges
    mesh_shape: Optional[Sequence[int]] = None  # (data, model): the
                                     # server step and the batched engine
                                     # over a device mesh (fused step
                                     # only); None: one device


def _check_ported(fl: FLConfig) -> None:
    if fl.mode not in ("fl", "sfl", "fedadapt"):
        raise ValueError(f"unknown mode {fl.mode!r}")
    if fl.server_step not in ("fused", "reference"):
        raise ValueError(f"unknown server_step {fl.server_step!r}; "
                         f"known: fused, reference")
    if fl.num_edges < 0:
        raise ValueError(f"num_edges={fl.num_edges} must be >= 0")
    if fl.num_edges > 0 and fl.server_step != "fused":
        raise ValueError(
            "hierarchical aggregation (num_edges > 0) runs through the "
            "fused flat-buffer server step; server_step='reference' is the "
            "per-client oracle it is tested against, not a tiered path")


def _resolve_mesh(fl: FLConfig, fused: bool, device: torch.device,
                  mesh_devices=None):
    """``FLConfig.mesh_shape`` -> the ``(data, model)`` mesh over
    ``mesh_devices`` (default: ``default_places(device)``), or ``None``.
    The mesh's home place holds the run's buffers, so it must be the run's
    device."""
    if fl.mesh_shape is None:
        return None
    if not fused:
        raise ValueError(
            "mesh_shape runs through the fused flat-buffer server step; "
            "server_step='reference' is the single-device per-leaf oracle")
    mesh = make_flat_mesh(fl.mesh_shape, devices=(
        mesh_devices if mesh_devices is not None
        else default_places(device)))
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if mesh.home != device:
        raise ValueError(f"the mesh's first place {mesh.home} must be the "
                         f"run's device {device}")
    return mesh


def _resolve_hetero(fl: FLConfig, program, params, layout: FlatLayout,
                    K: int):
    """The run's ``HeteroSpec`` (``None`` without widths); its widths
    must be one for each of the K clients."""
    hetero = resolve_hetero(fl, program, params, layout)
    if hetero is not None and len(hetero) != K:
        raise ValueError(f"client_widths has {len(hetero)} entries for "
                         f"K={K} clients")
    return hetero


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
    the full model down).  ``compute_scale`` (HeteroFL ``width**2`` a
    client) scales the compute and never the communication;
    ``edge_transport`` charges the two-tier server's edge->root hop.
    ``seq`` is an LM's sequence length, which sizes its cut (None for
    VGG)."""

    def __init__(self, program, fl: FLConfig, K: int, params,
                 sim: Optional[SimulatedCluster] = None,
                 transport: Optional[Transport] = None,
                 compute_scale: Optional[np.ndarray] = None,
                 edge_transport: Optional[Transport] = None,
                 seq: Optional[int] = None):
        self.program = program
        self.fl = fl
        self.K = K
        self.seq = seq
        self.sim = sim
        self.transport = transport
        self.edge_transport = edge_transport
        self.native_op = program.native_op
        self.model_bytes = float(model_bytes(params))
        self.compute_scale = (np.asarray(compute_scale, np.float64)
                              if compute_scale is not None else None)

    def comm_times(self, ops: List[int], round_idx: int) -> np.ndarray:
        fl, sim = self.fl, self.sim
        iters = sim.iterations if sim is not None else fl.local_iters
        out = []
        for k, op in enumerate(ops):
            t = 0.0
            if op < self.native_op:
                up = self.program.cut_bytes(op, fl.batch_size, self.seq,
                                            quantize=fl.quantize_transfer)
                down = self.program.cut_bytes(op, fl.batch_size, self.seq)
                t += iters * self.transport.round_comm_time(
                    up, down, round_idx, k)
            up = self.model_bytes * fl.delta_density
            if fl.quantize_deltas:
                up *= 0.25
            t += self.transport.round_comm_time(up, self.model_bytes,
                                                round_idx, k)
            out.append(t)
        return np.asarray(out)

    def edge_hop_times(self, num_edges: int, round_idx: int) -> np.ndarray:
        """Per-edge edge->root time of one aggregation: the edge's dense
        fp32 pre-reduced row up and the model down (compression lives on
        the client->edge hop), through ``edge_transport`` with the edge
        index as the link; zeros without one (a free root hop)."""
        if self.edge_transport is None or num_edges <= 0:
            return np.zeros(max(int(num_edges), 0))
        return np.asarray([
            self.edge_transport.round_comm_time(
                self.model_bytes, self.model_bytes, round_idx, e)
            for e in range(int(num_edges))])

    def times(self, ops: List[int], round_idx: int):
        """(total per-device round times, comm component)."""
        scale = self.compute_scale
        if self.transport is not None:
            comm = self.comm_times(ops, round_idx)
            comp = (self.sim.round_compute_times(ops, round_idx)
                    if self.sim is not None else np.zeros(self.K))
            if scale is not None:
                comp = comp * scale
            return comp + comm, comm
        if self.sim is not None:
            if scale is not None:
                # Eq. 1's own network term does not shrink with the width
                comp = self.sim.round_compute_times(ops, round_idx)
                total = self.sim.round_times(ops, round_idx)
                return comp * scale + (total - comp), np.zeros(self.K)
            return self.sim.round_times(ops, round_idx), np.zeros(self.K)
        if scale is not None:
            return np.ones(self.K) * scale, np.zeros(self.K)
        return np.ones(self.K), np.zeros(self.K)


def _initial_params(program, fl: FLConfig, init_params, device):
    """The run's starting weights on ``device``: ``init_params`` (any
    nested tree of numpy arrays or tensors, each container kept as its own
    type) as fp32 copies, else ``program.init(seed, device)``."""
    if init_params is None:
        return program.init(fl.seed, device)
    return tree_map(lambda v: (
        v.detach().to(device, torch.float32).clone()
        if isinstance(v, torch.Tensor) else
        torch.tensor(np.asarray(v, np.float32), device=device)), init_params)


def _seq_len(clients_data) -> Optional[int]:
    """An LM fleet's sequence length (its clients' token rows); None for
    VGG."""
    first = clients_data[0]
    return int(first["tokens"].shape[1]) if "tokens" in first else None


def _error_state(fl: FLConfig, cohort: Optional[CohortSampler], K: int,
                 layout: FlatLayout, device: torch.device):
    """The EF rows: none without top-k, a host ``EFStore`` under a cohort
    (the device holds only the rows a step fetches), else a dense zero
    ``(K, padded)`` tensor on the device."""
    if fl.delta_density >= 1.0:
        return None
    if cohort is not None:
        return EFStore(K, layout.padded, device)
    return torch.zeros((K, layout.padded), dtype=torch.float32,
                       device=device)


def _restore_errors(errors, state: dict):
    """The EF rows of a restored tree, in the run's representation."""
    if isinstance(errors, EFStore):
        errors.restore(np.asarray(state["ef"]["ids"], np.int64),
                       state["ef"]["rows"])
        return errors
    return state["delta_errors"] if errors is not None else None


def _restore_controller(ctl, state: dict) -> None:
    if ctl is not None:
        ctl.baselines = np.asarray(state["controller"]["baselines"],
                                   np.float64)
        ctl.prev_actions = np.asarray(state["controller"]["prev_actions"],
                                      np.float32)


def run_federated(
    cfg,
    clients_data: List[Dict[str, np.ndarray]],
    test_data: Dict[str, np.ndarray],
    fl: FLConfig,
    sim: Optional[SimulatedCluster] = None,
    controller: Optional[FedAdaptController] = None,
    planner: Optional[Planner] = None,
    transport: Optional[Transport] = None,
    resume: bool = False,
    init_params=None,
    device=None,
    edge_transport: Optional[Transport] = None,
    mesh_devices=None,
) -> Dict[str, np.ndarray]:
    """Train ``cfg`` federated with per-round offloading: a ``VGGConfig``
    on image batches, or any ``ModelConfig`` with a split program on token
    batches (``clients_data`` rows of ``tokens`` and ``labels``, plus the
    VLM's ``patches`` or encdec's ``frames``; their sequence length sizes
    the cut's bytes).

    ``device=None`` runs on the card and raises if none is visible; pass
    ``device="cpu"`` for the CPU.  ``init_params`` (the reference's params
    tree, numpy or tensors) starts the run from given weights; by default
    they are ``program.init(seed)`` (VGG's drawn from
    ``torch.Generator().manual_seed(seed)``).
    Returns the history: per-round eval metric (``accuracy``: accuracy for
    VGG, the -CE loss at the native OP over the whole test set for an LM),
    modelled round and comm times,
    per-device OPs and drop counts (clients outside the round's cohort
    count as dropped), the two-tier server's edge->root hop (``edge_time``,
    charged through ``edge_transport`` and added to ``round_time``; 0.0
    without one), the measured wall time of each round (``wall_s``), plus
    the final ``params``.  With ``resume=True`` and a checkpoint in
    ``fl.checkpoint_dir``, the run continues from it and the history holds
    the remaining rounds only.  ``mesh_devices`` lists the places of
    ``fl.mesh_shape``'s mesh (a device may repeat; the first must be
    ``device``).
    """
    device = resolve_device(device)
    _check_ported(fl)
    program = get_split_program(cfg)
    K = len(clients_data)
    if not 0 <= fl.cohort_size <= K:
        raise ValueError(f"cohort_size={fl.cohort_size} outside [0, K={K}]")
    params = _initial_params(program, fl, init_params, device)
    fused = fl.server_step == "fused"
    mesh = _resolve_mesh(fl, fused, device, mesh_devices)
    if mesh is not None:
        params = program.shard_params(params, mesh)
    layout = program.flat_layout(params, mesh=mesh)
    loaders = FleetLoader.for_clients(clients_data, fl.batch_size,
                                      seed=fl.seed)
    engine = get_engine(fl.engine, program, fl.local_iters, fl.seed,
                        fl.augment, fl.quantize_transfer, device, mesh=mesh)
    injector = FailureInjector(fl.fail_prob, seed=fl.seed)
    native_op = program.native_op
    sizes = np.asarray([len(d["labels"]) for d in clients_data], np.float64)
    cohort = (CohortSampler(K, fl.cohort_size, seed=fl.seed)
              if fl.cohort_size > 0 else None)
    track_errors = fl.delta_density < 1.0
    hetero = _resolve_hetero(fl, program, params, layout, K)
    delta_errors = _error_state(fl, cohort, K, layout, device)
    virtualized = isinstance(delta_errors, EFStore)
    ctl = controller if controller is not None \
        else getattr(planner, "controller", None)

    mgr = CheckpointManager(fl.checkpoint_dir) if fl.checkpoint_dir else None
    start_round = 0
    shapes = mgr.latest_shapes() if mgr is not None and resume else None
    if shapes is not None:
        # the sparse EF snapshot's row count is data-dependent: size the
        # template from the file before the strict restore
        restored, start_round = mgr.restore_latest(base_state_tree(
            params, delta_errors, ctl, K, template=True,
            ef_len=ef_template_len(shapes)))
        params = restored["params"]
        if mesh is not None:
            params = program.shard_params(params, mesh)
        delta_errors = _restore_errors(delta_errors, restored)
        _restore_controller(ctl, restored)
        # replay the loaders: a client drew local_iters batches in every
        # earlier round it was alive and in the cohort, and both are pure
        # functions of the seed and the round
        alive_rounds = np.zeros(K, np.int64)
        for rr in range(start_round):
            m = injector.round_mask(K, round_idx=rr)
            if cohort is not None:
                m = m & cohort.member_mask(rr)
            alive_rounds += m
        for k in np.flatnonzero(alive_rounds):
            loaders.skip_client(int(k), int(alive_rounds[k]) * fl.local_iters)
    clock = RoundClock(program, fl, K, params, sim=sim, transport=transport,
                       compute_scale=(hetero.compute_scale
                                      if hetero is not None else None),
                       edge_transport=edge_transport,
                       seq=_seq_len(clients_data))
    step = (get_server_step(layout, fl.delta_density, fl.quantize_deltas)
            if fused else None)
    root = get_root_step(layout) if fl.num_edges > 0 else None
    g_flat = layout.flatten(params) if fused else None

    # round-0 baselines (classic FL, no offloading)
    times, _ = clock.times([native_op] * K, 0)
    if controller is not None and controller.baselines is None:
        controller.begin(times)
    plan = _resolve_planner(fl, native_op, planner, controller, sim)
    plan.begin(times)

    hist: Dict[str, list] = {"accuracy": [], "round_time": [], "ops": [],
                             "times": [], "comm_time": [], "dropped": [],
                             "edge_time": [], "wall_s": []}
    test_batch = {k: torch.from_numpy(v).to(device)
                  for k, v in test_data.items()}

    for r in range(start_round, fl.rounds):
        t0 = time.perf_counter()
        lr = fl.lr * (fl.lr_drop_factor if r >= fl.lr_drop_round else 1.0)
        bandwidths = sim.bandwidths(r) if sim is not None else None
        ops = plan.plan(r, times, bandwidths)
        alive = injector.round_mask(K, round_idx=r)
        if cohort is not None:
            alive &= cohort.member_mask(r)
            if virtualized:
                # the host gather of the cohort's EF rows overlaps its
                # training; the survivors' fetch takes the staged rows
                delta_errors.prefetch(np.flatnonzero(alive))
        idxs, rows = engine.run_round(params, loaders, ops,
                                      [int(k) for k in np.flatnonzero(alive)],
                                      r, lr, hetero=hetero)
        times, comm = clock.times(ops, r)
        keep = np.ones(K, bool)
        if fl.deadline_factor > 0:
            keep = deadline_mask(times, fl.deadline_factor)
        keep &= alive
        weights = reweight(sizes, keep)
        kept_pos = [i for i, k in enumerate(idxs) if keep[k]]
        surv_idx = [idxs[i] for i in kept_pos]
        surv_w = [weights[k] for k in surv_idx]
        # mask rows follow the survivors' order, the engine's output order
        mask_rows = (hetero.rows(surv_idx)
                     if kept_pos and hetero is not None else None)
        edges_used = 0
        if kept_pos and not fused and hetero is None and not track_errors \
                and not fl.quantize_deltas and isinstance(rows, StackedRows):
            # reference path, plain averaging, batched engine: one stacked
            # tensordot per leaf rather than a per-client loop
            params = fedavg_delta_stacked(
                params, take_rows(rows, kept_pos).tree, surv_w)
        elif kept_pos:
            ids = torch.as_tensor(surv_idx, dtype=torch.int64, device=device)
            if not track_errors:
                err_rows = None
            elif virtualized:
                err_rows = delta_errors.fetch(surv_idx)
            else:
                err_rows = delta_errors[ids]
            if fused:
                deltas = layout.rows_to_deltas(take_rows(rows, kept_pos),
                                               g_flat)
                # the clients' params are in the deltas now: free them
                # before the step
                rows = None
                if fl.num_edges > 0:
                    # the two-tier server: per-edge reduce, root apply
                    g_flat, new_err, edges_used = hierarchical_apply(
                        step, root, g_flat, deltas, surv_w, err_rows,
                        mask_rows, num_edges=fl.num_edges)
                else:
                    g_flat, new_err = step(g_flat, deltas, surv_w, err_rows,
                                           masks=mask_rows)
                params = layout.unflatten(g_flat)
            else:
                # the per-leaf, per-client reference server step
                params, new_err = reference_server_step(
                    layout, params, _delta_trees(
                        params, rows_as_list(rows, kept_pos)),
                    surv_w, err_rows, density=fl.delta_density,
                    quantize=fl.quantize_deltas, masks=mask_rows)
            if virtualized:
                delta_errors.store(surv_idx, new_err)
            elif track_errors:
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
        # the two-tier server's slowest edge->root hop extends the round
        edge_wall = 0.0
        if edges_used and edge_transport is not None:
            edge_wall = float(np.max(clock.edge_hop_times(edges_used, r)))
            slowest += edge_wall
        hist["round_time"].append(slowest)
        hist["edge_time"].append(edge_wall)
        hist["ops"].append(list(ops))
        hist["times"].append(times.copy())
        hist["comm_time"].append(comm.copy())
        hist["dropped"].append(int(K - keep.sum()))
        if mgr is not None and fl.checkpoint_every and \
                (r + 1) % fl.checkpoint_every == 0:
            mgr.save(base_state_tree(params, delta_errors, ctl, K), r + 1)

    if virtualized:
        delta_errors.close()
    hist_np = {k: np.asarray(v) for k, v in hist.items()}
    hist_np["params"] = params
    return hist_np
