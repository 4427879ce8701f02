"""Event-driven asynchronous federated runtime on a virtual clock
(counterpart of ``repro/fl/async_loop.py``).

Each client finishes its local split training at its own modelled time
(Eq. 1 compute through ``SimulatedCluster``, communication through
``Transport``: the sync loop's ``RoundClock``) and reports to a server
that aggregates once ``FLConfig.buffer_size`` reports have arrived, then
re-dispatches the reporters with freshly planned OPs against the new
params.  Each buffered delta (against the params version the client was
dispatched with) is weighted ``n_k (1+s_k)^-a``, ``s_k`` its staleness in
server versions and ``a`` ``FLConfig.staleness_discount``; reports staler
than ``FLConfig.max_staleness`` are dropped.  With ``buffer_size=K`` and
``staleness_discount=0`` every aggregation is a synchronous round and the
history is ``run_federated``'s.

The aggregation runs through the sync loop's fused ``ServerStep`` over the
stacked fresh rows (reports carry flat delta rows), or with
``server_step="reference"`` through ``reference_server_step``; with
``client_widths`` both take the fresh reporters' mask rows, and with
``num_edges > 0`` the fused rows go through the two-tier server
(``fl/hierarchy.py``); ``mesh_shape`` threads the sync loop's mesh through
the layout, the engine and the server step.  The edge->root hop
(``edge_transport``) is reported as the ``edge_time`` column but not
clocked: the virtual clock is event-driven and ignores it.  Clients
behind dead links (``Transport`` returns ``inf``) never report; they are
re-dispatched with the current params at every aggregation
(``EventQueue.drop_unreachable``), and a fleet whose every in-flight
client is behind a dead link ends the run early.

``FLConfig.cohort_size`` keeps exactly C clients in flight: at each
aggregation the reporters are replaced by a seeded draw from the idle
fleet (``CohortSampler.pick``, keyed by version) and the EF rows live in a
host ``EFStore``.

``FLConfig.checkpoint_dir`` and ``checkpoint_every`` snapshot the run at
aggregation boundaries, where exactly C report events are in flight: the
scheduler's state is C timestamps and C flat delta rows
(``fl.state.async_state_tree``).  ``resume=True`` replays the remaining
aggregations bitwise; it needs an fp32 layout (``FlatLayout.exact_fp32``)
so that the delta rows round-trip exactly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.controller import FedAdaptController
from repro_torch.core.env import SimulatedCluster
from repro_torch.data.loader import FleetLoader
from repro_torch.fl.cohort import CohortSampler, EFStore
from repro_torch.fl.comm import Transport
from repro_torch.fl.flatbuf import (
    FlatLayout,
    get_root_step,
    get_server_step,
    reference_server_step,
)
from repro_torch.fl.fleet import get_engine, rows_as_list
from repro_torch.fl.hierarchy import hierarchical_apply
from repro_torch.fl.loop import (
    FLConfig,
    RoundClock,
    _check_ported,
    _delta_trees,
    _error_state,
    _initial_params,
    _resolve_hetero,
    _resolve_mesh,
    _resolve_planner,
    _restore_controller,
    _restore_errors,
    _seq_len,
)
from repro_torch.fl.planner import Planner
from repro_torch.fl.state import async_state_tree, ef_template_len
from repro_torch.models.split_program import get_split_program
from repro_torch.runtime.scheduler import EventQueue
from repro_torch.runtime.straggler import reweight


def staleness_weights(sizes, staleness, discount: float) -> np.ndarray:
    """Unnormalized async weights ``n_k * (1 + s_k)^-a``; ``a=0`` is plain
    data-size FedAvg weighting."""
    n = np.asarray(sizes, np.float64)
    s = np.asarray(staleness, np.float64)
    return n * (1.0 + s) ** (-float(discount))


@dataclasses.dataclass
class _Report:
    """One client's finished local training, in flight to the server."""
    client: int
    version: int      # params version the client was dispatched with
    op: int
    delta: Any        # fp32 delta against the dispatch-time params: a flat
                      # layout row (fused server step) or a tree (reference)
    time: float       # modelled duration (compute + comm) of this dispatch
    comm: float


def run_federated_async(
    cfg,
    clients_data: List[Dict[str, np.ndarray]],
    test_data: Dict[str, np.ndarray],
    fl: FLConfig,
    sim: Optional[SimulatedCluster] = None,
    controller: Optional[FedAdaptController] = None,
    planner: Optional[Planner] = None,
    transport: Optional[Transport] = None,
    on_aggregate: Optional[Callable[..., None]] = None,
    resume: bool = False,
    init_params=None,
    device=None,
    edge_transport: Optional[Transport] = None,
    mesh_devices=None,
) -> Dict[str, np.ndarray]:
    """Train ``cfg`` (a ``VGGConfig``, or any ``ModelConfig`` with a
    split program on token batches, as ``run_federated``) through the
    async virtual-clock runtime: one history row per server aggregation,
    ``fl.rounds`` of them at most.

    Besides ``run_federated``'s columns the history holds ``virtual_time``
    (the clock at each aggregation), ``staleness`` (mean staleness of the
    applied reports), ``dropped`` (``max_staleness`` discards),
    ``agg_weight_sum`` (the applied normalized weight mass: 1.0 when any
    report applied, else 0.0) and ``edge_time`` (the two-tier server's
    slowest edge->root hop through ``edge_transport`` at the aggregation's
    version, 0.0 without one; reported, not added to the clock).
    ``wall_s`` is the host seconds from the previous aggregation's accuracy
    read to this one's, checkpoint saves left out.

    ``on_aggregate(version, params, g_flat=...)`` fires after every
    aggregation (``g_flat``: the flat global under the fused server step,
    else ``None``).  ``device``, ``init_params``, ``resume`` and
    ``mesh_devices`` (with ``fl.mesh_shape``) are as in ``run_federated``.
    """
    device = resolve_device(device)
    _check_ported(fl)
    program = get_split_program(cfg)
    K = len(clients_data)
    if not 0 <= fl.cohort_size <= K:
        raise ValueError(f"cohort_size={fl.cohort_size} outside [0, K={K}]")
    # C, the in-flight set: with a cohort exactly C clients train at any
    # instant, and reporters are replaced from the idle fleet
    C = fl.cohort_size if fl.cohort_size > 0 else K
    buffer_size = fl.buffer_size if fl.buffer_size > 0 else C
    if not 1 <= buffer_size <= C:
        raise ValueError(f"buffer_size={buffer_size} outside [1, C={C}] "
                         f"(the in-flight cohort)")
    if fl.deadline_factor > 0 or fl.fail_prob > 0:
        raise ValueError(
            "the async runtime replaces deadline drops and failure masks "
            "(a slow client is simply aggregated late); run the sync loop "
            "for deadline_factor/fail_prob scenarios")

    params = _initial_params(program, fl, init_params, device)
    fused = fl.server_step == "fused"
    mesh = _resolve_mesh(fl, fused, device, mesh_devices)
    if mesh is None:
        layout = FlatLayout(params)
    else:
        params = program.shard_params(params, mesh)
        layout = program.flat_layout(params, mesh=mesh)
    if fl.checkpoint_dir and not layout.exact_fp32:
        raise ValueError(
            "async checkpoint/resume needs an fp32 parameter layout "
            "(in-flight deltas are checkpointed as flat rows, which is "
            "only bitwise for fp32)")
    loaders = FleetLoader.for_clients(clients_data, fl.batch_size,
                                      seed=fl.seed)
    engine = get_engine(fl.engine, program, fl.local_iters, fl.seed,
                        fl.augment, fl.quantize_transfer, device, mesh=mesh)
    native_op = program.native_op
    sizes = np.asarray([len(d["labels"]) for d in clients_data], np.float64)
    cohort = (CohortSampler(K, C, seed=fl.seed)
              if fl.cohort_size > 0 else None)
    track_errors = fl.delta_density < 1.0
    hetero = _resolve_hetero(fl, program, params, layout, K)
    delta_errors = _error_state(fl, cohort, K, layout, device)
    virtualized = isinstance(delta_errors, EFStore)
    ctl = controller if controller is not None \
        else getattr(planner, "controller", None)
    srv = (get_server_step(layout, fl.delta_density, fl.quantize_deltas)
           if fused else None)
    root = get_root_step(layout) if fl.num_edges > 0 else None
    g_flat = layout.flatten(params) if fused else None
    clock = RoundClock(program, fl, K, params, sim=sim, transport=transport,
                       compute_scale=(hetero.compute_scale
                                      if hetero is not None else None),
                       edge_transport=edge_transport,
                       seq=_seq_len(clients_data))

    mgr = CheckpointManager(fl.checkpoint_dir) if fl.checkpoint_dir else None
    version = 0            # server params version == aggregations so far
    queue = EventQueue()
    comm = np.zeros(K)
    current_ops = [native_op] * K
    in_flight = np.zeros(K, bool)
    last_agg_clock = 0.0
    shapes = mgr.latest_shapes() if mgr is not None and resume else None
    if shapes is not None:
        # the sparse EF snapshot's row count is data-dependent: size the
        # template from the file before the strict restore
        restored, version = mgr.restore_latest(async_state_tree(
            params, delta_errors, ctl, K, C, layout, template=True,
            ef_len=ef_template_len(shapes)))
        params = restored["params"]
        if mesh is not None:
            params = program.shard_params(params, mesh)
        if fused:
            g_flat = layout.flatten(params)
        delta_errors = _restore_errors(delta_errors, restored)
        _restore_controller(ctl, restored)
        st = restored["async"]
        queue = EventQueue(start_time=float(st["clock"][0]))
        last_agg_clock = float(st["clock"][1])
        times = np.asarray(st["times"], np.float64)
        comm = np.asarray(st["comm"], np.float64)
        current_ops = [int(o) for o in st["ops"]]
        loaders.restore([(int(e), int(c)) for e, c in st["loader_state"]])
        # re-push the C in-flight reports in their saved (t, seq) order:
        # fresh FIFO sequence numbers then break same-time ties as the
        # uninterrupted run did
        in_flight[np.asarray(st["ev_client"], np.int64)] = True
        ev_rows = torch.from_numpy(st["ev_delta"]).to(device, torch.float32)
        for i in range(C):
            row = ev_rows[i]
            queue.push(float(st["ev_t"][i]), _Report(
                int(st["ev_client"][i]), int(st["ev_version"][i]),
                int(st["ev_op"][i]), row if fused else layout.unflatten(row),
                float(st["ev_dur"][i]), float(st["ev_comm"][i])))
        plan = _resolve_planner(fl, native_op, planner, controller, sim)
        plan.begin(times)   # FedAdaptPlanner skips: baselines are restored
    else:
        # round-0 baselines (classic FL, no offloading), the sync loop's
        # normalizer
        times, _ = clock.times([native_op] * K, 0)
        if controller is not None and controller.baselines is None:
            controller.begin(times)
        plan = _resolve_planner(fl, native_op, planner, controller, sim)
        plan.begin(times)

    hist: Dict[str, list] = {"accuracy": [], "round_time": [], "ops": [],
                             "times": [], "comm_time": [], "dropped": [],
                             "virtual_time": [], "staleness": [],
                             "agg_weight_sum": [], "edge_time": [],
                             "wall_s": []}
    test_batch = {k: torch.from_numpy(v).to(device)
                  for k, v in test_data.items()}

    def dispatch(ks: List[int]) -> None:
        """Plan fresh OPs, train the clients (one fleet-engine call) and
        schedule their reports at ``now + modelled duration``."""
        lr = fl.lr * (fl.lr_drop_factor if version >= fl.lr_drop_round
                      else 1.0)
        bandwidths = sim.bandwidths(version) if sim is not None else None
        ops = plan.plan(version, times, bandwidths)
        in_flight[list(ks)] = True
        for k in ks:
            current_ops[k] = int(ops[k])
        idxs, rows = engine.run_round(params, loaders, ops, list(ks),
                                      version, lr, hetero=hetero)
        t_all, c_all = clock.times(ops, version)
        if fused:
            deltas_flat = layout.rows_to_deltas(rows, g_flat)
            per_client = [deltas_flat[pos] for pos in range(len(idxs))]
        else:
            per_client = _delta_trees(
                params, rows_as_list(rows, list(range(len(idxs)))))
        for pos, k in enumerate(idxs):
            rpt = _Report(k, version, int(ops[k]), per_client[pos],
                          float(t_all[k]), float(c_all[k]))
            queue.push(queue.now + rpt.time, rpt)

    def save_checkpoint() -> None:
        """Snapshot at an aggregation boundary: buffer empty, exactly C
        clients in flight (``async_state_tree`` checks the count)."""
        events = [(t, rpt, rpt.delta if fused else layout.flatten(rpt.delta))
                  for t, _, rpt in queue.snapshot()]
        mgr.save(async_state_tree(
            params, delta_errors, ctl, K, C, layout,
            clock=[queue.now, last_agg_clock], times=times, comm=comm,
            ops=current_ops, loader_state=loaders.state(), events=events),
            version)

    t0 = time.perf_counter()
    if shapes is None:
        dispatch([int(k) for k in cohort.members(0)] if cohort is not None
                 else list(range(K)))
    buffer: List[_Report] = []

    while version < fl.rounds:
        if len(buffer) < buffer_size and np.isfinite(queue.peek_time()):
            _, rpt = queue.pop()
            times[rpt.client] = rpt.time
            comm[rpt.client] = rpt.comm
            in_flight[rpt.client] = False
            buffer.append(rpt)
            continue
        if not buffer:
            break          # every in-flight client is behind a dead link
        # a short buffer here means the other in-flight clients can never
        # report (dead links): flush the finished updates rather than
        # discard them

        # --- server step: staleness-discounted buffered FedAvg -----------
        edges_used = 0
        buffer.sort(key=lambda e: e.client)
        stale = {e.client: version - e.version for e in buffer}
        fresh = [e for e in buffer
                 if fl.max_staleness is None
                 or stale[e.client] <= fl.max_staleness]
        if fresh:
            s = np.asarray([stale[e.client] for e in fresh], np.float64)
            w_full = np.zeros(K, np.float64)
            for e, wk in zip(fresh, staleness_weights(
                    [sizes[e.client] for e in fresh], s,
                    fl.staleness_discount)):
                w_full[e.client] = wk
            weights = reweight(w_full, w_full > 0)
            w_list = [weights[e.client] for e in fresh]
            fresh_ids = [e.client for e in fresh]
            ids = torch.as_tensor(fresh_ids, dtype=torch.int64, device=device)
            if not track_errors:
                err_rows = None
            elif virtualized:
                err_rows = delta_errors.fetch(fresh_ids)
            else:
                err_rows = delta_errors[ids]
            mask_rows = (hetero.rows(fresh_ids)
                         if hetero is not None else None)
            if fused:
                stacked = torch.stack([e.delta for e in fresh])
                if fl.num_edges > 0:
                    # the two-tier server: per-edge reduce, root apply
                    g_flat, new_err, edges_used = hierarchical_apply(
                        srv, root, g_flat, stacked, w_list, err_rows,
                        mask_rows, num_edges=fl.num_edges)
                else:
                    g_flat, new_err = srv(g_flat, stacked, w_list, err_rows,
                                          masks=mask_rows)
                params = layout.unflatten(g_flat)
            else:
                params, new_err = reference_server_step(
                    layout, params, [e.delta for e in fresh], w_list,
                    err_rows, density=fl.delta_density,
                    quantize=fl.quantize_deltas, masks=mask_rows)
            if virtualized:
                delta_errors.store(fresh_ids, new_err)
            elif track_errors:
                delta_errors[ids] = new_err
            mean_stale = float(s.mean())
            weight_sum = float(np.sum(w_list))
        else:
            mean_stale = 0.0
            weight_sum = 0.0
        # the two-tier server's hop at this aggregation's version, reported
        # in its own column: the event-driven clock does not advance by it
        edge_wall = 0.0
        if edges_used and edge_transport is not None:
            edge_wall = float(np.max(clock.edge_hop_times(edges_used,
                                                          version)))
        version += 1
        if on_aggregate is not None:
            on_aggregate(version, params, g_flat=g_flat if fused else None)
        plan.feedback(times)
        # --- history row (one per aggregation) ---------------------------
        with torch.no_grad():
            hist["accuracy"].append(float(program.eval_metric(params,
                                                              test_batch)))
        t1 = time.perf_counter()
        hist["wall_s"].append(t1 - t0)
        t0 = t1
        hist["round_time"].append(queue.now - last_agg_clock)
        hist["ops"].append(list(current_ops))
        hist["times"].append(times.copy())
        hist["comm_time"].append(comm.copy())
        hist["dropped"].append(len(buffer) - len(fresh))
        hist["virtual_time"].append(queue.now)
        hist["staleness"].append(mean_stale)
        hist["agg_weight_sum"].append(weight_sum)
        hist["edge_time"].append(edge_wall)
        last_agg_clock = queue.now
        # --- re-dispatch at the new version ------------------------------
        # without a cohort the reporters themselves; with one a seeded draw
        # of as many from the idle fleet (with cohort_size=K the idle set
        # is the reporters, and the draw gives them in order)
        reporters = sorted(e.client for e in buffer)
        buffer = []
        if version < fl.rounds:
            if cohort is not None:
                redispatch = [int(k) for k in cohort.pick(
                    version, np.flatnonzero(~in_flight), len(reporters))]
            else:
                redispatch = reporters
            dispatch(redispatch)
            # a client dispatched behind a dead link holds an inf event: it
            # re-fetches the current model at every aggregation, so it
            # reports fresh work once its link recovers
            stuck = sorted({r.client for r in queue.drop_unreachable()})
            if stuck:
                dispatch(stuck)
            if mgr is not None and fl.checkpoint_every and \
                    version % fl.checkpoint_every == 0:
                t_save = time.perf_counter()
                save_checkpoint()
                t0 += time.perf_counter() - t_save

    if virtualized:
        delta_errors.close()
    hist_np = {k: np.asarray(v) for k, v in hist.items()}
    hist_np["params"] = params
    return hist_np
