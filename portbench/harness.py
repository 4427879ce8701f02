"""One run of one cell: set-up, the measured window, the check, the result.

Set-up makes everything from the seed: the cell's token rows (``feed``),
the weights in the port's layout on the device (the family's ``init``:
one draw over one buffer), the paper testbed's first K devices and links.
It then drives ``repro_torch.fl.loop.run_federated`` (sequential engine,
fused server step) through ``CHECKED_ROUNDS`` rounds from those weights:
the rounds the check reads, and the warm-up of every shape the window
uses.  Their final weights, the same state, start the window.

The window is one further ``run_federated`` call of as many rounds as
fill ``--seconds`` at the set-up's round time; it runs from the call to
its last round's sync, every round counted.

After the window, with the program's state freed, the plain reference
(``reference/``) runs the checked rounds again from the same weights and
rows, and ``check`` compares the numbers that decide ``correct``.

With ``--trace 1`` the harness's own wrappers time the engine's
``run_round`` and the ``ServerStep`` call with a sync at each edge, and
``torch.profiler`` traces the window's rounds after its first.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import check, feed, registry, trace
from portbench.reference import common as C
from portbench.reference import federated

CHECKED_ROUNDS = 2
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class ForbiddenImport(RuntimeError):
    """JAX or the JAX package was loaded in the measuring process."""


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def set_precision(config: dict, tf32: Optional[bool] = None) -> None:
    """The matmul precision the configuration states (``tf32``: false
    keeps fp32 products off the TF32 path), or ``tf32`` where given."""
    on = bool(config.get("tf32", False)) if tf32 is None else tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def port_config(port: dict):
    """The port's ``ModelConfig`` from the configuration file's ``port``
    object."""
    from repro_torch.configs.base import ModelConfig, SSMConfig
    fields = dict(port)
    if fields.get("ssm") is not None:
        fields["ssm"] = SSMConfig(**fields["ssm"])
    return ModelConfig(**fields)


def fl_config(deployment: dict, traffic: dict, rounds: int, seed: int):
    from repro_torch.fl.loop import FLConfig
    return FLConfig(
        rounds=rounds, local_iters=int(traffic["local_steps"]),
        batch_size=int(traffic["rows_per_step"]), lr=float(deployment["lr"]),
        augment=False, mode=deployment["mode"],
        static_op=int(deployment["static_op"]),
        quantize_transfer=bool(deployment["quantize_transfer"]),
        delta_density=float(deployment["delta_density"]),
        quantize_deltas=bool(deployment["quantize_deltas"]), seed=seed,
        engine=deployment["engine"], server_step=deployment["server_step"])


def links(mcfg, fl, K: int, seq: int, seed: int):
    """The paper testbed's first K devices as an Eq. 1 cluster over the
    model's workload (5% speed jitter), and their links as a Transport."""
    from repro_torch.configs.vgg import VGG5
    from repro_torch.core import costmodel as cm
    from repro_torch.core.env import SimulatedCluster
    from repro_torch.core.testbed import paper_testbed
    from repro_torch.fl.comm import Transport, device_bandwidths
    from repro_torch.models.split_program import get_split_program
    program = get_split_program(mcfg)
    _, devices, c_srv, _ = paper_testbed(VGG5)
    sim = SimulatedCluster(cm.program_workload(program, fl.batch_size, seq),
                           devices[:K], c_srv, program.op_candidates(),
                           iterations=fl.local_iters, jitter=0.05, seed=seed)
    return sim, Transport(device_bandwidths(devices[:K]))


class SetupProbe:
    """During the checked rounds: each local step's loss as the program
    returns it and the rows it trained on, and each leaf's norm of round
    0's update as the server step applies it (the new flat global minus
    the old, leaf by leaf)."""

    def __init__(self, paths: List[str]):
        self.paths = paths
        self.losses: List[torch.Tensor] = []
        self.batches: List[tuple] = []
        self.update0: Optional[Dict[str, float]] = None

    def __enter__(self):
        from repro_torch.fl.flatbuf import ServerStep
        from repro_torch.models.split_program import SplitProgram
        self.restore = [(SplitProgram, "loss_through_cut",
                         SplitProgram.loss_through_cut),
                        (ServerStep, "__call__", ServerStep.__call__)]
        loss_fn, step_fn = self.restore[0][2], self.restore[1][2]
        probe = self

        def loss_through_cut(program, params, batch, op, quantize=False):
            out = loss_fn(program, params, batch, op, quantize)
            if torch.is_grad_enabled():
                probe.losses.append(out.detach())
                probe.batches.append((batch["tokens"].cpu().numpy(),
                                      batch["labels"].cpu().numpy()))
            return out

        def call(step, g, deltas, weights, errors=None, masks=None):
            new_g, new_err = step_fn(step, g, deltas, weights, errors, masks)
            if probe.update0 is None:
                lay = step.layout
                probe.update0 = {
                    path: float(torch.linalg.vector_norm(
                        new_g[off:off + n] - g[off:off + n],
                        dtype=torch.float64))
                    for path, off, n in zip(probe.paths, lay.offsets,
                                            lay.sizes)}
            return new_g, new_err
        SplitProgram.loss_through_cut = loss_through_cut
        ServerStep.__call__ = call
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self.restore:
            setattr(cls, name, fn)
        return False


class Spans:
    """The layer spans of a traced window: each ``run_round`` (the local
    training of a round) and each server step, a sync at each edge, and
    ``torch.profiler`` over the window's rounds from ``first`` on
    (started as that round enters ``run_round``, stopped once the
    window's time is taken, so that reading the trace falls outside
    it)."""

    def __init__(self, device: torch.device, first: int, rounds: int):
        self.device, self.first = device, first
        self.local: List[float] = []
        self.server: List[float] = []
        self.tracer = trace.Tracer(device, rounds - first)
        self.seen = 0

    def _timed(self, fn, out: List[float]):
        device = self.device

        def timed(*args, **kwargs):
            sync(device)
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            sync(device)
            out.append(time.perf_counter() - t0)
            return res
        return timed

    def __enter__(self):
        from repro_torch.fl.flatbuf import ServerStep
        from repro_torch.fl.fleet import SequentialEngine
        self.restore = [(SequentialEngine, "run_round",
                         SequentialEngine.run_round),
                        (ServerStep, "__call__", ServerStep.__call__)]
        local = self._timed(self.restore[0][2], self.local)
        spans = self

        def run_round(*args, **kwargs):
            if spans.seen == spans.first:
                spans.tracer.start()
            spans.seen += 1
            return local(*args, **kwargs)
        SequentialEngine.run_round = run_round
        ServerStep.__call__ = self._timed(self.restore[1][2], self.server)
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self.restore:
            setattr(cls, name, fn)
        self.tracer.stop()
        return False


@dataclasses.dataclass
class Reading:
    """What a metric's reader reads: the cell, the window and, in a traced
    run, the spans and the trace."""
    cell: registry.Cell
    family: object
    peaks: Dict[str, float]
    rounds: int
    window_s: float
    setup_s: float
    peak_bytes: int
    round_walls: List[float]
    spans: Optional[Spans] = None
    trace: Optional[trace.Trace] = None


def program_numbers(hist, probe: SetupProbe, start: C.Tree) -> dict:
    """The checked rounds' numbers as the program produced them."""
    return {"losses": [float(x) for x in probe.losses],
            "batches": probe.batches,
            "evals": [float(x) for x in hist["accuracy"]],
            "update0": probe.update0,
            "change": federated.norms(C.tree_map(
                lambda a, b: a - b, hist["params"], start))}


def reference_numbers(cell, fam, weight_seed, device, clients, test,
                      loader_seed, tf32: bool = False,
                      fault: Optional[str] = None) -> dict:
    set_precision(cell.config, tf32)
    try:
        params = fam.init(cell.config["port"], weight_seed, device)
        return federated.run(fam, cell.config["port"],
                             cell.config["deployment"], cell.traffic, params,
                             clients, test, loader_seed, CHECKED_ROUNDS,
                             fault)
    finally:
        set_precision(cell.config)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def check_imports(when: str) -> None:
    """Raise ``ForbiddenImport`` where JAX or the JAX package is loaded,
    compared by whole top-level names."""
    bad = forbidden_modules()
    if bad:
        raise ForbiddenImport(f"loaded in the measuring process {when}, by "
                              f"whole top-level name: {bad}")


def _pinned(t: torch.Tensor) -> torch.Tensor:
    host = t.detach().to("cpu")
    return host.pin_memory() if torch.cuda.is_available() else host


def run_cell(cell: registry.Cell, seed: int, seconds: float, traced: bool,
             device, t_start: float, log=print) -> dict:
    """One run; returns the result object (the last line's keys)."""
    from repro_torch.fl.loop import run_federated
    device = torch.device(device)
    set_precision(cell.config)
    port = cell.config["port"]
    fam = registry.family(port["family"], cell.root)
    mcfg = port_config(port)
    traffic, dep = cell.traffic, cell.config["deployment"]
    K, seq = int(traffic["clients"]), int(traffic["seq"])
    data_seed, weight_seed, loader_seed, sim_seed = feed.seeds(seed, 4)
    clients, test = feed.make(traffic, port["vocab_size"], data_seed,
                              CHECKED_ROUNDS)

    def federate(rounds, params):
        fl = fl_config(dep, traffic, rounds, loader_seed)
        sim, transport = links(mcfg, fl, K, seq, sim_seed)
        return run_federated(mcfg, clients, test, fl, sim=sim,
                             transport=transport, init_params=params,
                             device=device)

    start = fam.init(port, weight_seed, device)
    with SetupProbe([p for p, _ in C.leaf_paths(start)]) as probe:
        hist = federate(CHECKED_ROUNDS, start)
    prog = program_numbers(hist, probe, start)
    walls = [float(w) for w in hist["wall_s"]]
    rounds = max(1, int(seconds / min(walls[1:] or walls) + 0.5))
    handed = C.tree_map(_pinned, hist["params"])
    del hist, start, probe
    # the allocator keeps the checked rounds' blocks for the window, as
    # one longer run_federated call would; what set-up made lives to the
    # end, so later collections skip it
    gc.collect()
    gc.freeze()
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.monotonic() - t_start
    log(f"set-up {setup_s:.3f} s: checked rounds {walls} s; the window "
        f"runs {rounds} rounds", file=sys.stderr)
    if device.type == "cuda":
        log(f"card before the window ({CLOCKS}): {card_note(CLOCKS)}",
            file=sys.stderr)

    spans = Spans(device, 1 if rounds > 1 else 0, rounds) if traced \
        else None
    with spans if spans is not None else contextlib.nullcontext():
        t0 = time.monotonic()
        hist = federate(rounds, handed)
        sync(device)
        window_s = time.monotonic() - t0
    peak = int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0
    check_imports("once the window closed")
    round_walls = [float(w) for w in hist["wall_s"]]
    failed = int(np.sum(hist["dropped"]))
    del hist, handed
    free(device)
    log(f"window {window_s:.3f} s, {rounds} rounds {round_walls} s, peak "
        f"{peak / 2**30:.3f} GiB", file=sys.stderr)
    if device.type == "cuda":
        log(f"card after the window: {card_note(CLOCKS)}", file=sys.stderr)

    t1 = time.monotonic()
    ref = reference_numbers(cell, fam, weight_seed, device, clients, test,
                            loader_seed)
    log(f"reference {time.monotonic() - t1:.3f} s", file=sys.stderr)
    steps = K * int(traffic["local_steps"])
    compared = check.compare(prog, ref, cell.limits, steps)
    log(f"readings: {json.dumps(check.readings(prog, ref, steps))}",
        file=sys.stderr)
    log(f"loss gaps by step: {check.step_gaps(prog, ref)}", file=sys.stderr)
    log(f"worst leaves: {check.worst_leaves(prog, ref)}", file=sys.stderr)
    reading = Reading(cell=cell, family=fam, peaks=registry.peaks(cell.root),
                      rounds=rounds, window_s=window_s, setup_s=setup_s,
                      peak_bytes=peak, round_walls=round_walls, spans=spans,
                      trace=spans.tracer.result if spans is not None
                      else None)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = registry.metric_reader(m["name"], cell.root).read(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": check.correct(compared), "attempted": K * rounds,
           "failed": failed, "metrics": metrics,
           "device": device_record(device, peak, reading.trace)}
    if reading.trace is not None:
        out["breakdown"] = reading.trace.breakdown()
    out["compared"] = compared
    return out


def device_record(device, peak: int, tr) -> dict:
    rec = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    if tr is not None:
        rec["busy_s"] = tr.busy_s
        rec["window_s"] = tr.window_s
    return rec


def readings(cell: registry.Cell, seed: int, kinds: List[str], device,
             log=print) -> dict:
    """The control's and the faults' readings at the cell's size: the
    reference in the program's place, computed in TF32 (``"tf32"``) or
    with a fault planted (``federated.FAULTS``), against the sound
    reference: every number ``check`` computes.  No window; for setting
    limits."""
    device = torch.device(device)
    port = cell.config["port"]
    fam = registry.family(port["family"], cell.root)
    data_seed, weight_seed, loader_seed, _ = feed.seeds(seed, 4)
    clients, test = feed.make(cell.traffic, port["vocab_size"], data_seed,
                              CHECKED_ROUNDS)
    args = (cell, fam, weight_seed, device, clients, test, loader_seed)
    ref = reference_numbers(*args)
    out = {}
    for kind in kinds:
        t0 = time.monotonic()
        got = (reference_numbers(*args, tf32=True) if kind == "tf32"
               else reference_numbers(*args, fault=kind))
        out[kind] = check.readings(got, ref, int(cell.traffic["clients"])
                                   * int(cell.traffic["local_steps"]))
        log(f"{kind} loss gaps by step: {check.step_gaps(got, ref)}",
            file=sys.stderr)
        log(f"{kind}: {json.dumps(out[kind])} "
            f"({time.monotonic() - t0:.1f} s)", file=sys.stderr)
        free(device)
    return out


CLOCKS = ("clocks.sm,clocks.mem,temperature.gpu,power.draw,"
          "clocks_throttle_reasons.active")


def card_note(query: str = "name,power.limit") -> str:
    """What nvidia-smi reads of the card: by default its name and power
    limit."""
    try:
        res = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return res.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
