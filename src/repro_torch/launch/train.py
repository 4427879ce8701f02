"""End-to-end FedAdapt LM training driver (counterpart of
``repro/launch/train.py``).

Trains an LM with the whole FedAdapt stack: K heterogeneous client slices,
the PPO controller choosing each device group's Offloading Point every
round, split execution through the ``SplitProgram`` API (optionally int8
smashed data), FedAvg of the client deltas, straggler deadlines, failure
injection and checkpoint/resume.  Any registered ``SplitProgram`` family
trains through it (``--arch mamba2-780m-smoke`` runs the attention-free SSM
family, its SSD scan's gradient a hand-written kernel on the card)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch lm16m \\
        --rounds 40 --local-steps 5 --batch 2 --seq 64 --ckpt-dir /tmp/lm
    PYTHONPATH=src python -c "from repro_torch.launch.train import main; \\
        main(['--arch', 'lm16m', '--rounds', '3'], device='cpu')"

The flags, the CSV lines and the return value (the final params) are the
reference's.  Round *times* come from the Eq. 1 cost model over a simulated
fleet of slices (``make_client_profiles``); the model updates are real,
and run on the card unless ``device="cpu"`` is given.  ``train`` is the
driver's body for a config and parsed settings; ``replay_control`` runs its
control plane alone (OPs, modelled times, drops, with no model), which
reads nothing of the training.

Random draws: the params come from the port's generator seeded with
``--seed``, the agent's from its own; ``init_params``, ``agent_params``
and ``agent_noise`` inject the reference's threefry draws, and a CPU run
then replays the reference's run.  The token streams, the cluster's
jitter and the failures are numpy and identical.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.lm_small import SMALL_CONFIGS
from repro_torch.core import costmodel as cm
from repro_torch.core.agent import PPOAgent, PPOConfig
from repro_torch.core.controller import FedAdaptController
from repro_torch.core.env import SimulatedCluster
from repro_torch.data.synthetic import batch_tokens, make_token_stream
from repro_torch.fl.fedavg import fedavg_delta
from repro_torch.models.split_program import get_split_program
from repro_torch.optim import adamw, cosine
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.straggler import deadline_mask, reweight
from repro_torch.tree import tree_map

ARCHS = list(SMALL_CONFIGS) + ["mamba2-780m-smoke", "llama3-8b-smoke"]


def make_client_profiles(k: int):
    """Heterogeneous slices: one fast 'server-class' client, mid clients,
    one straggler (the paper's Jetson / Pi4 + Pi3s / throttled Pi4)."""
    profs = []
    for i in range(k):
        if i == 0:
            profs.append(cm.slice_profile(f"client{i}", chips=8, mfu=0.5))
        elif i == k - 1:
            profs.append(cm.slice_profile(f"client{i}", chips=1, mfu=0.15))
        else:
            profs.append(cm.slice_profile(f"client{i}", chips=2, mfu=0.3))
    return profs


def resolve_arch(name: str):
    if name in SMALL_CONFIGS:
        return SMALL_CONFIGS[name]
    # "<registry-arch>-smoke" trains the family's smoke config
    from repro_torch.configs import get_smoke_config
    return get_smoke_config(name[: -len("-smoke")])


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lm16m", choices=ARCHS)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mode", default="fedadapt", choices=["fedadapt", "fl"])
    ap.add_argument("--quantize-transfer", action="store_true",
                    help="int8 smashed data across the cut")
    ap.add_argument("--deadline", type=float, default=0.0)
    ap.add_argument("--fail-prob", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _control(program, args, agent_device, agent_params=None,
             agent_noise=None):
    """The control plane: the simulated cluster over the program's Eq. 1
    workload (bf16 cut bytes, as the reference models them), the OP grid,
    the controller with its factored 3-group agent, the failure
    injector."""
    workload = cm.program_workload(program, args.batch, args.seq,
                                   bytes_per_el=2)
    native = program.native_op
    op_candidates = sorted(set(list(range(0, native + 1, 2)) + [native]))
    devices = make_client_profiles(args.clients)
    server_flops = cm.slice_profile("server", chips=64, mfu=0.5).flops_per_s
    sim = SimulatedCluster(workload, devices, server_flops, op_candidates,
                           iterations=args.local_steps, jitter=0.03,
                           seed=args.seed)
    agent = PPOAgent(PPOConfig(num_groups=3, factored=True), seed=args.seed,
                     params=agent_params, device=agent_device,
                     noise=agent_noise)
    controller = FedAdaptController(workload, op_candidates, num_groups=3,
                                    low_bw_threshold=None, agent=agent,
                                    seed=args.seed)
    return sim, controller, FailureInjector(args.fail_prob, seed=args.seed)


def _round_plan(args, sim, controller, injector, times, r):
    """The round's OPs and which clients are alive."""
    if args.mode == "fedadapt":
        ops = controller.plan(times, sim.bandwidths(r), explore=True).ops
    else:
        ops = sim.native_ops()
    return ops, injector.round_mask(args.clients, round_idx=r)


def _kept(args, times, alive) -> np.ndarray:
    keep = np.ones(args.clients, bool)
    if args.deadline > 0:
        keep = deadline_mask(times, args.deadline)
    return keep & alive


def replay_control(cfg, args, agent_params=None, agent_noise=None,
                   start_round: int = 0) -> Dict[str, list]:
    """The driver's control plane alone, on the CPU, with no model:
    every round's OPs, modelled round times and drops, as ``train``
    (with the same settings, agent params and noise) produces them: the
    controller reads only the modelled times."""
    program = get_split_program(cfg)
    sim, controller, injector = _control(program, args, "cpu", agent_params,
                                         agent_noise)
    times = sim.round_times(sim.native_ops(), 0)
    controller.begin(times)
    out: Dict[str, list] = {"ops": [], "times": [], "dropped": []}
    for r in range(start_round, args.rounds):
        ops, alive = _round_plan(args, sim, controller, injector, times, r)
        times = sim.round_times(ops, r)
        keep = _kept(args, times, alive)
        if args.mode == "fedadapt":
            controller.feedback(times)
        out["ops"].append(list(ops))
        out["times"].append(times.copy())
        out["dropped"].append(int(args.clients - keep.sum()))
    return out


def _leaves(tree) -> List[torch.Tensor]:
    """``tree``'s leaves in ``tree_map``'s order (insertion order)."""
    flat: List[torch.Tensor] = []
    tree_map(flat.append, tree)
    return flat


def train(cfg, args, device=None, init_params=None, agent_params=None,
          agent_noise: Optional[Callable] = None,
          log: Callable[[str], None] = print) -> Dict[str, object]:
    """The driver's body for ``cfg`` and the parsed ``args``; returns
    ``{"params", "history"}``, the history holding each round's mean
    client loss, modelled round times (all clients), OPs, drops and wall
    seconds.  ``init_params`` (the program's param tree, anywhere: moved to
    ``device``), ``agent_params`` and ``agent_noise`` inject the initial
    draws."""
    device = resolve_device(device)
    program = get_split_program(cfg)
    K = args.clients
    log(f"# FedAdapt LM training: {cfg.name} "
        f"({cfg.param_count()/1e6:.0f}M params), K={K} clients, "
        f"mode={args.mode}")
    if init_params is None:
        params = program.init(args.seed, device)
    else:
        params = tree_map(lambda t: t.to(device), init_params)
    opt = adamw(schedule=cosine(args.lr, args.rounds * args.local_steps,
                                warmup_steps=20))
    opt_state = opt.init(params)
    streams = [make_token_stream(400_000, cfg.vocab_size, seed=args.seed + i)
               for i in range(K)]

    def local_step(p, o, tokens, labels, op, quant):
        live = tree_map(lambda t: t.detach().requires_grad_(), p)
        loss = program.loss_through_cut(
            live, {"tokens": tokens, "labels": labels}, op, quantize=quant)
        leaves = _leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter([torch.zeros_like(t) if g is None else g
                   for t, g in zip(leaves, grads)])
        with torch.no_grad():
            p, o = opt.update(p, tree_map(lambda _: next(it), live), o)
        return p, o, loss.detach()

    sim, controller, injector = _control(program, args, device,
                                         agent_params, agent_noise)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_round = 0
    if mgr is not None and args.resume:
        restored, step = mgr.restore_latest(
            {"params": params, "opt": opt_state})
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]
            start_round = int(step)
            log(f"# resumed from round {start_round}")

    baseline = sim.round_times(sim.native_ops(), 0)
    controller.begin(baseline)
    times = baseline
    hist: Dict[str, list] = {"loss": [], "client_losses": [], "times": [],
                             "ops": [], "dropped": [], "wall_s": []}
    log("round,loss,round_time_s,ops,dropped,wall_s")
    for r in range(start_round, args.rounds):
        t0 = time.time()
        ops, alive = _round_plan(args, sim, controller, injector, times, r)
        client_params, losses = [], []
        for k in range(K):
            if not alive[k]:
                continue
            p_k, o_k = params, opt_state
            for step in range(args.local_steps):
                toks, labs = batch_tokens(streams[k], args.batch, args.seq,
                                          r * args.local_steps + step)
                p_k, o_k, loss = local_step(
                    p_k, o_k, torch.from_numpy(toks).to(device),
                    torch.from_numpy(labs).to(device), ops[k],
                    args.quantize_transfer)
            client_params.append(p_k)
            losses.append(float(loss))
            del p_k, o_k
        times = sim.round_times(ops, r)
        keep = _kept(args, times, alive)
        w = reweight(np.ones(K), keep)
        survivors = [cp for k, cp in zip(np.flatnonzero(alive), client_params)
                     if keep[k]]
        sw = [w[k] for k in np.flatnonzero(alive) if keep[k]]
        del client_params
        if survivors:
            with torch.no_grad():
                params = fedavg_delta(params, survivors, sw)
                # the optimizer state follows the global model: the
                # clients' local states are private in FedAvg
                opt_state = opt.update(params, tree_map(torch.zeros_like,
                                                        params),
                                       opt_state)[1]
        del survivors
        if args.mode == "fedadapt":
            controller.feedback(times)
        wall = time.time() - t0
        mean_loss = float(np.mean(losses))
        hist["loss"].append(mean_loss)
        hist["client_losses"].append(losses)
        hist["times"].append(times.copy())
        hist["ops"].append(list(ops))
        hist["dropped"].append(int(K - keep.sum()))
        hist["wall_s"].append(wall)
        log(f"{r},{mean_loss:.4f},{times.max():.3f},"
            f"\"{ops}\",{int(K - keep.sum())},{wall:.1f}")
        if mgr is not None and (r + 1) % args.ckpt_every == 0:
            mgr.save({"params": params, "opt": opt_state}, r + 1)
    log("# done")
    return {"params": params, "history": hist}


def main(argv=None, device=None, **inject):
    """The reference's command line; returns the final params.  ``device``
    and ``inject`` (``init_params``, ``agent_params``, ``agent_noise``)
    are passed to ``train``."""
    args = parser().parse_args(argv)
    out = train(resolve_arch(args.arch), args, device=device,
                log=lambda line: print(line, flush=True), **inject)
    return out["params"]


if __name__ == "__main__":
    main()
