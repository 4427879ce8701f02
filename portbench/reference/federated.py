"""The federated rounds in plain PyTorch: what ``run_federated`` computes
with the sequential engine and the fused server step, written again.

A round: each client in turn copies the global weights, draws its
batches (the port's loader rule: client ``k``'s rows in the order of
``RandomState(loader_seed + k + epoch).permutation``), and takes
``local_steps`` SGD steps ``p - lr * g`` of the loss through the cut;
its delta against the global goes through the wire (top-k with error
feedback, int8, as the deployment states) and adds into the weighted sum
in client order, the weights the clients' row counts normalised in
float64 and cast to fp32; the global moves by the sum; the eval is the
negative loss over the whole test set with no cut.

``fault`` plants one of the faults the check must catch, for the
readings that set its limits: ``"unchanged"`` (no step moves the
weights), ``"half_batch"`` (the loss's mean over half of each batch:
half its rows, or half its positions for one row) and ``"token"`` (one
label of each batch altered where the batch is made).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference import common as C
from portbench.reference import wire

FAULTS = ("unchanged", "half_batch", "token")


def leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def norms(tree: C.Tree) -> Dict[str, float]:
    """Each leaf's L2 norm, accumulated in float64, by path."""
    return {path: float(torch.linalg.vector_norm(t, dtype=torch.float64))
            for path, t in C.leaf_paths(tree)}


def _batches(rows: Dict[str, np.ndarray], seed: int, batch: int):
    """Client rows in the port's loader order: ``batch`` rows a draw,
    a fresh permutation each epoch."""
    n, epoch = len(rows["labels"]), 0
    while True:
        perm = np.random.RandomState(seed + epoch).permutation(n)
        for c in range(0, n - batch + 1, batch):
            idx = perm[c:c + batch]
            yield rows["tokens"][idx], rows["labels"][idx]
        epoch += 1


def _faulty_labels(labels: torch.Tensor, fault: Optional[str]
                   ) -> torch.Tensor:
    """The labels the loss reads: under ``"half_batch"`` half the rows
    (half the positions of one row) marked ignored."""
    if fault == "half_batch":
        labels = labels.clone()
        if labels.shape[0] > 1:
            labels[labels.shape[0] // 2:] = -1
        else:
            labels[:, labels.shape[1] // 2:] = -1
    return labels


def run(fam, cfg: dict, deployment: dict, traffic: dict, params: C.Tree,
        clients: List[Dict[str, np.ndarray]], test: Dict[str, np.ndarray],
        loader_seed: int, rounds: int, fault: Optional[str] = None
        ) -> dict:
    """``rounds`` rounds from ``params`` (the port's layout; not
    modified).  Returns each local step's loss and its rows (round,
    client, step order), each round's eval, each leaf's norm of round 0's
    update and of the whole change, by path."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    device = C.leaf_paths(params)[0][1].device
    L, V = cfg["num_layers"], cfg["vocab_size"]
    op = int(deployment["static_op"])
    quant_cut = bool(deployment["quantize_transfer"])
    density = float(deployment["delta_density"])
    quant_wire = bool(deployment["quantize_deltas"])
    rows = int(traffic["rows_per_step"])
    lr = torch.tensor(float(deployment["lr"]), dtype=torch.float32,
                      device=device)
    K = len(clients)
    sizes = np.asarray([len(c["labels"]) for c in clients], np.float64)
    w = torch.as_tensor(sizes / sizes.sum(), dtype=torch.float32,
                        device=device)
    draws = [_batches(c, loader_seed + k, rows) for k, c in
             enumerate(clients)]
    start = C.tree_map(lambda t: t.detach().clone(), params)
    g = C.tree_map(lambda t: t.detach().clone(), params)
    paths = [p for p, _ in C.leaf_paths(g)]
    errors = ({p: [None] * K for p in paths} if density < 1.0 else None)
    test_tok = torch.from_numpy(test["tokens"]).to(device)
    test_lab = torch.from_numpy(test["labels"]).to(device)
    losses, batches, evals, update0 = [], [], [], None
    for r in range(rounds):
        acc = {p: None for p in paths}
        for k in range(K):
            p = C.unstack(g, L, lambda t: t.detach().clone()
                          .requires_grad_())
            trained = leaves(p)
            for _ in range(int(traffic["local_steps"])):
                tok, lab = next(draws[k])
                if fault == "token":
                    lab = lab.copy()
                    lab[0, 0] = (lab[0, 0] + 1) % V
                batches.append((tok, lab))
                lab = _faulty_labels(torch.from_numpy(lab).to(device),
                                     fault)
                loss = fam.loss(cfg, p, torch.from_numpy(tok).to(device),
                                lab, op, quant_cut)
                grads = torch.autograd.grad(loss, trained)
                losses.append(loss.detach())
                if fault != "unchanged":
                    with torch.no_grad():
                        for t, gr in zip(trained, grads):
                            t.sub_(lr * gr)
                del grads, loss
            client = dict(C.leaf_paths(C.restack(
                C.tree_map(lambda t: t.detach(), p))))
            del p, trained
            for path, gl in C.leaf_paths(g):
                err = errors[path][k] if errors is not None else None
                if errors is not None and err is None:
                    err = torch.zeros_like(wire.blocks(gl.reshape(-1)))
                sent, new_err = wire.send(client[path] - gl, err, density,
                                          quant_wire)
                if errors is not None:
                    errors[path][k] = new_err
                term = w[k] * sent
                acc[path] = term if acc[path] is None else acc[path] + term
            del client
        flat = dict(C.leaf_paths(g))
        new = C.nest({path: flat[path] + acc[path].view(-1)[:t.numel()]
                      .view(t.shape) for path, t in flat.items()})
        if r == 0:
            update0 = norms(C.tree_map(lambda a, b: a - b, new, g))
        g = new
        del acc, flat, new
        with torch.no_grad():
            evals.append(-float(fam.loss(cfg, g, test_tok, test_lab, L,
                                         False)))
    change = norms(C.tree_map(lambda a, b: a - b, g, start))
    return {"losses": [float(x) for x in losses], "batches": batches,
            "evals": evals,
            "update0": update0, "change": change}
