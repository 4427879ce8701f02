"""Optimizers (counterpart of ``repro/optim/optimizers.py``), functional
and optax-like, over the port's parameter trees (nested dicts and lists of
tensors)::

    opt = adamw(schedule=constant(1e-4), clip_norm=0.5)
    state = opt.init(params)
    params, state = opt.update(params, grads, state)

* ``sgd``   -- SGD with momentum (the paper trains VGG with SGD).
* ``adamw`` -- decoupled weight decay, folded into the step's delta.

``torch.optim.AdamW`` is not a drop-in: the reference reads the learning
rate from the schedule *before* the step counter increments, corrects the
moments' bias with ``step + 1``, adds ``eps`` outside the square root,
folds the weight decay into the delta and clips by the global norm with
``min(1, max_norm / max(norm, 1e-9))``; all of that is kept here.  The
updates return new tensors and never write the old ones.

The step counter stays on the host: the rate and the bias corrections are
fp32 values computed there and enter the update as scalars, so a step on
the card copies nothing to it and never waits for it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.optim.schedule import constant
from repro_torch.tree import tree_leaves, tree_map, tree_unzip

Params = Any
State = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Params], State]
    update: Callable[[Params, Params, State], Tuple[Params, State]]


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm


# =============================================================================
def sgd(schedule=None, momentum: float = 0.9, weight_decay: float = 0.0,
        clip_norm: float = 0.0) -> Optimizer:
    schedule = schedule or constant(0.01)

    def init(params):
        return {"step": torch.zeros((), dtype=torch.int32),
                "mom": tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params)}

    def update(params, grads, state):
        if clip_norm > 0:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        lr = float(schedule(state["step"]))

        def upd(p, g, m):
            g32 = g.to(torch.float32)
            if weight_decay:
                g32 = g32 + weight_decay * p.to(torch.float32)
            m_new = momentum * m + g32
            return (p.to(torch.float32) - lr * m_new).to(p.dtype), m_new

        out = tree_map(upd, params, grads, state["mom"])
        return tree_unzip(out, 0), {"step": state["step"] + 1,
                                    "mom": tree_unzip(out, 1)}

    return Optimizer("sgd", init, update)


# =============================================================================
def adamw(schedule=None, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          clip_norm: float = 1.0) -> Optimizer:
    schedule = schedule or constant(1e-4)

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"step": torch.zeros((), dtype=torch.int32),
                "m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(params, grads, state):
        if clip_norm > 0:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state["step"] + 1
        lr = float(schedule(state["step"]))
        bc1 = float(1 - b1 ** step.to(torch.float32))
        bc2 = float(1 - b2 ** step.to(torch.float32))

        def upd(p, g, m, v):
            g32 = g.to(torch.float32)
            m_new = b1 * m + (1 - b1) * g32
            v_new = b2 * v + (1 - b2) * torch.square(g32)
            mhat = m_new / bc1
            vhat = v_new / bc2
            delta = lr * (mhat / (torch.sqrt(vhat) + eps)
                              + weight_decay * p.to(torch.float32))
            return (p.to(torch.float32) - delta).to(p.dtype), m_new, v_new

        out = tree_map(upd, params, grads, state["m"], state["v"])
        return tree_unzip(out, 0), {"step": step, "m": tree_unzip(out, 1),
                                    "v": tree_unzip(out, 2)}

    return Optimizer("adamw", init, update)

