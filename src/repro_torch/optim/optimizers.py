"""Optimizers (counterpart of ``repro/optim/optimizers.py``), functional
and optax-like, over the port's parameter trees (nested dicts and lists of
tensors)::

    opt = adamw(schedule=constant(1e-4), clip_norm=0.5)
    state = opt.init(params)
    params, state = opt.update(params, grads, state)

* ``sgd``       -- SGD with momentum (the paper trains VGG with SGD).
* ``adamw``     -- decoupled weight decay, folded into the step's delta.
* ``adafactor`` -- factored second moments (row and column means over the
  last two axes of every leaf of 2 or more dims, leading stacked-layer
  axes kept); the mixtral and arctic configs name it.

``make_optimizer(name, schedule, **kw)`` picks one by name.

``torch.optim.AdamW`` is not a drop-in: the reference reads the learning
rate from the schedule *before* the step counter increments, corrects the
moments' bias with ``step + 1``, adds ``eps`` outside the square root,
folds the weight decay into the delta and clips by the global norm with
``min(1, max_norm / max(norm, 1e-9))``; all of that is kept here.  The
updates return new tensors and never write the old ones.

The step counter stays on the host: the rate and the bias corrections are
0-d fp32 tensors computed there and enter the update as CPU scalars (the
same fp32 values a Python float of them would give), so a step on the card
copies nothing to it and never waits for it.  They are never read back
with ``float()``, which neither a ``meta`` tensor (the dry runs) nor
``torch.func.vmap`` (the pods' local step, whose stacked counter lies with
the params) allows.
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
        lr = schedule(state["step"])

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
        lr = schedule(state["step"])
        bc1 = 1 - b1 ** step.to(torch.float32)
        bc2 = 1 - b2 ** step.to(torch.float32)

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



# =============================================================================
def adafactor(schedule=None, eps: float = 1e-30, clip_threshold: float = 1.0,
              decay_pow: float = 0.8, min_dim_factored: int = 2,
              weight_decay: float = 0.0) -> Optimizer:
    """Shazeer & Stern (2018): a leaf of ``min_dim_factored`` or more dims
    keeps a row vector ``vr`` (its shape without the last axis) and a column
    vector ``vc`` (without the second-to-last) of second moments, a smaller
    leaf a full ``v``; ``beta2 = 1 - step ** -decay_pow``; each leaf's update
    is clipped to RMS ``clip_threshold``.  No first moment."""
    schedule = schedule or constant(1e-2)

    def _factored(p):
        return p.dim() >= min_dim_factored

    def init(params):
        def stat(p):
            def zeros(shape):
                return torch.zeros(shape, dtype=torch.float32,
                                   device=p.device)
            if _factored(p):
                return {"vr": zeros(p.shape[:-1]),
                        "vc": zeros(p.shape[:-2] + p.shape[-1:])}
            return {"v": zeros(p.shape)}
        return {"step": torch.zeros((), dtype=torch.int32),
                "stats": tree_map(stat, params)}

    def update(params, grads, state):
        step = state["step"] + 1
        lr = schedule(state["step"])
        beta2 = 1.0 - step.to(torch.float32) ** -decay_pow

        def upd(p, g, s):
            g32 = g.to(torch.float32)
            g2 = torch.square(g32) + eps
            if _factored(p):
                vr = beta2 * s["vr"] + (1 - beta2) * g2.mean(dim=-1)
                vc = beta2 * s["vc"] + (1 - beta2) * g2.mean(dim=-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(dim=-1)[..., None, None],
                                       min=eps))
                u = g32 / torch.sqrt(torch.clamp(denom, min=eps))
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta2 * s["v"] + (1 - beta2) * g2
                u = g32 / torch.sqrt(torch.clamp(v, min=eps))
                new_s = {"v": v}
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                u = u + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * u).to(p.dtype), new_s

        out = tree_map(upd, params, grads, state["stats"])
        return tree_unzip(out, 0), {"step": step,
                                    "stats": tree_unzip(out, 1)}

    return Optimizer("adafactor", init, update)


# =============================================================================
def make_optimizer(name: str, schedule=None, **kw) -> Optimizer:
    table = {"sgd": sgd, "adamw": adamw, "adafactor": adafactor}
    return table[name](schedule=schedule, **kw)
