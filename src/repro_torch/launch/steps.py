"""Step builders: train / prefill / decode, plus the FedAdapt multi-pod
local-SGD pair (local_step + FedAvg sync_step) (counterpart of
``repro/launch/steps.py``).

The steps are plain functions over the port's param trees.  On ``meta``
stand-ins (``abstract_params``, ``launch/inputs.py``) a step propagates
shapes and dtypes through the real code path, allocating nothing and
launching no kernel (the kernels' wrappers take their plain versions on
``meta``): the dry runs' counterpart of lowering with
``ShapeDtypeStruct`` inputs.  The reference's ``unroll`` unrolls its
layer scans at trace time; the port's layer loops are eager Python, so
there is nothing to unroll and the argument is accepted and ignored (as
the sequential engine ignores ``mesh``).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import api
from repro_torch.optim.optimizers import Optimizer, make_optimizer
from repro_torch.parallel.sharding import (
    AxisRules,
    is_spec,
    map_with_path,
    param_pspecs,
    path_leaves,
    record_collective,
    settled_sums,
    shard_like,
)
from repro_torch.tree import tree_leaves, tree_map

Params = Any
META = torch.device("meta")


# =============================================================================
# abstract shapes
# =============================================================================
def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16) -> Params:
    return api.init(cfg, 0, dtype, device=META)


def abstract_opt_state(opt: Optimizer, params_shapes: Params) -> Params:
    """``opt.init`` over stand-ins, every leaf a ``meta`` tensor (the step
    counter, which ``init`` puts on the host, too)."""
    return tree_map(lambda t: t.to(META), opt.init(params_shapes))


def opt_pspecs(opt_state_shapes: Params, params_shapes: Params,
               param_specs: Params, rules: AxisRules) -> Params:
    """Optimizer-state specs.

    m/v/mom mirror the parameter specs; adafactor's factored stats drop the
    reduced axis from the corresponding param spec (vr: last, vc: -2).
    Keys are the ``/``-joined paths of the reference's
    ``tree_flatten_with_path``."""
    flat_params = path_leaves(param_specs, is_leaf=is_spec)

    def one(path: str, leaf) -> tuple:
        keys = path.split("/")
        nd = len(leaf.shape)
        if keys[-1] in ("vr", "vc"):
            pkey = "/".join(keys[1:-1])   # strip leading 'stats' + trailing
            base = flat_params.get(pkey, (None,) * (nd + 1))
            parts = list(base) + [None] * (nd + 1 - len(base))
            del parts[-1 if keys[-1] == "vr" else -2]
            return tuple(parts[:nd])
        if keys[0] in ("m", "v", "mom"):
            parts = list(flat_params.get("/".join(keys[1:]), ()))[:nd]
            return tuple(parts + [None] * (nd - len(parts)))
        return (None,) * nd               # step, scalars

    return map_with_path(one, opt_state_shapes)


def model_param_pspecs(cfg: ModelConfig, params_shapes: Params,
                       rules: AxisRules) -> Params:
    return param_pspecs(params_shapes, rules)


def make_opt(cfg: ModelConfig) -> Optimizer:
    return make_optimizer(cfg.optimizer)


# =============================================================================
# steps
# =============================================================================
def make_train_step(cfg: ModelConfig, opt: Optimizer, unroll: bool = False):
    """``train_step(params, opt_state, batch) -> (loss, params,
    opt_state)``: ``torch.func.grad_and_value`` of ``api.loss``, then
    ``opt.update`` (the gradients pinned to their parameters' layouts
    under a step analysis, ``shard_like``).  Each layer and CE chunk is
    rematerialised under the transform as under plain autograd
    (``layers.remat``), also when the step is vmapped over pods.
    ``unroll`` is ignored."""

    def train_step(params, opt_state, batch):
        grads, loss = torch.func.grad_and_value(
            lambda p: api.loss(cfg, p, batch))(params)
        params, opt_state = opt.update(params, shard_like(grads, params),
                                       opt_state)
        return loss, params, opt_state
    return train_step


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig,
                      unroll: bool = False):
    """``prefill_step(params, batch) -> (logits, cache)`` with a cache of
    ``shape.seq_len`` positions.  ``unroll`` is ignored."""

    def prefill_step(params, batch):
        return api.prefill(cfg, params, batch, target_seq=shape.seq_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig, unroll: bool = False):
    """``serve_step(params, cache, token, pos) -> (logits, cache)``.
    ``unroll`` is ignored."""

    def serve_step(params, cache, token, pos):
        return api.decode(cfg, params, cache, token, pos)
    return serve_step


# =============================================================================
# FedAdapt multi-pod pattern: per-pod local steps + infrequent FedAvg sync
# =============================================================================
def make_local_sync_steps(cfg: ModelConfig, opt: Optimizer, num_pods: int):
    """Per-pod divergent replicas: every param/opt leaf has a leading
    ``(num_pods,)`` dim (the ``pod`` mesh axis); ``local_step`` vmaps the
    train step over it (``torch.func.vmap``: the pods are independent, and
    the flash kernels' ``vmap`` rules fold them into the batch, one launch
    a layer for all pods), and ``sync_step`` is the only cross-pod
    communication: a FedAvg mean over the pod dim, in fp32, broadcast back
    (counted as one ``all-reduce`` of the fp32 mean's bytes under
    ``parallel.sharding.count_collectives``, and under a step analysis as
    one over ``pod`` of a place's fp32 share, the mean's own sum settled
    by it).  This is the paper's FL structure mapped onto pods: cross-pod
    traffic drops from every-step gradient all-reduce to 2 x model_bytes /
    sync_every.

    The stacked step counter is moved onto the params' device: under
    ``vmap`` it is a ``(num_pods,)`` tensor, and the bias corrections it
    gives meet the params there (a 0-d host scalar would not be one)."""
    base = make_train_step(cfg, opt)

    def local_step(params_pods, opt_pods, batch):
        dev = tree_leaves(params_pods)[0].device
        if "step" in opt_pods and opt_pods["step"].device != dev:
            opt_pods = {**opt_pods, "step": opt_pods["step"].to(dev)}
        return torch.func.vmap(base)(params_pods, opt_pods, batch)

    def sync_step(params_pods):
        with settled_sums():
            out = tree_map(lambda x: torch.mean(x.float(), dim=0,
                                                keepdim=True)
                           .to(x.dtype).expand(x.shape).contiguous(),
                           params_pods)
        leaves = tree_leaves(params_pods)
        record_collective(
            "all-reduce", sum(4 * x[0].numel() for x in leaves), ("pod",),
            lambda an: sum(an.local_bytes(x) * 4 / x.element_size()
                           for x in leaves))
        return out

    return local_step, sync_step


def stack_for_pods(shapes: Params, num_pods: int) -> Params:
    """Each stand-in with a leading ``(num_pods,)`` dim, on ``meta``."""
    return tree_map(lambda l: torch.empty((num_pods,) + tuple(l.shape),
                                          dtype=l.dtype, device=META),
                    shapes)


def pod_pspecs(specs: Params, num_pods: int) -> Params:
    return map_with_path(lambda _, s: ("pod",) + tuple(s), specs,
                         is_leaf=is_spec)


# =============================================================================
# the vmapped steps' audit: no param repeated per row
# =============================================================================
_COPIES = (torch.ops.aten.clone, torch.ops.aten.copy_,
           torch.ops.aten._to_copy)


def _storage_id(t: torch.Tensor) -> int:
    """The storage a tensor views (its identity, so ``meta`` tensors,
    whose storages have no address, are told apart too)."""
    return t.untyped_storage()._cdata


class ParamCopyRecorder(TorchDispatchMode):
    """Records, inside the block, every copy of a param repeated per row:
    a copying op (``clone``, ``copy_``, ``_to_copy``; a ``contiguous``
    that copies reaches the dispatcher as a ``clone``) that reads a view
    of one of ``params``' leaves' storage and returns more elements than
    that leaf holds.  Under ``vmap`` of a step over pods or clients it is
    a per-pod (per-client) leaf broadcast over the batch rows and
    materialised, as matmul's broadcast path does with a batched 2-D
    operand.  The rule is provenance (the storage), not shape: an
    activation may have a param's shape.  ``params`` is the tree the
    vmapped step takes (the pods' or the clients' stacked leaves).
    ``copies`` lists ``(op, path, source shape, output shape)``."""

    def __init__(self, params: Params):
        super().__init__()
        self._leaves = {_storage_id(t): (path, t.numel()) for path, t in
                        path_leaves(params).items()
                        if isinstance(t, torch.Tensor)}
        self.copies: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in _COPIES:
            src = args[1] if func.overloadpacket is torch.ops.aten.copy_ \
                else args[0]
            hit = (self._leaves.get(_storage_id(src))
                   if isinstance(src, torch.Tensor) else None)
            if hit is not None and out.numel() > hit[1]:
                self.copies.append((str(func), hit[0], tuple(src.shape),
                                    tuple(out.shape)))
        return out
