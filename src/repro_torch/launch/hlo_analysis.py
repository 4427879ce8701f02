"""Per-place analysis of one step under a mesh's specs (counterpart of
``repro/launch/hlo_analysis.py``).

There is no HLO here.  The reference reads XLA's per-device SPMD module
after compiling a step; the port runs a step eagerly, so what this module
analyses is the step's aten ops, seen once in one evaluation of the step
under a ``TorchDispatchMode`` (``StepAnalysis``).  Every tensor carries a
*layout*: the mesh axes each dim is split over (a spec, as
``parallel.sharding`` writes them) and the axes it is a partial sum over.
Layouts come from the step's argument specs, from ``shard`` (the
activation pins of ``parallel.sharding.shard``) and from a rule for each
aten op (``_RULES``, ``_pointwise``); an op with no rule raises and names
the op.  The reference's function names and keys are kept: ``cost_stats``
(``flops``, ``bytes_accessed``, ``transcendentals``), ``memory_stats`` (the
five ``*_in_bytes``) and ``collective_stats`` (``_COLLECTIVES`` plus
``total``, each ``bytes`` and ``count``), all per place.

Collectives.  Where an operand's layout is not the one its op's rule takes,
the analysis counts the redistribution an SPMD partitioner inserts
(``_conform``), once per place with the bytes of its per-place output:

* partial to replicated over an axis: ``all-reduce``; partial to split
  along a dim over that axis: ``reduce-scatter``;
* a dim's axis that the target puts on another dim: ``all-to-all``;
* a dim's axis the target drops: ``all-gather``;
* an axis the target adds to a dim the operand holds whole: a local slice,
  no collective.

Among candidate redistributions (a matmul's, an index's: which operand
dims to gather) the rule takes the one that moves the fewest bytes; on a
tie, the one with the fewest local FLOPs, then the first in a fixed order
(the operands' dims gathered in increasing number, the first operand's
before the second's).  XLA's choices are not reproduced op for op: its
partitioner propagates shardings over the whole program, and inserts
``collective-permute`` (halo exchanges, shifted slices) and ``all-to-all``
(its MoE dispatch, resharded reshapes) where this analysis gathers, and
tiles a dim over part of an axis (8 KV heads over 16 places, as 8 x 2)
where this analysis cannot name such a split and gathers.

Cost, per place, on the local shapes: a matmul ``2 M N K``
(``matmul_flops`` besides); an elementwise op one FLOP a local output
element (``_ELEMENT``: a few a element for the composite activations) and a
reduction one an input element, as XLA's cost analysis counts them; the
transcendentals (``exp``, ``log``, ``tanh``, ``sigmoid``, ``rsqrt``,
``sqrt``, ``erf``, ``sin``, ``cos``, a non-integer ``pow``) one a local
element, and no FLOP; data movement (copies, converts, gathers, scatters,
sorts, creation) no FLOP.  ``bytes_accessed`` is each op's local input and
output bytes, the eager program's traffic (XLA's fused program moves
less); views count nothing, collectives count in ``collective_stats`` only.

Memory, per place: ``argument`` and ``output`` bytes are the step's
arguments and outputs under their specs; ``alias`` the donated leaves
(the caller names them: params and optimizer state for a train step, the
cache for decode); ``temp`` the high-water mark of the live bytes of
every storage the step creates (its outputs included), each tracked from
its creation to its release, plus an op's redistributed operands while it
runs; ``peak`` arguments plus temp.

The hand-written kernels.  Each kernel wrapper records its function's
written count (``kernels.flash_attention.flash_attention_work`` and its
siblings) through ``kernels.counted``, where it counts a launch; the plain
versions, on ``meta`` and the CPU, record the same count, and their own
aten ops are not counted in its place.  So a step reads the same on
``meta``, on the CPU and on the card.  A kernel's count is evaluated on
its operands' local shapes after ``_KERNEL_LAYOUTS`` conforms them (batch
and heads may stay split).  The analysis launches nothing, and raises if
a kernel launches without a recorded count.

The expert-parallel MoE (``models.layers._moe_block_sharded``) hands its
``shard_map`` body to ``shard_map_one_place`` under an analysis: the body
of one place, its ops counted at their local shapes and its gathers and
sums (and their transposes) once each, as one device's program reads
them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.parallel import sharding as SH

Axes = Tuple[str, ...]
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_MEMORY_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
                "alias_size_in_bytes", "temp_size_in_bytes",
                "peak_memory_in_bytes")
_FT = torch._C._functorch


# =============================================================================
# layouts
# =============================================================================
@dataclasses.dataclass(frozen=True)
class Layout:
    """The mesh axes each dim is split over (major first) and the axes
    the tensor is a partial sum over."""
    dims: Tuple[Axes, ...]
    partial: Axes = ()

    @staticmethod
    def replicated(ndim: int) -> "Layout":
        return Layout(((),) * ndim)

    @staticmethod
    def of_spec(spec, ndim: int) -> "Layout":
        """A spec (one entry a dim: None, an axis, a tuple of axes) as a
        layout; a shorter spec leaves the trailing dims whole."""
        dims = [() if e is None else (e,) if isinstance(e, str)
                else tuple(e) for e in tuple(spec)[:ndim]]
        return Layout(tuple(dims) + ((),) * (ndim - len(dims)))

    def used(self) -> set:
        return {a for d in self.dims for a in d} | set(self.partial)

    def with_dims(self, dims) -> "Layout":
        return Layout(tuple(tuple(d) for d in dims), self.partial)


def _n(sizes: Dict[str, int], axes) -> int:
    return math.prod(sizes[a] for a in axes)


# =============================================================================
# the analysis
# =============================================================================
class StepAnalysis(TorchDispatchMode):
    """One step's per-place cost, memory and collectives over a mesh of
    ``sizes`` (``{axis: size}``); enter it around the step (``analyse``
    does it all)."""
    is_step_analysis = True

    def __init__(self, sizes: Dict[str, int]):
        super().__init__()
        self.sizes = dict(sizes)
        self.layouts = WeakTensorKeyDictionary()
        self._fresh = WeakTensorKeyDictionary()
        self.cost = {"flops": 0.0, "bytes_accessed": 0.0,
                     "transcendentals": 0.0, "matmul_flops": 0.0}
        self.coll = {op: {"bytes": 0.0, "count": 0} for op in _COLLECTIVES}
        self.groups: List[Tuple[str, Axes, float, str]] = []
        self.kernels: Dict[str, int] = {}
        self._launched = 0
        self._arg_storages: Dict[int, Any] = {}
        self._live: Dict[int, float] = {}
        self.temp = self.peak_temp = 0.0
        self._quiet = 0
        self._local = 0
        self._settled = 0
        self._op = ""

    def __enter__(self):
        SH.analysis_opened(+1)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            SH.analysis_opened(-1)

    # ---- layouts -----------------------------------------------------------
    def layout(self, t: torch.Tensor) -> Layout:
        if self._local:
            return Layout.replicated(t.dim())
        got = self.layouts.get(t)
        if got is None or len(got.dims) != t.dim():
            return Layout.replicated(t.dim())
        return got

    def set_layout(self, t: torch.Tensor, lay: Layout) -> None:
        self.layouts[t] = Layout.replicated(t.dim()) if self._local else lay

    def local_shape(self, shape, lay: Layout) -> Tuple[int, ...]:
        return tuple(-(-int(s) // _n(self.sizes, a))
                     for s, a in zip(shape, lay.dims))

    def local_bytes(self, t: torch.Tensor, lay: Optional[Layout] = None
                    ) -> float:
        """A place's bytes of ``t`` under ``lay``; a broadcast dim (stride
        0, an ``expand``) holds one element."""
        lay = self.layout(t) if lay is None else lay
        shape = [1 if st == 0 else s
                 for s, st in zip(t.shape, _strides(t))]
        return float(math.prod(self.local_shape(shape, lay))
                     * t.element_size())

    def register_args(self, tree, specs) -> None:
        """Give each tensor of ``tree`` its spec's layout (``specs``: a
        tree of the same paths) and count its storage as an argument."""
        spec_at = SH.path_leaves(specs, is_leaf=SH.is_spec)
        for path, leaf in SH.path_leaves(tree).items():
            if isinstance(leaf, torch.Tensor):
                inner, _ = unwrap(leaf)
                self.layouts[inner] = Layout.of_spec(spec_at[path],
                                                     inner.dim())
                st = inner.untyped_storage()
                self._arg_storages[id(st)] = st

    def place_bytes(self, tree, specs) -> float:
        spec_at = SH.path_leaves(specs, is_leaf=SH.is_spec)
        return sum(self.local_bytes(leaf, Layout.of_spec(spec_at[p],
                                                          leaf.dim()))
                   for p, leaf in SH.path_leaves(tree).items()
                   if isinstance(leaf, torch.Tensor))

    # ---- memory ------------------------------------------------------------
    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live from now until it is freed."""
        self._track(unwrap(t)[0], self.layout(unwrap(t)[0]))

    def lay_out(self, t: torch.Tensor, spec) -> None:
        """A fresh ``t`` (a stand-in a caller made quietly) laid out by
        ``spec`` and counted live."""
        inner = unwrap(t)[0]
        lay = Layout.of_spec(spec, inner.dim())
        self.layouts[inner] = lay
        self._track(inner, lay)

    def conform_to(self, t: torch.Tensor, spec, source: str) -> None:
        """Count what moves ``t`` to ``spec`` (``t``'s layout stays), made
        by ``source``."""
        self._op = source
        inner = unwrap(t)[0]
        self._transient(self._conform(inner, self.layout(inner),
                                      Layout.of_spec(spec, inner.dim())))

    def _track(self, t: torch.Tensor, lay: Layout) -> None:
        if self._quiet:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._arg_storages or key in self._live:
            return
        nbytes = self.local_bytes(t, lay)
        self._live[key] = nbytes
        self.temp += nbytes
        self.peak_temp = max(self.peak_temp, self.temp)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.temp -= self._live.pop(key, 0.0)

    def _transient(self, nbytes: float) -> None:
        self.peak_temp = max(self.peak_temp, self.temp + nbytes)

    # ---- collectives -------------------------------------------------------
    def record(self, op: str, axes, nbytes: float,
               source: Optional[str] = None) -> None:
        """One collective ``op`` over mesh ``axes``, ``nbytes`` its
        per-place output, made by ``source`` (default: the op being
        analysed)."""
        axes = tuple(a for a in axes if self.sizes.get(a, 1) > 1)
        if not axes or self._quiet:
            return
        self.coll[op]["bytes"] += float(nbytes)
        self.coll[op]["count"] += 1
        self.groups.append((op, axes, float(nbytes), source or self._op))

    def _conform(self, t: torch.Tensor, src: Layout, dst: Layout) -> float:
        """Count what moves ``t`` from ``src`` to ``dst``; returns the
        bytes of the redistributed copy (0 when none is made)."""
        if src == dst or self._local:
            return 0.0
        zero = tuple(st == 0 for st in _strides(t))
        steps, moved = _moves(tuple(self.sizes.items()), tuple(t.shape),
                              zero, t.element_size(), src, dst)
        for op, axes, nbytes in steps:
            self.record(op, axes, nbytes)
        return moved

    def _place_fresh(self, t: torch.Tensor, want: Layout) -> None:
        """A fresh tensor (a creation's, or a scatter's into one, counted
        live from its first use) takes the layout of that use when it
        only splits it further (each place makes its own share), and is
        counted live from then on."""
        if self._fresh.pop(t, None) is None:
            return
        lay = self.layout(t)
        if all(set(a) <= set(b) for a, b in zip(lay.dims, want.dims)):
            lay = Layout(want.dims, want.partial)
            self.layouts[t] = lay
        self._track(t, lay)

    def _settle_in(self, t: torch.Tensor, want: Layout) -> float:
        """Conform an operand; a partial sum, once summed, stays summed
        (the partitioner's program reuses the sum), so ``t`` keeps the
        summed layout (its dims as the sum left them, when the op gathers
        nothing of it)."""
        lay = self.layout(t)
        moved = self._conform(t, lay, want)
        if lay.partial and not set(lay.partial) <= set(want.partial):
            kept = {a for d in lay.dims for a in d}
            self.layouts[t] = Layout(want.dims, ()) if kept <= want.used() \
                else Layout(lay.dims, ())
        return moved

    # ---- the counts --------------------------------------------------------
    def _add_cost(self, flops=0.0, nbytes=0.0, trans=0.0, mm=0.0) -> None:
        if self._quiet:
            return
        self.cost["flops"] += flops + mm
        self.cost["matmul_flops"] += mm
        self.cost["bytes_accessed"] += nbytes
        self.cost["transcendentals"] += trans

    # ---- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._quiet:
            return func(*args, **kwargs)
        rule = _rule_for(func)
        if rule is None:
            raise NotImplementedError(
                f"hlo_analysis: no layout rule for {func} (every aten op a "
                f"step dispatches needs one; see _RULES)")
        self._op = _name(func)
        plan = rule(self, func, args, kwargs)
        moved = 0.0
        for t, want in plan.inputs:
            self._place_fresh(t, want)
            moved += self._settle_in(t, want)
        self._transient(moved)
        out = func(*args, **kwargs)
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        lays = plan.outputs(outs) if callable(plan.outputs) else plan.outputs
        out_bytes = 0.0
        for o, lay in zip(outs, lays):
            self.set_layout(o, lay)
            if not plan.view:
                out_bytes += self.local_bytes(o, lay)
                if plan.fresh:
                    self._fresh[o] = True
                elif not plan.inplace:
                    self._track(o, lay)
        if not plan.view:
            in_bytes = sum(self.local_bytes(t, want)
                           for t, want in plan.inputs)
            self._add_cost(plan.flops, in_bytes + out_bytes, plan.trans,
                           plan.mm)
        return out

    def one_op(self, func, args: tuple):
        """``func(*args)`` counted as the one aten op it is, its own
        dispatches quiet: an op that ``torch.func`` decomposes on ``meta``
        alone (``silu_backward`` under ``grad``) reads as it does on the
        CPU and the card."""
        inner = tuple(unwrap(a)[0] if isinstance(a, torch.Tensor) else a
                      for a in args)
        self._op = _name(func)
        plan = _rule_for(func)(self, func, inner, {})
        moved = 0.0
        for t, want in plan.inputs:
            self._place_fresh(t, want)
            moved += self._settle_in(t, want)
        self._transient(moved)
        with self.quiet():
            out = func(*args)
        o = unwrap(out)[0]
        lay = (plan.outputs([o]) if callable(plan.outputs)
               else plan.outputs)[0]
        self.set_layout(o, lay)
        self._track(o, lay)
        self._add_cost(plan.flops, sum(self.local_bytes(t, w)
                                       for t, w in plan.inputs)
                       + self.local_bytes(o, lay), plan.trans, plan.mm)
        return out

    # ---- regions -----------------------------------------------------------
    @contextlib.contextmanager
    def quiet(self):
        """Ops inside count nothing and their layouts are set by the
        caller (a kernel's plain version, a collective's own copy)."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    @contextlib.contextmanager
    def one_place(self):
        """Ops inside are one place's program: their tensors are that
        place's, counted at their own shapes, and move nothing."""
        self._local += 1
        try:
            yield
        finally:
            self._local -= 1

    @contextlib.contextmanager
    def settled(self):
        """Reductions inside leave no partial sum: the caller records the
        collective they need (the FedAvg sync's all-reduce)."""
        self._settled += 1
        try:
            yield
        finally:
            self._settled -= 1

    def pin(self, x: torch.Tensor, spec) -> None:
        """``shard``'s pin: ``x``'s layout becomes ``spec`` (its logical
        dims; a vmapped dim keeps its axes), counting the move."""
        if self._local:
            return
        inner, pos = unwrap(x)
        cur = self.layout(inner)
        want = Layout.of_spec(spec, len(pos))
        if inner in self._fresh:
            self._place_fresh(inner, self._pinned(cur, want, pos))
            return
        target = self._pinned(cur, want, pos)
        self._op = "shard"
        self._transient(self._conform(inner, cur, target))
        self.layouts[inner] = target

    @staticmethod
    def _pinned(cur: Layout, want: Layout, pos) -> Layout:
        """``cur`` with its logical dims (at ``pos``) set to ``want``'s; a
        vmapped dim keeps its axes."""
        dims = [list(d) for d in cur.dims]
        for i, p in enumerate(pos):
            dims[p] = list(want.dims[i])
        batch = {a for i, d in enumerate(cur.dims) if i not in pos for a in d}
        for p in pos:
            dims[p] = [a for a in dims[p] if a not in batch]
        return Layout(tuple(tuple(d) for d in dims))

    def pin_like(self, x: torch.Tensor, like: torch.Tensor) -> None:
        """``x``'s layout pinned to ``like``'s (same physical shape)."""
        inner, inner_like = unwrap(x)[0], unwrap(like)[0]
        if inner.shape != inner_like.shape:
            raise ValueError(f"hlo_analysis: pin_like of {tuple(inner.shape)} "
                             f"to {tuple(inner_like.shape)}")
        self._op = "shard"
        target = Layout(self.layout(inner_like).dims)
        self._place_fresh(inner, target)
        self._transient(self._conform(inner, self.layout(inner), target))
        self.layouts[inner] = target

    def kernel(self, name: str, work: Callable, inputs: Sequence,
               run: Callable):
        """One hand-written kernel's call: its operands conformed to the
        layouts ``_KERNEL_LAYOUTS[name]`` takes, ``work`` (its written
        count) evaluated at their local shapes, ``run`` (the launch or
        the plain version) quiet, its outputs laid out by the same rule."""
        from repro_torch.kernels import LAUNCHES
        self._op = name
        inner = [None if t is None else unwrap(t)[0] for t in inputs]
        lays = [None if t is None else self.layout(t) for t in inner]
        want_in, want_out = _KERNEL_LAYOUTS[name](self, inner, lays)
        moved = 0.0
        for t, lay, want in zip(inner, lays, want_in):
            if t is not None:
                self._place_fresh(t, want)
                moved += self._conform(t, self.layout(t), want)
        self._transient(moved)
        shapes = [None if t is None else self.local_shape(t.shape, w)
                  for t, w in zip(inner, want_in)]
        w = work(*shapes)
        self._add_cost(w["flops"] - w.get("matmul_flops", 0.0),
                       w["bytes_accessed"], w["transcendentals"],
                       w.get("matmul_flops", 0.0))
        self.kernels[name] = self.kernels.get(name, 0) + 1
        before = sum(LAUNCHES.values())
        with self.quiet():
            out = run()
        self._launched += sum(LAUNCHES.values()) - before
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        for o, lay in zip(outs, want_out):
            o = unwrap(o)[0]
            self.set_layout(o, lay)
            self._track(o, lay)
        return out

    def shard_map_one_place(self, body: Callable, operands: Sequence,
                            in_specs: Sequence, blocks: Callable,
                            gathers: Sequence, psum_axis: str,
                            source: str):
        """A ``shard_map`` body (the expert-parallel MoE's,
        ``models.layers._moe_block_sharded``) as one device's program:
        ``operands`` (x, then the weights) laid out by the reference's
        ``in_specs``; place 0's blocks of them (``blocks(*operands)``),
        each weight with a ``gathers`` entry ``(dim, mesh axis)`` gathered
        along it (one all-gather; its transpose one reduce-scatter);
        ``body(x_block, weights)`` counted at its own shapes
        (``one_place``); its partial output summed over ``psum_axis`` (one
        all-reduce; its transpose one more); and in the backward an
        all-reduce of each operand's cotangent over the axes its spec
        leaves out (the ``shard_map`` transpose).  Each collective counts
        once, made by ``source``.  On ``meta`` stand-ins only: the other
        places' parts are not computed, so the output is a stand-in laid
        out as x."""
        if operands[0].device.type != "meta":
            raise NotImplementedError(f"{source} under a step analysis runs "
                                      f"one place's body: meta stand-ins "
                                      f"only")

        def one(xb, held):
            w = [h if g is None else
                 _GatherOnePlace.apply(h, g[0], self.sizes[g[1]], g[1],
                                       self, source)
                 for h, g in zip(held, gathers)]
            part = body(xb, w)
            self.record("all-reduce", (psum_axis,), self.local_bytes(part),
                        source)
            return part

        def stand_in(t, spec):
            with self.quiet():
                out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
            self.lay_out(out, spec)
            return out

        def run(ops, g):
            for t, spec in zip(ops, in_specs):
                self.conform_to(t, spec, source)
            with self.one_place():
                xb, *held = blocks(*ops)
                if g is None:
                    one(xb, held)
                    return stand_in(ops[0], in_specs[0])
                with self.quiet():
                    leaves = [torch.empty(t.shape, dtype=t.dtype,
                                          device=t.device)
                              for t in [xb] + held]
                    with torch.enable_grad():
                        part, vjp_fn = torch.func.vjp(one, leaves[0],
                                                      leaves[1:])
                    gl = torch.empty(part.shape, dtype=part.dtype,
                                     device=part.device)
                self.record("all-reduce", (psum_axis,), self.local_bytes(gl),
                            source)
                dxb, dheld = vjp_fn(gl)
                for t, spec in zip([dxb] + list(dheld), in_specs):
                    named = {a for e in spec if e
                             for a in ((e,) if isinstance(e, str) else e)}
                    self.record("all-reduce", [a for a in self.sizes
                                               if a not in named],
                                self.local_bytes(t), source)
            return [stand_in(t, spec) for t, spec in zip(ops, in_specs)]

        return _OnePlace.apply(run, *operands)

    # ---- reports -----------------------------------------------------------
    def cost_stats(self) -> Dict[str, float]:
        return dict(self.cost)

    def collective_stats(self) -> Dict[str, Dict[str, float]]:
        out = {op: dict(v) for op, v in self.coll.items()}
        out["total"] = {"bytes": sum(v["bytes"] for v in self.coll.values()),
                        "count": sum(v["count"] for v in self.coll.values())}
        return out


@functools.lru_cache(maxsize=1 << 16)
def _moves(sizes, shape, zero, item, src: Layout, dst: Layout):
    """The collectives that move a tensor of ``shape`` (``zero``: its
    broadcast dims) from ``src`` to ``dst`` over a mesh of ``sizes``, each
    ``(op, axes, bytes of its per-place output)``, and the bytes of the
    redistributed copy."""
    sizes = dict(sizes)
    held = [1 if z else s for s, z in zip(shape, zero)]

    def size(dims):
        return float(math.prod(-(-s // _n(sizes, d))
                               for s, d in zip(held, dims)) * item)
    dims = [list(d) for d in src.dims]
    dst_at = {a: i for i, d in enumerate(dst.dims) for a in d}
    steps, moved = [], 0.0
    # 1. partial sums: scattered onto the dim the target splits over the
    # axis (when the operand holds that dim whole over it), else summed
    scatter, reduce = [], []
    for a in src.partial:
        if a in dst.partial:
            continue
        i = dst_at.get(a)
        if i is not None and not any(a in d for d in dims):
            scatter.append((a, i))
        else:
            reduce.append(a)
    if reduce:
        moved = size(dims)
        steps.append(("all-reduce", tuple(reduce), moved))
    if scatter:
        for a, i in scatter:
            dims[i].append(a)
        moved = size(dims)
        steps.append(("reduce-scatter", tuple(a for a, _ in scatter),
                      moved))
    # 2. axes that change dims (to a broadcast dim, which slices for free:
    # a gather), 3. axes the target drops
    gone, to_move = [], []
    for i, d in enumerate(dims):
        for a in list(d):
            j = dst_at.get(a)
            if j == i:
                continue
            d.remove(a)
            if j is None or zero[j]:
                gone.append(a)
            else:
                dims[j].append(a)
                to_move.append(a)
    if to_move:
        moved = size(dims)
        steps.append(("all-to-all", tuple(to_move), moved))
    if gone:
        moved = size(dims)
        steps.append(("all-gather", tuple(gone), moved))
    return tuple(steps), moved


def _strides(t: torch.Tensor) -> Tuple[int, ...]:
    try:
        return t.stride()
    except RuntimeError:          # a tensor without strides (sparse)
        return (1,) * t.dim()


def unwrap(t: torch.Tensor) -> Tuple[torch.Tensor, List[int]]:
    """The plain tensor under ``t``'s functorch wrappers, and where each
    of ``t``'s dims lies in it (a vmap level inserts its batch dim)."""
    pos = list(range(t.dim()))
    while _FT.is_functorch_wrapped_tensor(t):
        if _FT.is_batchedtensor(t):
            b = _FT.maybe_get_bdim(t)
            pos = [p if p < b else p + 1 for p in pos]
        t = _FT.get_unwrapped(t)
    return t, pos


# =============================================================================
# op rules
# =============================================================================
@dataclasses.dataclass
class Plan:
    """What an op's rule decides: each tensor operand's layout, the
    outputs' (a list, or a function of the outputs), the cost."""
    inputs: List[Tuple[torch.Tensor, Layout]]
    outputs: Any
    flops: float = 0.0
    trans: float = 0.0
    mm: float = 0.0
    view: bool = False
    inplace: bool = False
    fresh: bool = False


def _tensors(args, kwargs) -> List[torch.Tensor]:
    return [t for t in tree_flatten((args, kwargs))[0]
            if isinstance(t, torch.Tensor)]


def _name(func) -> str:
    return func.overloadpacket.__name__


def _inplace(func) -> bool:
    a = func._schema.arguments
    return bool(a) and a[0].alias_info is not None and a[0].alias_info.is_write


def _numel(an: StepAnalysis, shape, lay: Layout) -> int:
    return math.prod(an.local_shape(shape, lay))


def _dim(d: int, nd: int) -> int:
    return d + nd if d < 0 else d


def _dedup(dims: List[List[str]]) -> List[List[str]]:
    """Each axis on its first dim only."""
    seen = set()
    out = []
    for d in dims:
        out.append([a for a in d if not (a in seen or seen.add(a))])
    return out


def _broadcast(*shapes) -> Tuple[int, ...]:
    """The broadcast of ``shapes`` (ints; a plain function, faster than
    ``torch.broadcast_shapes`` in the hot path)."""
    nd = max((len(s) for s in shapes), default=0)
    out = [1] * nd
    for s in shapes:
        for i, d in enumerate(s, nd - len(s)):
            if d != 1:
                out[i] = int(d)
    return tuple(out)


def _project(lay_dims, out_shape, shape) -> Layout:
    """The broadcast operand of ``shape``'s share of an output layout."""
    off = len(out_shape) - len(shape)
    return Layout(tuple(() if s == 1 else tuple(lay_dims[off + i])
                        for i, s in enumerate(shape)))


# -- elementwise ------------------------------------------------------------
# (FLOPs, transcendentals) a local output element where not (1, 0)
_TRANSCENDENTAL = {"exp", "log", "tanh", "sigmoid", "rsqrt", "sqrt", "erf",
                   "sin", "cos", "log1p", "expm1"}
_ELEMENT = {"gelu": (7, 1), "gelu_backward": (12, 1), "silu": (2, 1),
            "silu_backward": (5, 1), "sigmoid_backward": (2, 0),
            "tanh_backward": (2, 0), "logaddexp": (3, 2),
            "nan_to_num": (3, 0)}
_MOVES = {"_to_copy", "clone", "copy_", "fill_", "copy", "lift_fresh",
          "zeros_like", "ones_like", "empty_like", "full_like", "tril"}
# linear in every tensor operand together (partial sums pass when all
# share them), in one operand (the others not partial), in the first
_LINEAR_ALL = {"add", "sub", "add_", "sub_", "_to_copy", "clone", "copy_",
               "neg", "alias", "lift_fresh", "tril"}
_LINEAR_ONE = {"mul"}
_LINEAR_FIRST = {"div", "silu_backward", "gelu_backward",
                 "sigmoid_backward", "tanh_backward"}


def _element_cost(name: str, transcendental_pow: bool, n: int
                  ) -> Tuple[float, float]:
    if name in _MOVES:
        return 0.0, 0.0
    if name in _TRANSCENDENTAL or (name == "pow" and transcendental_pow):
        return 0.0, float(n)
    f, t = _ELEMENT.get(name, (1, 0))
    return float(f * n), float(t * n)


def _transcendental_pow(func, args) -> bool:
    """A ``pow`` with a tensor or non-integer exponent, or a scalar base
    (``pow.Scalar``)."""
    if _name(func) != "pow":
        return False
    ex = args[1] if len(args) > 1 else None
    return (isinstance(ex, torch.Tensor) or isinstance(args[0], (int, float))
            or (isinstance(ex, float) and not float(ex).is_integer()))


def _pointwise(an: StepAnalysis, func, args, kwargs) -> Plan:
    ts = _tensors(args, kwargs)
    wants, out_lay, flops, trans = _pointwise_plan(
        tuple(an.sizes.items()), _name(func), _inplace(func),
        tuple((tuple(t.shape), an.layout(t)) for t in ts),
        _transcendental_pow(func, args))
    return Plan(list(zip(ts, wants)), lambda outs: [out_lay] * len(outs),
                flops, trans, inplace=_inplace(func))


@functools.lru_cache(maxsize=1 << 14)
def _pointwise_plan(sizes, name: str, inplace: bool, operands, tpow: bool):
    """An elementwise op's plan for operands of these shapes and layouts:
    (each operand's layout, the output's, FLOPs, transcendentals)."""
    sizes = dict(sizes)
    shapes = [sh for sh, _ in operands]
    lays = [lay for _, lay in operands]

    def numel(shape, lay):
        return math.prod(-(-int(s) // _n(sizes, a))
                         for s, a in zip(shape, lay.dims))
    out_shape = shapes[0] if inplace else (_broadcast(*shapes) if shapes
                                           else ())
    # the output's dims: the in-place target's, else the full-shape
    # operand's that is split the most (ties: the first), else each dim
    # from the first operand that splits it
    full = [i for i, sh in enumerate(shapes) if sh == out_shape]
    if inplace:
        anchor = 0
    elif full:
        anchor = min(full, key=lambda i: (numel(shapes[i], lays[i]), i))
    else:
        anchor = None
    if anchor is not None:
        out_dims = [list(d) for d in lays[anchor].dims]
    else:
        out_dims = [[] for _ in out_shape]
        for sh, lay in zip(shapes, lays):
            off = len(out_shape) - len(sh)
            for i, s in enumerate(sh):
                if s != 1 and not out_dims[off + i]:
                    out_dims[off + i] = list(lay.dims[i])
        out_dims = _dedup(out_dims)
    # partial sums that pass through a linear op; copy_ and fill_ do not
    # read what they overwrite
    writes = inplace and name in ("copy_", "fill_")
    parts = [lay.partial for lay in lays[1:]] if writes else \
        [lay.partial for lay in lays]
    keep: Axes = ()
    if any(parts):
        if (name in _LINEAR_ALL or writes) and len(set(parts)) == 1:
            keep = parts[0]
        elif name in _LINEAR_ONE and sum(bool(p) for p in parts) == 1:
            keep = next(p for p in parts if p)
        elif name in _LINEAR_FIRST and parts[0] and not any(parts[1:]):
            keep = parts[0]
    out_dims = _dedup([[a for a in d if a not in keep] for d in out_dims])
    wants = []
    for i, (sh, lay) in enumerate(zip(shapes, lays)):
        if i == 0 and writes:
            wants.append(lay)
            continue
        want = _project(out_dims, out_shape, sh)
        if lay.partial and lay.partial == keep:
            want = Layout(want.dims, keep)
        wants.append(want)
    out_lay = Layout(tuple(tuple(d) for d in out_dims), keep)
    flops, trans = _element_cost(name, tpow,
                                 numel(out_shape, out_lay))
    return tuple(wants), out_lay, flops, trans


# -- matmul -------------------------------------------------------------------
def _subsets(lay: Layout):
    """Every way to keep or gather each of a layout's split dims: the
    dims gathered, fewest first."""
    split = [i for i, d in enumerate(lay.dims) if d]
    out = []
    for mask in range(1 << len(split)):
        out.append(frozenset(split[j] for j in range(len(split))
                             if mask >> j & 1))
    return sorted(out, key=lambda s: (len(s), sorted(s)))


def _matmul(an: StepAnalysis, func, args, kwargs) -> Plan:
    """mm ``(M, K) @ (K, N)`` and bmm ``(b, M, K) @ (b, K, N)``: the
    candidate that moves the fewest bytes (then the fewest local FLOPs)
    over each operand's dims kept or gathered, the contraction's axes
    (equal on both, or sliced from a whole operand) a partial sum of the
    output, a partial operand's sum carried through."""
    a, b = args[0], args[1]
    la, lb = an.layout(a), an.layout(b)
    best = _mm_plan(tuple(an.sizes.items()), _geometry(a), la,
                    _geometry(b), lb)
    if best is None:
        raise NotImplementedError(f"hlo_analysis: no layout for {func} of "
                                  f"{la} and {lb}")
    want_a, want_b, out_lay, mm = best
    return Plan([(a, want_a), (b, want_b)], [out_lay], mm=mm)


def _geometry(t: torch.Tensor):
    """What a plan reads of a tensor: its shape, its broadcast dims and
    its element size."""
    return (tuple(t.shape), tuple(st == 0 for st in _strides(t)),
            t.element_size())


@functools.lru_cache(maxsize=1 << 14)
def _mm_plan(sizes, ga_, la: Layout, gb_, lb: Layout):
    """``_matmul``'s choice for operands of these geometries and layouts
    (``(want_a, want_b, out layout, local FLOPs)``, None when none fits):
    the layers of a model repeat it."""
    best = None
    for pa_keep in ((True, True), (True, False), (False, True)):
        if la.partial and lb.partial and all(pa_keep):
            continue
        keep_pa = la.partial if pa_keep[0] else ()
        keep_pb = lb.partial if pa_keep[1] else ()
        for ga in _subsets(la):
            for gb in _subsets(lb):
                cand = _mm_candidate(sizes, ga_, gb_, la, lb, ga, gb,
                                     keep_pa, keep_pb)
                if cand is not None and (best is None or cand[0] < best[0]):
                    best = cand
    return None if best is None else best[1:]


def _mm_candidate(sizes, geo_a, geo_b, la, lb, ga, gb, keep_pa, keep_pb):
    shape_a, shape_b = geo_a[0], geo_b[0]
    nda, ndb = len(shape_a), len(shape_b)
    da = [() if i in ga else la.dims[i] for i in range(nda)]
    db = [() if i in gb else lb.dims[i] for i in range(ndb)]
    used_a = {x for d in da for x in d} | set(keep_pa)
    used_b = {x for d in db for x in d} | set(keep_pb)

    def join(i, j):
        """The shared dim ``i`` of a and ``j`` of b: equal axes, or the
        whole side sliced to the other's."""
        if da[i] == db[j]:
            return da[i]
        if not da[i] and not (set(db[j]) & used_a):
            da[i] = db[j]
            used_a.update(db[j])
            return db[j]
        if not db[j] and not (set(da[i]) & used_b):
            db[j] = da[i]
            used_b.update(da[i])
            return da[i]
        return None
    k = join(nda - 1, ndb - 2)
    if k is None:
        return None
    bat = ()
    if nda == 3:
        bat = join(0, 0)
        if bat is None:
            return None
    m, n = da[nda - 2], db[ndb - 1]
    partial = tuple(k) + tuple(keep_pa) + tuple(keep_pb)
    every = list(bat) + list(m) + list(n) + list(partial)
    if len(every) != len(set(every)):
        return None
    want_a, want_b = Layout(tuple(da), keep_pa), Layout(tuple(db), keep_pb)
    moved = (_moved_bytes(sizes, geo_a, la, want_a)
             + _moved_bytes(sizes, geo_b, lb, want_b))
    out_lay = Layout(((bat,) if nda == 3 else ()) + (m, n), partial)
    d = dict(sizes)
    local_a = [-(-s // _n(d, x)) for s, x in zip(shape_a, want_a.dims)]
    mm = 2.0 * math.prod(local_a) * -(-shape_b[-1] // _n(d, want_b.dims[-1]))
    return ((moved, mm), want_a, want_b, out_lay, mm)


def _moved_bytes(sizes, geo, src: Layout, dst: Layout) -> float:
    """The bytes ``_conform`` would record moving a tensor of ``geo``,
    recording none."""
    if src == dst:
        return 0.0
    steps, _ = _moves(sizes, *geo, src, dst)
    d = dict(sizes)
    return sum(b for _, axes, b in steps
               if any(d.get(a, 1) > 1 for a in axes))


# -- views --------------------------------------------------------------------
def _view_groups(src, dst):
    """Consecutive dims of equal products: ``[(src dims, dst dims)]``."""
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        gi, gj = [], []
        ps = pd = 1
        if i < len(src):
            gi.append(i)
            ps = src[i]
            i += 1
        if j < len(dst):
            gj.append(j)
            pd = dst[j]
            j += 1
        while ps != pd:
            if ps < pd and i < len(src):
                gi.append(i)
                ps *= src[i]
                i += 1
            elif j < len(dst):
                gj.append(j)
                pd *= dst[j]
                j += 1
            else:
                break
        groups.append((gi, gj))
    return groups


def _reshape_layout(an: StepAnalysis, src_shape, lay: Layout, dst_shape
                    ) -> Tuple[Layout, Layout]:
    """(the operand's layout the view can take, the view's layout).  In
    each group of dims whose products match, a merge keeps the axes of
    its leading dims while every earlier one is split down to one element
    a place (a place's block stays contiguous); a split puts the axes on
    the leading dims they divide, moving on only past a dim split down to
    one element.  Axes that cannot stay are gathered first."""
    want = [list(d) for d in lay.dims]
    out = [[] for _ in dst_shape]
    for gi, gj in _view_groups(list(src_shape), list(dst_shape)):
        axes, ok = [], True
        for i in gi:
            if src_shape[i] == 1:
                continue
            if not ok:
                want[i] = []
                continue
            axes.extend(want[i])
            if -(-src_shape[i] // _n(an.sizes, want[i])) != 1:
                ok = False
        k, rem, placed = 0, [dst_shape[j] for j in gj], []
        for a in axes:
            while k < len(gj) and rem[k] == 1:
                k += 1
            if k >= len(gj):
                break
            if rem[k] % an.sizes[a] == 0:
                rem[k] //= an.sizes[a]
            elif an.sizes[a] % rem[k] == 0 and a == axes[-1]:
                # split past one element: a group of places shares each
                # (8 KV heads over 16 places, two a head, as XLA tiles
                # them 8 x 2)
                rem[k] = 1
            else:
                break
            out[gj[k]].append(a)
            placed.append(a)
        drop = set(axes) - set(placed)
        for i in gi:
            want[i] = [a for a in want[i] if a not in drop]
    return (Layout(tuple(tuple(d) for d in want), lay.partial),
            Layout(tuple(tuple(d) for d in out), lay.partial))


def _view(an, func, args, kwargs) -> Plan:
    t = args[0]
    lay = an.layout(t)
    name = _name(func)
    nd = t.dim()
    if name in ("view", "_unsafe_view", "reshape"):
        return _reshape_plan(an, t, lay, tuple(args[1]))
    if name in ("alias", "detach", "lift_fresh"):
        return Plan([(t, lay)], [lay], view=True)
    if name == "permute":
        p = [_dim(d, nd) for d in args[1]]
        return Plan([(t, lay)], [lay.with_dims([lay.dims[i] for i in p])],
                    view=True)
    if name in ("transpose", "t"):
        d0, d1 = (0, 1) if name == "t" else (_dim(args[1], nd),
                                             _dim(args[2], nd))
        if nd < 2:
            return Plan([(t, lay)], [lay], view=True)
        dims = list(lay.dims)
        dims[d0], dims[d1] = dims[d1], dims[d0]
        return Plan([(t, lay)], [lay.with_dims(dims)], view=True)
    if name == "expand":
        size = list(args[1])
        off = len(size) - nd
        dims = [()] * off + [() if t.shape[i] == 1 and size[off + i] != 1
                             else lay.dims[i] for i in range(nd)]
        return Plan([(t, lay)], [lay.with_dims(dims)], view=True)
    if name == "unsqueeze":
        d = _dim(args[1], nd + 1)
        dims = list(lay.dims)
        dims.insert(d, ())
        return Plan([(t, lay)], [lay.with_dims(dims)], view=True)
    if name == "squeeze":
        if len(args) > 1:
            ds = args[1] if isinstance(args[1], (list, tuple)) else [args[1]]
            ds = {_dim(d, nd) for d in ds}
        else:
            ds = set(range(nd))
        dims = [d for i, d in enumerate(lay.dims)
                if not (i in ds and t.shape[i] == 1)]
        return Plan([(t, lay)], [lay.with_dims(dims)], view=True)
    if name == "select":
        d = _dim(args[1], nd)
        dims = list(lay.dims)
        gone = dims.pop(d)
        # only the place that holds the index has it: a masked select,
        # summed later
        return Plan([(t, lay)], [Layout(tuple(dims),
                                        lay.partial + tuple(gone))],
                    view=True)
    if name == "slice":
        d = _dim(args[1] if len(args) > 1 else 0, nd)
        start = args[2] if len(args) > 2 else None
        end = args[3] if len(args) > 3 else None
        step = args[4] if len(args) > 4 else 1
        size = t.shape[d]
        lo = 0 if start is None else max(0, start + size if start < 0
                                         else start)
        hi = size if end is None else min(size, end + size if end < 0
                                          else end)
        whole = lo == 0 and hi >= size and step == 1
        if whole or not lay.dims[d]:
            return Plan([(t, lay)], [lay], view=True)
        return _shifted(an, t, lay, d, hi - lo, step, view=True)
    if name in ("split", "split_with_sizes", "unbind"):
        d = _dim(args[2] if len(args) > 2 else (args[1] if name == "unbind"
                                               and len(args) > 1 else 0), nd)
        if name == "unbind":
            d = _dim(args[1] if len(args) > 1 else 0, nd)
        want = _drop(lay, [d])
        if name == "unbind":
            dims = list(want.dims)
            dims.pop(d)
            return Plan([(t, want)], lambda outs: [want.with_dims(dims)]
                        * len(outs), view=True)
        return Plan([(t, want)], lambda outs: [want] * len(outs), view=True)
    if name == "as_strided":
        size = tuple(args[1])
        if size == tuple(t.shape):
            return Plan([(t, lay)], [lay], view=True)
        want = Layout.replicated(nd)
        return Plan([(t, want)], [Layout.replicated(len(size))], view=True)
    raise NotImplementedError(f"hlo_analysis: no layout rule for view "
                              f"{func}")


def _shifted(an, t, lay, d, length, step, view) -> Plan:
    """A slice of (or the gradient into) a split dim ``d``: when the
    slice's ``length`` divides over the dim's axes it stays split over
    them, its rows brought to their places by a collective-permute (the
    output's bytes); else the dim is gathered first."""
    n = _n(an.sizes, lay.dims[d])
    if step != 1 or length % n:
        want = _drop(lay, [d])
        return Plan([(t, want)], [want], view=view)
    plan = Plan([(t, lay)], [lay], view=view)

    def outs(o):
        an.record("collective-permute", lay.dims[d],
                  an.local_bytes(o[0], lay))
        return [lay]
    plan.outputs = outs
    return plan


def _reshape_plan(an, t, lay, size) -> Plan:
    size = list(size)
    if -1 in size:
        known = math.prod(s for s in size if s != -1)
        size[size.index(-1)] = t.numel() // max(known, 1)
    want, out = _reshape_layout(an, tuple(t.shape), lay, tuple(size))
    return Plan([(t, want)], [out], view=True)


def _drop(lay: Layout, ds) -> Layout:
    dims = list(lay.dims)
    for d in ds:
        dims[d] = ()
    return Layout(tuple(dims), lay.partial)


# -- reductions ---------------------------------------------------------------
def _reduce_dims(t, dims_arg) -> List[int]:
    if dims_arg is None or (isinstance(dims_arg, (list, tuple))
                            and len(dims_arg) == 0):
        return list(range(t.dim()))
    if isinstance(dims_arg, int):
        dims_arg = [dims_arg]
    return sorted(_dim(d, t.dim()) for d in dims_arg)


def _sum(an, func, args, kwargs) -> Plan:
    """sum / mean: a split reduced dim leaves a partial sum over its axes
    (under ``settled``, the caller's collective sums it)."""
    t = args[0]
    lay = an.layout(t)
    name = func.__name__
    dims_arg = None
    if ".dim" in name or "IntList" in name:
        dims_arg = args[1] if len(args) > 1 else kwargs.get("dim")
    keepdim = bool(args[2] if len(args) > 2 else kwargs.get("keepdim",
                                                            False))
    if dims_arg is None and "default" in name:
        keepdim = False
    red = _reduce_dims(t, dims_arg)
    gone = tuple(a for d in red for a in lay.dims[d])
    dims = [() if i in red else d for i, d in enumerate(lay.dims)]
    if not keepdim:
        dims = [d for i, d in enumerate(dims) if i not in red]
    partial = lay.partial + (() if an._settled else gone)
    out = Layout(tuple(dims), partial)
    return Plan([(t, lay)], [out], flops=float(_numel(an, t.shape, lay)))


def _nonlinear_reduce(an, func, args, kwargs) -> Plan:
    """logsumexp / amax over split dims: a max and a sum over the axes
    (two all-reduces of the result), no partial sum."""
    t = args[0]
    lay = _settle(an, t)
    red = _reduce_dims(t, args[1] if len(args) > 1 else None)
    keepdim = bool(args[2] if len(args) > 2 else False)
    gone = tuple(a for d in red for a in lay.dims[d])
    dims = [() if i in red else d for i, d in enumerate(lay.dims)]
    if not keepdim:
        dims = [d for i, d in enumerate(dims) if i not in red]
    out = Layout(tuple(dims))
    n = _numel(an, t.shape, lay)
    name = _name(func)
    plan = Plan([(t, lay)], [out], flops=float(3 * n if name == "logsumexp"
                                               else n),
                trans=float(n if name == "logsumexp" else 0))

    def outs(o):
        for _ in range(2 if name == "logsumexp" else 1):
            an.record("all-reduce", gone, an.local_bytes(o[0], out))
        return [out]
    plan.outputs = outs
    return plan


def _settle(an, t) -> Layout:
    lay = an.layout(t)
    return Layout(lay.dims) if lay.partial else lay


def _softmax(an, func, args, kwargs) -> Plan:
    """softmax and its backward along a dim: split, a max and a sum over
    its axes (two all-reduces of the reduced rows); the layout stays."""
    ts = [a for a in args if isinstance(a, torch.Tensor)]
    t = ts[0]
    d = _dim(args[len(ts)], t.dim())
    lay = _settle(an, t)
    n = _numel(an, t.shape, lay)
    back = "backward" in _name(func)
    plan = Plan([(x, lay) for x in ts], [lay],
                flops=float(3 * n if back else 4 * n),
                trans=0.0 if back else float(n))
    if lay.dims[d]:
        rows = lay.with_dims([() if i == d else x
                              for i, x in enumerate(lay.dims)])
        nbytes = _numel(an, [1 if i == d else s
                             for i, s in enumerate(t.shape)], rows) * 4
        for _ in range(1 if back else 2):
            an.record("all-reduce", lay.dims[d], nbytes)
    return plan


def _along(an, func, args, kwargs) -> Plan:
    """cumsum / sort / flip / pad: the dims the op walks are gathered."""
    t = args[0]
    name = _name(func)
    nd = t.dim()
    if name == "cumsum":
        ds = [_dim(args[1], nd)]
    elif name == "sort":
        ds = [_dim(kwargs.get("dim", args[1] if len(args) > 1
                              and isinstance(args[1], int) else -1), nd)]
    elif name == "flip":
        ds = [_dim(d, nd) for d in args[1]]
    elif name == "constant_pad_nd":
        pad = list(args[1])
        ds = [nd - 1 - i // 2 for i in range(len(pad)) if pad[i]]
    else:
        ds = []
    want = _drop(_settle(an, t), ds)
    n = _numel(an, t.shape, want)
    return Plan([(t, want)], lambda outs: [want] * len(outs),
                flops=float(n if name == "cumsum" else 0))


# -- joins, gathers, scatters -------------------------------------------------
def _cat(an, func, args, kwargs) -> Plan:
    ts = list(args[0])
    stack = _name(func) == "stack"
    nd = ts[0].dim()
    d = _dim(args[1] if len(args) > 1 else kwargs.get("dim", 0),
             nd + (1 if stack else 0))
    lays = [_settle(an, t) for t in ts]
    anchor = max(range(len(ts)), key=lambda i: (ts[i].numel(), -i))
    dims = list(lays[anchor].dims)
    if not stack:
        dims[d] = ()
    base = Layout(tuple(dims))
    inputs = [(t, base) for t in ts]
    out = list(base.dims)
    if stack:
        out.insert(d, ())
    return Plan(inputs, [Layout(tuple(out))])


def _gather(an, func, args, kwargs) -> Plan:
    """``gather(self, dim, index)``: each place gathers from its share of
    a split ``dim`` (the output a partial sum over its axes); the other
    dims follow the index."""
    t, d, idx = args[0], _dim(args[1], args[0].dim()), args[2]
    lt, li = _settle(an, t), _settle(an, idx)
    own = lt.dims[d]
    dims = [list(x) for x in li.dims]
    dims[d] = [a for a in dims[d] if a not in own]
    dims = _dedup(dims)
    used = {a for x in dims for a in x}
    want_t = [list(x) if i != d else [a for a in own if a not in used]
              for i, x in enumerate(dims)]
    keep = tuple(want_t[d])
    return Plan([(t, Layout(tuple(tuple(x) for x in want_t))),
                 (idx, Layout(tuple(tuple(x) for x in dims)))],
                [Layout(tuple(tuple(x) for x in dims), keep)])


def _aligned(x: torch.Tensor, nb: int, size: int) -> Optional[int]:
    """The index dim (of ``nb`` broadcast dims) along which ``x`` runs
    over a whole indexed dim of ``size`` alone (the batch index a vmap's
    batching rule adds, ``arange(n)`` along one dim), else None: such a
    dim stays split as the indexed one, each place reading its own
    rows."""
    shape = [1] * (nb - x.dim()) + list(x.shape)
    big = [j for j, s in enumerate(shape) if s != 1]
    if len(big) == 1 and shape[big[0]] == size and x.numel() == size:
        return big[0]
    return None


def _index(an, func, args, kwargs) -> Plan:
    """``self[indices]`` (``index.Tensor``) and ``index_select``: the
    indexed dims' axes leave a partial sum (each place looks up what it
    holds); the index dims follow the indices, the rest of ``self`` keeps
    its axes, and an axis both want is gathered from the side that moves
    fewer bytes."""
    t = args[0]
    lt = _settle(an, t)
    if _name(func) == "index_select":
        d = _dim(args[1], t.dim())
        idx = [None] * d + [args[2]]
    else:
        idx = list(args[1])
    pos = [i for i, x in enumerate(idx) if x is not None]
    its = [x for x in idx if x is not None]
    ishape = tuple(_broadcast(*[x.shape for x in its]))
    ilay_dims = [[] for _ in ishape]
    for x in its:
        lx = _settle(an, x)
        off = len(ishape) - x.dim()
        for i, s in enumerate(x.shape):
            if s != 1 and not ilay_dims[off + i]:
                ilay_dims[off + i] = list(lx.dims[i])
    aligned = {}
    for p, x in zip(pos, its):
        j = _aligned(x, len(ishape), t.shape[p])
        if j is not None and lt.dims[p]:
            aligned[p] = j
            ilay_dims[j] = list(lt.dims[p])
    ilay_dims = _dedup(ilay_dims)
    partial = tuple(a for p in pos if p not in aligned for a in lt.dims[p])
    rest = [i for i in range(t.dim()) if i not in pos]
    rest_axes = {a for i in rest for a in lt.dims[i]}
    clash = rest_axes & ({a for d in ilay_dims for a in d} | set(partial))
    drop_self = set()
    if clash:
        self_cost = t.numel() * t.element_size()
        idx_cost = sum(x.numel() * x.element_size() for x in its)
        if idx_cost <= self_cost / max(1, _n(an.sizes, clash)):
            ilay_dims = [[a for a in d if a not in clash] for d in ilay_dims]
        else:
            drop_self = clash
    tdims = [[a for a in lt.dims[i] if a not in drop_self]
             if i in rest else list(lt.dims[i]) for i in range(t.dim())]
    want_t = Layout(tuple(tuple(d) for d in tdims))
    inputs = [(t, want_t)]
    for x in its:
        inputs.append((x, _project(ilay_dims, ishape, tuple(x.shape))))
    # out: self's dims before the first index, the index dims, the rest
    consecutive = pos == list(range(pos[0], pos[0] + len(pos)))
    front = [tdims[i] for i in range(pos[0])] if consecutive else []
    back = [tdims[i] for i in rest if not consecutive or i > pos[-1]]
    out = Layout(tuple(tuple(d) for d in front + ilay_dims + back),
                 partial)
    return Plan(inputs, [out])


def _index_put(an, func, args, kwargs) -> Plan:
    """``index_put`` / ``index_copy_`` / ``index_add`` / ``scatter``:
    the result keeps ``self``'s layout (a place writes the rows it holds;
    a fresh whole ``self`` takes the values' splits on the dims they
    share).  The values follow it on those dims and come whole along the
    indexed ones, except an accumulation, where their split there leaves
    a partial sum (each place adds its share) and ``self``'s dims give
    those axes up."""
    name = _name(func)
    t = args[0]
    lt = an.layout(t)
    nd = t.dim()
    if name.startswith("index_put"):
        idx, vals = list(args[1]), args[2]
        acc = bool(args[3] if len(args) > 3 else kwargs.get("accumulate",
                                                             False))
        pos = [i for i, x in enumerate(idx) if x is not None]
        its = [x for x in idx if x is not None]
        nb = len(_broadcast(*[x.shape for x in its]))
        rest = [i for i in range(nd) if i not in pos]
        if pos == list(range(pos[0], pos[0] + len(pos))):
            before = [i for i in rest if i < pos[0]]
        else:
            before = []
        order = before + [None] * nb + [i for i in rest if i not in before]
        off = len(order) - vals.dim()
        vmap_ = {order[off + k]: k for k in range(vals.dim())
                 if order[off + k] is not None}
        vidx = [k for k in range(vals.dim()) if order[off + k] is None]
        first = order.index(None)
        for p, x in zip(pos, its):
            j = _aligned(x, nb, t.shape[p])
            k = first + j - off if j is not None else -1
            if 0 <= k < vals.dim() and k in vidx:
                vmap_[p] = k
                vidx.remove(k)
    else:   # (self, dim, index, source)
        d = _dim(args[1], nd)
        pos, its, vals = [d], [args[2]], args[3]
        acc = name in ("index_add", "scatter_add")
        vmap_ = {i: i for i in range(nd) if i != d}
        vidx = [d]
    lv = _settle(an, vals)
    part = tuple(a for i in vidx for a in lv.dims[i]) if acc else ()
    if not lt.used():
        out_dims = [list(lv.dims[vmap_[r]]) if r in vmap_ else []
                    for r in range(nd)]
    else:
        out_dims = [list(x) for x in lt.dims]
    if name.startswith("index_put"):
        for p in pos:
            if p in vmap_ and not lt.used():
                out_dims[p] = list(lv.dims[vmap_[p]])
    out_dims = _dedup([[a for a in x if a not in part] for x in out_dims])
    vwant = [[] for _ in range(vals.dim())]
    for r, vd in vmap_.items():
        vwant[vd] = list(out_dims[r])
    for i in vidx:
        vwant[i] = [a for a in lv.dims[i] if a in part]
    want_v = Layout(tuple(tuple(d) for d in vwant))
    inplace = _inplace(func)
    fresh = not lt.used() and not lt.partial
    want_t = lt if fresh else Layout(tuple(tuple(d) for d in out_dims))
    # an out-of-place write into a fresh tensor makes a fresh result (the
    # zeros are the result's own, placed at its first use)
    deferred = fresh and not inplace and t in an._fresh
    inputs = ([] if deferred else [(t, want_t)]) + [(vals, want_v)]
    for x in its:
        if name.startswith("scatter"):
            inputs.append((x, want_v))
        elif name.startswith("index_put"):
            idx_dims = [vwant[first + j - off] if 0 <= first + j - off
                        < vals.dim() else [] for j in range(nb)]
            inputs.append((x, _project(idx_dims, [1] * nb, tuple(x.shape))
                           if x.dim() else Layout(())))
        else:
            inputs.append((x, Layout((tuple(vwant[vidx[0]]),))))
    out = Layout(tuple(tuple(d) for d in out_dims), part)
    n = _numel(an, vals.shape, want_v)
    return Plan(inputs, [out], flops=float(n if acc else 0), inplace=inplace,
                fresh=deferred)


def _grad_of_view(an, func, args, kwargs) -> Plan:
    """``select_backward`` / ``slice_backward``: the grad placed in zeros
    of the input's shape; the selected dim whole, a sliced split dim
    gathered."""
    g = args[0]
    lg = an.layout(g)
    d = _dim(args[2], len(args[1]))
    if _name(func) == "select_backward":
        dims = list(lg.dims)
        dims.insert(d, ())
        return Plan([(g, lg)], [Layout(tuple(dims), lg.partial)])
    if not lg.dims[d]:
        return Plan([(g, lg)], [lg])
    step = args[5] if len(args) > 5 else 1
    return _shifted(an, g, lg, d, g.shape[d], step, view=False)


def _create(an, func, args, kwargs) -> Plan:
    """Creation: a new tensor whole on every place; a ``*_like`` one, or
    a ``new_*`` one of its model's shape, laid out as its model (no
    partial sum)."""
    ts = _tensors(args, kwargs)
    name = _name(func)
    like = name.endswith("_like") or (
        name.startswith("new_") and ts
        and tuple(args[1]) == tuple(ts[0].shape))
    if like and ts:
        lay = Layout(an.layout(ts[0]).dims)
        return Plan([], [lay], fresh=True)
    return Plan([], lambda outs: [Layout.replicated(o.dim()) for o in outs],
                fresh=True)


def _item(an, func, args, kwargs) -> Plan:
    t = args[0]
    return Plan([(t, Layout.replicated(t.dim()))], [])


_VIEWS = {"view", "_unsafe_view", "alias", "detach", "lift_fresh", "permute",
          "transpose", "t", "expand", "unsqueeze", "squeeze", "select",
          "slice", "split", "split_with_sizes", "unbind", "as_strided"}
_CREATE = {"arange", "zeros", "ones", "empty", "full", "scalar_tensor",
           "new_empty", "new_empty_strided", "new_full", "new_zeros",
           "new_ones", "zeros_like", "ones_like", "empty_like", "full_like",
           "empty_strided", "rand", "randn"}
_RULES: Dict[str, Callable] = {
    "mm": _matmul, "bmm": _matmul,
    "sum": _sum, "mean": _sum,
    "logsumexp": _nonlinear_reduce, "amax": _nonlinear_reduce,
    "_softmax": _softmax, "_softmax_backward_data": _softmax,
    "cumsum": _along, "sort": _along, "flip": _along,
    "constant_pad_nd": _along,
    "cat": _cat, "stack": _cat,
    "gather": _gather, "index": _index, "index_select": _index,
    "index_put": _index_put, "index_put_": _index_put,
    "index_copy_": _index_put, "index_copy": _index_put,
    "index_add": _index_put, "scatter": _index_put,
    "scatter_add": _index_put,
    "select_backward": _grad_of_view, "slice_backward": _grad_of_view,
    "_local_scalar_dense": _item,
}
_EXTRA_POINTWISE = {"where", "masked_fill", "clamp", "clamp_min",
                    "nan_to_num", "logaddexp", "gelu", "gelu_backward",
                    "silu", "silu_backward", "sigmoid_backward",
                    "tanh_backward", "_to_copy", "clone", "copy_", "fill_",
                    "tril", "rsub", "floor_divide", "remainder",
                    "bitwise_and", "bitwise_and_", "bitwise_not",
                    "bitwise_or", "bitwise_or_", "logical_not", "round",
                    "reciprocal"}


def _rule_for(func) -> Optional[Callable]:
    name = _name(func)
    if name in _RULES:
        return _RULES[name]
    if name in _VIEWS:
        return _view
    if name in _CREATE:
        return _create
    if torch.Tag.pointwise in func.tags or name in _EXTRA_POINTWISE:
        return _pointwise
    return None


# =============================================================================
# the kernels' operand layouts
# =============================================================================
def _flash_layouts(an, ts, lays):
    """Flash attention: q ``(B, Sq, H, D)``, k and v ``(B, Sk, KV, D)``
    keep the batch split and q's head split (k and v take it where KV
    divides it or it divides KV, a group of places sharing each KV head;
    else they come whole, each place reading the KV heads its q heads
    use, and their gradients a partial sum over it); the sequence and
    head dims come whole.  Order of operands and outputs as the
    wrapper's."""
    q = ts[0]
    lq = _settle(an, q)
    b, h = lq.dims[0], lq.dims[2]
    kvs = [t for t in ts[1:] if t is not None and t.dim() == 4]
    KV = kvs[0].shape[2] if kvs else q.shape[2]
    n = _n(an.sizes, h)
    kv_split = h if KV % n == 0 or n % KV == 0 else ()
    big = Layout((b, (), h, ()))
    kv = Layout((b, (), kv_split, ()))
    rows = Layout((b, h, ()))
    return big, kv, rows, (h if not kv_split else ())


def _kernel_flash(an, ts, lays):
    big, kv, rows, _ = _flash_layouts(an, ts, lays)
    return [big, kv, kv], [big, rows]


def _kernel_flash_dq(an, ts, lays):
    big, kv, rows, _ = _flash_layouts(an, ts, lays)
    return [big, kv, kv, big, rows, big], [big, rows]


def _kernel_flash_dkdv(an, ts, lays):
    big, kv, rows, part = _flash_layouts(an, ts, lays)
    return [big, kv, kv, rows, rows, big], [Layout(kv.dims, part)] * 2


def _ssd_layouts(an, ts):
    x = ts[0]
    lx = _settle(an, x)
    b, h = lx.dims[0], lx.dims[2]
    xl = Layout((b, (), h, ()))
    return (b, h, xl, Layout((b, (), h)), Layout((h,)), Layout((b, (), ())),
            Layout((b, h, (), ())))


def _kernel_ssd(an, ts, lays):
    b, h, xl, dtl, al, bl, sl = _ssd_layouts(an, ts)
    return [xl, dtl, al, bl, bl, sl], [xl, sl]


def _kernel_ssd_bwd(an, ts, lays):
    b, h, xl, dtl, al, bl, sl = _ssd_layouts(an, ts)
    return ([xl, dtl, al, bl, bl, sl, xl, sl],
            [xl, dtl, Layout(al.dims, b), Layout(bl.dims, h),
             Layout(bl.dims, h), sl])


def _kernel_rows(an, ts, lays):
    """The int8 pair and top-k: rows keep their split, each row whole."""
    out = []
    for t in ts:
        if t is None:
            out.append(None)
            continue
        lay = _settle(an, t)
        out.append(Layout((lay.dims[0],) + ((),) * (t.dim() - 1)))
    first = out[0]
    return out, [first, Layout((first.dims[0],))] * 2


_KERNEL_LAYOUTS = {
    "flash_attention": _kernel_flash,
    "flash_attention_bwd_dq": _kernel_flash_dq,
    "flash_attention_bwd_dkdv": _kernel_flash_dkdv,
    "ssd_scan": _kernel_ssd, "ssd_scan_bwd": _kernel_ssd_bwd,
    "quantize": _kernel_rows, "dequantize": _kernel_rows,
    "topk_compress": _kernel_rows,
}


# =============================================================================
# a shard_map body as one place's program (``shard_map_one_place``)
# =============================================================================
class _GatherOnePlace(torch.autograd.Function):
    """One place's gather of a weight shard along ``axis`` over mesh axis
    ``ax`` (``n`` places): one all-gather (its transpose one
    reduce-scatter), the other places' shards not computed (meta)."""

    @staticmethod
    def forward(shard, axis, n, ax, an, source):
        shape = list(shard.shape)
        shape[axis] *= n
        with an.quiet():
            out = torch.empty(shape, dtype=shard.dtype, device=shard.device)
        an.record("all-gather", (ax,), an.local_bytes(out), source)
        an.track(out)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis, ctx.n, ctx.ax, ctx.an, ctx.source = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        with ctx.an.quiet():
            gs = g.narrow(ctx.axis, 0, g.shape[ctx.axis] // ctx.n)
        ctx.an.record("reduce-scatter", (ctx.ax,), ctx.an.local_bytes(gs),
                      ctx.source)
        return gs, None, None, None, None, None


class _OnePlace(torch.autograd.Function):
    """``run(operands, g)``: the one-place body's forward (``g`` None) or
    its backward, as a Function of the global operands."""

    @staticmethod
    def forward(run, *ops):
        return run(ops, None)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.run = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, g):
        return (None, *ctx.run(ctx.saved_tensors, g))


# =============================================================================
# one step
# =============================================================================
def analyse(step: Callable, args: tuple, arg_specs, out_specs, mesh_shape,
            donated: Sequence[int] = ()) -> Dict[str, Any]:
    """Run ``step(*args)`` once under a ``StepAnalysis`` over a mesh of
    ``mesh_shape`` (``{axis: size}``): ``args`` laid out by ``arg_specs``,
    the outputs moved to ``out_specs(outs)`` at the end (the reference's
    out_shardings).  ``donated``: the indices of the donated arguments.
    Returns ``{"cost", "memory", "collectives", "groups", "kernels",
    "outputs"}``, every number per place."""
    from repro_torch.kernels import LAUNCHES
    an = StepAnalysis(mesh_shape)
    an.register_args(args, arg_specs)
    launches0 = sum(LAUNCHES.values())
    with an:
        outs = step(*args)
        specs = out_specs(outs)
        spec_at = SH.path_leaves(specs, is_leaf=SH.is_spec)
        for path, leaf in SH.path_leaves(outs).items():
            if isinstance(leaf, torch.Tensor):
                inner = unwrap(leaf)[0]
                want = Layout.of_spec(spec_at[path], inner.dim())
                an._place_fresh(inner, want)
                an._transient(an._conform(inner, an.layout(inner), want))
                an.layouts[inner] = want
    launched = sum(LAUNCHES.values()) - launches0
    if launched != an._launched:
        raise RuntimeError(f"hlo_analysis: {launched - an._launched} kernel "
                           f"launch(es) without a recorded count")
    argument = an.place_bytes(args, arg_specs)
    # XLA's memory analysis counts a tuple result's pointer table too: 8
    # bytes a leaf
    output = an.place_bytes(outs, specs) + 8 * sum(
        isinstance(t, torch.Tensor) for t in SH.path_leaves(outs).values())
    alias = sum(an.place_bytes(args[i], arg_specs[i]) for i in donated)
    memory = {"argument_size_in_bytes": argument,
              "output_size_in_bytes": output,
              "alias_size_in_bytes": alias,
              "temp_size_in_bytes": an.peak_temp,
              "peak_memory_in_bytes": argument + an.peak_temp}
    return {"cost": an.cost_stats(), "memory": memory,
            "collectives": an.collective_stats(), "groups": an.groups,
            "kernels": dict(an.kernels), "outputs": outs}


def cost_stats(result: Dict[str, Any]) -> Dict[str, float]:
    """``{flops, bytes_accessed, transcendentals}`` per place (and
    ``matmul_flops``, the products' share of ``flops``)."""
    return dict(result["cost"])


def memory_stats(result: Dict[str, Any]) -> Dict[str, float]:
    return {k: float(result["memory"][k]) for k in _MEMORY_KEYS}


def collective_stats(result: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """``{op: {bytes, count}}`` over ``_COLLECTIVES`` plus ``total``."""
    return {k: dict(v) for k, v in result["collectives"].items()}


def group_stats(result: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """``{"<op> <axes> <source>": {bytes, count}}``: the collectives by
    op, mesh axes (``+``-joined) and what made them (an aten op, a pin
    ``shard``, the MoE body ``moe``, a kernel's name)."""
    out: Dict[str, Dict[str, float]] = {}
    for op, axes, nbytes, src in result["groups"]:
        g = out.setdefault(f"{op} {'+'.join(axes)} {src}",
                           {"bytes": 0.0, "count": 0})
        g["bytes"] += nbytes
        g["count"] += 1
    return out
