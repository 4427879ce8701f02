"""The device mesh, logical-axis sharding rules (MaxText-style) with the
divisibility fallback, and the collectives of the sharded bodies
(counterpart of ``repro/parallel/sharding.py``).

The reference runs ``shard_map`` from one process over many devices.  The
port does the same from one controller: a ``Mesh`` is a grid of
``torch.device`` places over named axes, a sharded body runs once per
place, each on its own place's tensors, and every collective is an explicit
sum, concatenation or slice in a fixed place order.  So ``data = 1`` stays
bit for bit the single-device program, and ``data > 1`` is deterministic.
A place may repeat: eight places can share one card (the tests pass eight
CPU places, the card's smoke run ``cuda:0`` eight times).

A single source of truth maps *logical* axis names to mesh axes:

    batch     -> ('data',)         or ('pod', 'data') multi-pod
    fsdp      -> 'data'            (ZeRO-3-style parameter sharding)
    tp        -> 'model'           (tensor parallelism)
    experts   -> 'model'           (expert parallelism, when E % tp == 0)
    cache_seq -> 'model'           (seq-sharded KV cache for decode)

``param_pspecs`` derives each parameter's spec from its leaf *path name*,
so models never annotate tensors; every rule checks divisibility of the
concrete dim against the mesh axis size and falls back to replication when
it does not divide (e.g. arctic's 56 heads).  A spec is a plain tuple with
one entry a dim: a mesh axis name, a tuple of them, or ``None``.

``count_collectives`` counts the bytes and calls of the collectives the
one-controller program runs inside it (the real mesh runs').

``shard(x, names)`` is the reference's activation pin: the identity, and
under an active step analysis (``launch.hlo_analysis``, which sets
``active_analysis()``) it pins ``x``'s layout (and its cotangent's) to
``activation_spec(names, x.shape)``.  The reference's ``named_shardings``
only places arrays, so it has no counterpart here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]


class Mesh:
    """A grid of places (``torch.device``) over named axes.

    ``devices`` is a numpy object array whose dims are ``axis_names``;
    ``shape`` is the ``{axis: size}`` dict (JAX's ``mesh.shape``), ``home``
    the first place (where the global buffers live) and ``n_devices`` the
    number of distinct devices among the places."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-d places for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def home(self) -> torch.device:
        return self.devices.flat[0]

    @property
    def n_devices(self) -> int:
        return len(set(self.devices.flat))

    def coords(self) -> Iterator[Dict[str, int]]:
        """Every place's ``{axis: index}``, in place (row-major) order."""
        for idx in np.ndindex(*self.devices.shape):
            yield dict(zip(self.axis_names, idx))

    def place(self, coords: Dict[str, int]) -> torch.device:
        return self.devices[tuple(coords[a] for a in self.axis_names)]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, {self.n_devices} distinct device(s), "
                f"home {self.home})")


def default_places(device=None) -> List[torch.device]:
    """The places a mesh takes when the caller names none: every visible
    CUDA device for a run on the card, one CPU device (JAX's default on
    the CPU) for a run there.  ``device=None``: the card when one is
    visible, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_flat_mesh(mesh_shape: Sequence[int],
                   axis_names: Tuple[str, str] = ("data", "model"),
                   devices: Optional[Sequence] = None) -> Mesh:
    """The ``(data, model)`` mesh behind ``FLConfig.mesh_shape``.

    ``data`` carries stacked client-delta rows, ``model`` the flat
    parameter vector (``fl/flatbuf.ShardedFlatLayout``).  Takes the first
    ``data * model`` of ``devices`` (default ``default_places()``), a place
    as often as it is listed, and raises when fewer are given: there is no
    fallback to fewer places or to the CPU."""
    shape = tuple(int(s) for s in mesh_shape)
    if len(shape) != 2 or any(s < 1 for s in shape):
        raise ValueError(f"mesh_shape must be two positive ints "
                         f"(data, model); got {mesh_shape!r}")
    need = shape[0] * shape[1]
    devs = [torch.device(d) for d in
            (devices if devices is not None else default_places())]
    if need > len(devs):
        raise ValueError(
            f"mesh_shape {shape} needs {need} places but only {len(devs)} "
            f"are given; pass devices= with {need} places (a device may "
            f"repeat: several places can share one card) or shrink the "
            f"mesh")
    grid = np.empty(need, dtype=object)
    for i, d in enumerate(devs[:need]):
        grid[i] = d
    return Mesh(grid.reshape(shape), axis_names)


def flat_shard_tail(padded: int, block: int, model_size: int) -> int:
    """Tail padding (elements) that makes a block-aligned flat buffer split
    across ``model_size`` shards in whole blocks.

    The flat-vector replacement for ``AxisRules.resolve``'s divisibility
    fallback: replicating a flat server-step buffer would copy the stacked
    delta rows onto every model-axis place, so ``ShardedFlatLayout`` pads
    the final shard instead and masks the tail out of the compression
    metadata (``(valid=0, k=1)`` rows)."""
    if padded % block:
        raise ValueError(f"padded={padded} is not block-aligned "
                         f"(block={block})")
    return (-padded) % (block * int(model_size))


def client_chunk_pad(n_clients: int, data_size: int) -> int:
    """Rows to append so a stacked client chunk splits evenly along the
    mesh ``data`` axis (the batched engine repeats its first client's rows
    and drops them after the step).  ``data_size=1`` always returns 0."""
    if data_size < 1:
        raise ValueError(f"data_size={data_size} must be >= 1")
    return (-int(n_clients)) % int(data_size)


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Resolved logical->mesh mapping for one mesh configuration."""
    mesh: Any
    batch: Tuple[str, ...] = ("data",)
    fsdp: Tuple[str, ...] = ("data",)
    tp: Tuple[str, ...] = ("model",)
    # sequence-parallel attention (activations' seq dim over tp)
    seq_shard: Tuple[str, ...] = ()
    cache_seq: Tuple[str, ...] = ("model",)
    logical: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=dict)

    def axis_size(self, axes: Tuple[str, ...]) -> int:
        n = 1
        for a in axes:
            n *= self.mesh.shape[a]
        return n

    def resolve(self, name: str, dim: Optional[int] = None) -> MeshAxes:
        """Logical name -> mesh axes, with divisibility fallback."""
        table: Dict[str, Tuple[str, ...]] = {
            "batch": self.batch,
            "fsdp": self.fsdp,
            "tp": self.tp,
            "experts": self.tp,
            "vocab": self.tp,
            "cache_seq": self.cache_seq,
            "seq": self.seq_shard,
            "none": (),
        }
        table.update(self.logical)
        axes = table.get(name, ())
        if not axes:
            return None
        if dim is not None and dim % self.axis_size(axes) != 0:
            return None  # divisibility fallback -> replicate
        return axes if len(axes) > 1 else axes[0]


def make_axis_rules(mesh, *, fsdp: bool = True, tp: bool = True,
                    seq_shard: bool = False,
                    extra: Optional[Dict[str, Tuple[str, ...]]] = None
                    ) -> AxisRules:
    axes = dict(mesh.shape)
    batch = tuple(a for a in ("pod", "data") if a in axes)
    return AxisRules(
        mesh=mesh,
        batch=batch or ("data",),
        fsdp=("data",) if (fsdp and "data" in axes) else (),
        tp=("model",) if (tp and "model" in axes) else (),
        seq_shard=("model",) if seq_shard else (),
        cache_seq=("model",) if "model" in axes else (),
        logical=dict(extra or {}),
    )


# --- thread-local active rules (set by the caller) --------------------------
_state = threading.local()


@contextlib.contextmanager
def use_rules(rules: Optional[AxisRules]):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def current_rules() -> Optional[AxisRules]:
    return getattr(_state, "rules", None)


def activation_spec(names: Sequence[str],
                    shape: Optional[Sequence[int]] = None,
                    rules: Optional[AxisRules] = None) -> Spec:
    rules = rules or current_rules()
    if rules is None:
        return ()
    dims = list(shape) if shape is not None else [None] * len(names)
    return tuple(rules.resolve(n, d) for n, d in zip(names, dims))


# --- the active step analysis (launch.hlo_analysis) -------------------------
_open_analyses = 0      # StepAnalysis blocks entered and not left, any thread


def analysis_opened(delta: int) -> None:
    """``StepAnalysis`` entered (+1) or left (-1)."""
    global _open_analyses
    _open_analyses += delta


def active_analysis():
    """The ``launch.hlo_analysis.StepAnalysis`` the step runs under, or
    None: at once when none is open, else found on the dispatch-mode
    stack, which autograd carries to the threads that run a backward on
    the card."""
    if not _open_analyses:
        return None
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for mode in _get_current_dispatch_mode_stack():
        if getattr(mode, "is_step_analysis", False):
            return mode
    return None


@contextlib.contextmanager
def settled_sums():
    """Under an analysis, reductions inside leave no partial sum: the
    caller records the collective they need (``record_collective`` with
    ``place_bytes``); otherwise nothing."""
    an = active_analysis()
    with (an.settled() if an is not None else contextlib.nullcontext()):
        yield


class _Pin(torch.autograd.Function):
    """``shard``'s pin on a differentiated value: an alias whose layout,
    and whose cotangent's, the analysis pins."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x, spec):
        out = x.view_as(x)
        active_analysis().pin(out, spec)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.spec = inputs[1]

    @staticmethod
    def backward(ctx, g):
        g = g.view_as(g)
        an = active_analysis()
        if an is not None:
            an.pin(g, ctx.spec)
        return g, None


def shard(x: torch.Tensor, names: Sequence[str]) -> torch.Tensor:
    """The identity (the reference's sharding constraint).  Under an
    active step analysis with rules, ``x``'s layout is pinned to
    ``activation_spec(names, x.shape)`` (a differentiated ``x`` through an
    alias whose cotangent is pinned too, as the constraint's transpose
    is); every value stays bit for bit."""
    rules = current_rules()
    an = None if rules is None else active_analysis()
    if an is None:
        return x
    spec = activation_spec(names, x.shape, rules)
    if torch.is_grad_enabled() and (
            x.requires_grad or torch._C._are_functorch_transforms_active()):
        return _Pin.apply(x, spec)
    an.pin(x, spec)
    return x


def shard_like(tree, like):
    """The identity on ``tree``; under an active step analysis each leaf
    is pinned to the layout of ``like``'s leaf of the same path (the
    gradients to their parameters', as the partitioner propagates the
    parameters' shardings to them)."""
    an = active_analysis()
    if an is None:
        return tree
    like_at = path_leaves(like)
    for path, leaf in path_leaves(tree).items():
        if isinstance(leaf, torch.Tensor):
            an.pin_like(leaf, like_at[path])
    return tree


# =============================================================================
# the collectives: one part a place of a group, in place order
# =============================================================================
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter")
_counts = threading.local()


@contextlib.contextmanager
def count_collectives():
    """Count the collectives this thread runs inside the block: yields
    ``{op: {"bytes", "count"}}`` over ``COLLECTIVES``, with ``"total"``
    added when the block ends.  Each call of ``psum`` (an all-reduce),
    ``all_gather`` and ``psum_scatter`` over more than one part counts
    once, its bytes those of what it returns (``psum_scatter``: every
    tile), as do the calls of ``record_collective``.  These are the
    collectives the port's one-controller program performs (``all_gather``
    runs once for each receiving place, ``psum`` once a group): not XLA's
    SPMD traffic, which counts each op once per device program."""
    prev = getattr(_counts, "stats", None)
    stats = {op: {"bytes": 0.0, "count": 0} for op in COLLECTIVES}
    _counts.stats = stats
    try:
        yield stats
    finally:
        _counts.stats = prev
        stats["total"] = {
            "bytes": sum(stats[op]["bytes"] for op in COLLECTIVES),
            "count": sum(stats[op]["count"] for op in COLLECTIVES)}


def record_collective(op: str, nbytes: float, axes: Tuple[str, ...] = (),
                      place_bytes=None) -> None:
    """Count one ``op`` of ``nbytes`` in the active ``count_collectives``
    block (none active: nothing); under an active step analysis, also one
    ``op`` over ``axes`` of ``place_bytes(analysis)`` per place (when
    given)."""
    stats = getattr(_counts, "stats", None)
    if stats is not None:
        stats[op]["bytes"] += float(nbytes)
        stats[op]["count"] += 1
    an = active_analysis()
    if an is not None and place_bytes is not None:
        an.record(op, axes, place_bytes(an), "explicit")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def psum(parts: Sequence[torch.Tensor],
         device: Optional[torch.device] = None) -> torch.Tensor:
    """The sum of a group's parts, added in place order on ``device`` (the
    group's first place, by default the first part's device).  One part
    comes back as it is."""
    device = parts[0].device if device is None else device
    acc = parts[0].to(device)
    for p in parts[1:]:
        acc = acc + p.to(device)
    if len(parts) > 1:
        record_collective("all-reduce", _nbytes(acc))
    return acc


def all_gather(parts: Sequence[torch.Tensor], dim: int = 0,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """The group's parts concatenated along ``dim`` (a tiled gather) on
    ``device`` (by default the first part's)."""
    device = parts[0].device if device is None else device
    if len(parts) == 1:
        return parts[0].to(device)
    out = torch.cat([p.to(device) for p in parts], dim=dim)
    record_collective("all-gather", _nbytes(out))
    return out


def psum_scatter(parts: Sequence[torch.Tensor], dim: int,
                 devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The group's parts summed in place order, then split along ``dim``
    into one equal tile a place (a tiled reduce-scatter)."""
    stats = getattr(_counts, "stats", None)
    _counts.stats = None        # the sum inside is this op, not another
    try:
        total = psum(parts, devices[0])
    finally:
        _counts.stats = stats
    if len(parts) > 1:
        record_collective("reduce-scatter", _nbytes(total))
    return [t.to(d) for t, d in
            zip(total.chunk(len(devices), dim=dim), devices)]


# =============================================================================
# parameter specs from leaf path names
# =============================================================================
# (regex on the '/'-joined path) -> logical names per dim.  First match
# with the leaf's rank wins; checked in order.
_PARAM_RULES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    # embeddings
    (r"(^|/)embed$",        ("vocab", "fsdp")),
    (r"(^|/)unembed$",      ("fsdp", "vocab")),
    (r"(^|/)patch_proj$",   ("fsdp", "none")),
    # attention
    (r"/w[qkv]$",           ("fsdp", "tp")),
    (r"/wo$",               ("tp", "fsdp")),
    # moe stacked experts (E, d, f) / (E, f, d): before the generic ffn
    # rules (same leaf names, one more dim)
    (r"/moe/w_(gate|up)$",  ("experts", "fsdp", "tp")),
    (r"/moe/w_down$",       ("experts", "tp", "fsdp")),
    # ffn
    (r"/w_(gate|up)$",      ("fsdp", "tp")),
    (r"/w_down$",           ("tp", "fsdp")),
    (r"/router$",           ("fsdp", "none")),
    # mamba2 / rg-lru
    (r"/in_proj$",          ("fsdp", "tp")),
    (r"/out_proj$",         ("tp", "fsdp")),
    (r"/conv_w$",           ("none", "tp")),
    (r"/w_in[12]$",         ("fsdp", "tp")),
    (r"/w_(r|i)$",          ("fsdp", "tp")),
    (r"/w_lru_out$",        ("tp", "fsdp")),
)


def _spec_for_leaf(path: str, shape: Tuple[int, ...],
                   rules: AxisRules) -> Spec:
    for pat, names in _PARAM_RULES:
        if re.search(pat, path):
            if len(names) != len(shape):
                continue  # rank mismatch -> try the next rule
            resolved = []
            used: set = set()
            for n, d in zip(names, shape):
                ax = rules.resolve(n, d)
                # a mesh axis may appear at most once in a spec
                flat = (ax,) if isinstance(ax, str) else (ax or ())
                if any(a in used for a in flat):
                    ax = None
                else:
                    used.update(flat)
                resolved.append(ax)
            return tuple(resolved)
    return (None,) * len(shape)


def is_spec(x) -> bool:
    """Whether ``x`` is a spec (a tuple of mesh axis names, tuples of
    them, or ``None``), not a tuple container of a tree."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def map_with_path(fn, tree, prefix: Tuple[str, ...] = (), is_leaf=None):
    """``fn('/'-joined path, leaf)`` over a tree's leaves, keeping its
    dicts, lists and tuples; the path is the one
    ``jax.tree_util.tree_flatten_with_path`` gives (a dict key as itself, a
    list or tuple index as its number).  ``is_leaf(x)`` true stops the
    descent (``is_spec`` for a tree of specs)."""
    if is_leaf is not None and is_leaf(tree):
        return fn("/".join(prefix), tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (str(k),), is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, prefix + (str(i),), is_leaf)
                          for i, v in enumerate(tree))
    return fn("/".join(prefix), tree)


def path_leaves(tree, is_leaf=None) -> Dict[str, Any]:
    """``{'/'-joined path: leaf}`` over a tree's leaves (``map_with_path``'s
    paths and ``is_leaf``)."""
    out: Dict[str, Any] = {}
    map_with_path(lambda path, leaf: out.__setitem__(path, leaf), tree,
                  is_leaf=is_leaf)
    return out


def param_pspecs(params: Any, rules: AxisRules,
                 stacked_layer_dims: int = 1) -> Any:
    """A spec tree mirroring ``params`` (each leaf's spec a tuple).

    ``stacked_layer_dims``: leaves under a path containing ``layers`` have
    that many leading stacked dims (the layer axis), which are never
    sharded."""

    def one(path: str, leaf) -> Spec:
        shape = tuple(leaf.shape)
        lead = 0
        if "layers" in path.split("/"):
            lead = min(stacked_layer_dims, len(shape))
        return (None,) * lead + _spec_for_leaf(path, shape[lead:], rules)

    return map_with_path(one, params)
