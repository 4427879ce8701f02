"""Chunked SSD scan (counterpart of ``repro/kernels/ssd_scan``): the
sequence mixing of every mamba2 prefill layer.

``ssd_scan(x, dt, A, Bm, Cm, chunk, init_state=None) -> (y, final_state)``
takes the layout of the model's ``ssd_chunked``: x ``(B, S, H, P)``, dt
``(B, S, H)`` after the softplus, A ``(H,)`` negative, Bm and Cm ``(B, S,
N)``, an optional ``(B, H, P, N)`` entering state; it returns y ``(B, S,
H, P)`` and the ``(B, H, P, N)`` state after the last row.  Chunks are
``min(chunk, S)`` rows, the last one ragged.  Everything is float32.  A
CUDA tensor launches the hand-written kernel (``csrc/ssd_scan.cu``: a
chunk-parallel scan of four device kernels per call, over one scratch
buffer this wrapper allocates at the size the source asks for;
``LAUNCHES`` counts the call once); a CPU tensor takes
``ssd_scan_plain``, the chunked form of the reference's ``ssd_chunked`` in
PyTorch.  ``ssd_sequential`` is the recurrence itself
(the reference's ``ref.ssd_sequential``), for tests and drills.

With grad enabled and an input that requires it, ``ssd_scan`` goes
through ``_SSDScan``, whose backward is ``ssd_scan_bwd``: on a CUDA tensor
the hand-written backward in the same source (``LAUNCHES["ssd_scan_bwd"]``
counts its call once), on a CPU tensor ``ssd_scan_bwd_plain``, the same
passes in torch ops, called through a Function of its own
(``_SSDScanBwd``).  The gradient is float32 only, as the forward.  Both
Functions run under ``torch.func`` (``vmap(grad(...))``, the batched fleet
engine) through ``vmap`` rules that call the Function once per vmapped
client: a kernel call takes one ``A`` for its whole batch and sums ``dA``
over it, while each client holds its own ``A`` (a parameter) and needs its
own ``dA``, so the clients cannot share a call as flash attention's do.
The reference has no backward kernel: JAX differentiates its jnp
``ssd_chunked``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import LAUNCHES, _build, counted, work

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# B, S, H, P, N, Q; x's batch and row strides, Bm's and Cm's; the stream
_SHAPE = (_I,) * 6 + (_L,) * 4 + (_P,)
_SCRATCH = (_I,) * 6 + (ctypes.POINTER(ctypes.c_longlong),)
_SIGNATURES = {
    # x, dt, A, Bm, Cm, init, y, final state, scratch
    "repro_ssd_scan": (_P,) * 9 + _SHAPE,
    "repro_ssd_scan_scratch": _SCRATCH,
    # x, dt, A, Bm, Cm, init, dy, dfinal, dx, ddt, dA, dBm, dCm, dinit,
    # scratch
    "repro_ssd_scan_bwd": (_P,) * 15 + _SHAPE,
    "repro_ssd_scan_bwd_scratch": _SCRATCH,
}
MAX_CHUNK = 128
MAX_STATE_DIM = 128


def _lib():
    return _build.load("ssd_scan", _SIGNATURES)


@functools.lru_cache(maxsize=64)
def _scratch_floats(query: str, B: int, S: int, H: int, P: int, N: int,
                    Q: int) -> int:
    """The floats of scratch one call takes at these sizes: the source owns
    the layout (``repro_ssd_scan_scratch``, ``repro_ssd_scan_bwd_scratch``)."""
    floats = ctypes.c_longlong()
    _build.check_launch(getattr(_lib(), query)(
        B, S, H, P, N, Q, ctypes.byref(floats)), query)
    return floats.value


# -----------------------------------------------------------------------------
# the written counts (per call; ``kernels.counted`` records them)
# -----------------------------------------------------------------------------
def _ssd_terms(x, N: int, chunk: int):
    """(products, elementwise, transcendentals) of the chunked forward at
    x ``(B, S, H, P)``: per (batch, chunk of q rows) C.B^T over the
    chunk's ``t = q (q + 1) / 2`` causal (j <= i) pairs
    (``2 t N``: the least the function needs, not the full (q, q) product
    XLA counts in the reference's masked jnp ``ssd_chunked``; the flash
    counts' convention), and per head the decay-weighted product with x
    (``2 t P``), the entering state's term and the chunk's own state
    (``2 q N P`` each); the decay (a difference and a product a causal
    pair and head, an ``exp``), the prefix sums, weights and the state
    pass."""
    B, S, H, P = x
    Q = min(chunk, S)
    prod = elem = trans = 0
    for s0 in range(0, S, Q):
        q = min(Q, S - s0)
        t = q * (q + 1) // 2
        prod += B * (2 * t * N + H * (2 * t * P + 4 * q * N * P))
        elem += B * H * (2 * t + 4 * q + q * P + 2 * P * N)
        trans += B * H * (t + 2 * q + 1)
    return prod, elem, trans


def ssd_scan_work(x, Bm, init=None, chunk: int = MAX_CHUNK
                  ) -> Dict[str, float]:
    """The forward at x ``(B, S, H, P)``, Bm ``(B, S, N)`` shapes
    (``_ssd_terms``); x, dt, A, Bm, Cm (and the entering state) read,
    y and the final state written once (fp32)."""
    B, S, H, P = x
    N = Bm[-1]
    prod, elem, trans = _ssd_terms(x, N, chunk)
    nbytes = 4 * (2 * B * S * H * P + B * S * H + H + 2 * B * S * N
                  + (2 if init is not None else 1) * B * H * P * N)
    return work(prod + elem, prod, nbytes, trans)


def ssd_scan_bwd_work(x, Bm, init=None, chunk: int = MAX_CHUNK,
                      dfinal: bool = False) -> Dict[str, float]:
    """The backward: the gradient's two products for each of the
    forward's (both operands') and twice its elementwise work, its
    transcendentals once (the forward's intermediates the kernel
    recomputes are not counted: the gradient of the reference's
    differentiated ``ssd_chunked``); the inputs and dy (and dfinal) read,
    every gradient written once (fp32)."""
    B, S, H, P = x
    N = Bm[-1]
    prod, elem, trans = _ssd_terms(x, N, chunk)
    states = (2 if init is not None else 0) + (1 if dfinal else 0)
    nbytes = 4 * (2 * (2 * B * S * H * P + B * S * H + H + 2 * B * S * N)
                  + B * S * H * P + states * B * H * P * N)
    return work(2 * (prod + elem), 2 * prod, nbytes, trans)


def _chunked(Q: int, *rows: torch.Tensor):
    """Each (B, S, ...) tensor padded with zero rows to a multiple of Q
    (dt = 0 rows: identity decay, no state contribution) and reshaped to
    (B, nc, Q, ...)."""
    out = []
    for t in rows:
        pad = -t.shape[1] % Q
        if pad:
            t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        out.append(t.reshape(t.shape[0], t.shape[1] // Q, Q, *t.shape[2:]))
    return out


def _decay(cum: torch.Tensor) -> torch.Tensor:
    """``exp(cum_i - cum_j)`` for ``j <= i`` and 0 above the diagonal,
    (B, nc, i, j, H) from cum (B, nc, Q, H).  Above the diagonal the
    difference is positive and its exp overflows, so the exponent is
    masked to -inf before it meets ``exp``: a mask applied after it gives
    inf * 0 = NaN in the gradient (the reference's ``where`` after ``exp``
    does, ROADMAP queue 3)."""
    Q = cum.shape[2]
    causal = torch.ones((Q, Q), dtype=torch.bool,
                        device=cum.device).tril()[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    return torch.exp(torch.where(causal, diff, float("-inf")))


def _forward_passes(x, dt, A, Bm, Cm, Q, init_state):
    """The chunked form's pieces over chunks of Q rows, in the kernel's
    notation: xc, dtc, Bc, Cc (B, nc, Q, ...); cum, the in-chunk prefix sum
    of dt * A (B, nc, Q, H); CB = C.B^T (B, nc, i, j, 1); L_ij = exp(cum_i
    - cum_j) for j <= i (``_decay``); w_j = exp(cum_last - cum_j) dt_j;
    gamma = exp(cum_last) (B, nc, H); the states entering each chunk (B,
    nc, H, P, N), from ``init_state`` or 0; the final state."""
    Bsz, _, H, P = x.shape
    xc, dtc, Bc, Cc = _chunked(Q, x, dt, Bm, Cm)
    cum = torch.cumsum(dtc * A, dim=2)
    last = cum[:, :, -1:]
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[..., None]
    w = torch.exp(last - cum) * dtc
    gamma = torch.exp(last[:, :, 0])
    states = torch.einsum("bcjh,bcjn,bcjhp->bchpn", w, Bc, xc)
    s = init_state if init_state is not None else x.new_zeros(
        Bsz, H, P, Bm.shape[-1])
    entering = []
    for c in range(xc.shape[1]):
        entering.append(s)
        s = gamma[:, c, :, None, None] * s + states[:, c]
    return (xc, dtc, Bc, Cc, cum, CB, _decay(cum), w, gamma,
            torch.stack(entering, dim=1), s)


def _rows(t: torch.Tensor, S: int) -> torch.Tensor:
    """(B, nc, Q, ...) back to the (B, S, ...) rows, padding dropped."""
    return t.reshape(t.shape[0], -1, *t.shape[3:])[:, :S]


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``ssd_chunked`` in PyTorch (the CPU path and the
    kernel's yardstick on the card), its decay above the diagonal masked
    before ``exp`` (``_decay``), so autograd through it stays finite."""
    xc, dtc, _, Cc, cum, CB, L, _, _, S_in, final = _forward_passes(
        x, dt, A, Bm, Cm, min(chunk, x.shape[1]), init_state)
    y = torch.einsum("bcijh,bcjhp->bcihp", CB * L * dtc[:, :, None], xc) \
        + torch.einsum("bcih,bcin,bchpn->bcihp", torch.exp(cum), Cc, S_in)
    return _rows(y, x.shape[1]), final


def ssd_scan_bwd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                       init_state: Optional[torch.Tensor], dy: torch.Tensor,
                       dfinal: Optional[torch.Tensor] = None):
    """The gradient of ``ssd_scan`` by the kernel's passes in torch ops
    (the CPU's backward and the kernel's yardstick on the card): ``(dx,
    ddt, dA, dBm, dCm, dinit)`` from the inputs, y's gradient ``dy`` and
    the final state's ``dfinal`` (None: unused, as in training).  ``dinit``
    is None without an ``init_state``.

    Per (batch, chunk, head), cum the in-chunk prefix sum of dt * A, L_ij =
    exp(cum_i - cum_j) for j <= i, w_j = exp(cum_last - cum_j) dt_j, e_i =
    exp(cum_i), gamma = exp(cum_last), and G_c the gradient of the state
    leaving chunk c (dfinal or 0 for the last):
      1. D_c = (e o dy)^T . C, the chunk's own part of the entering state's
         gradient;
      2. dS_enter[c] = gamma_c G_c + D_c, walked from the last chunk back,
         G_{c-1} = dS_enter[c] and dinit = dS_enter[0];
      3. with M_ij = CB_ij L_ij dt_j and dM_ij = dy_i . x_j: dx_j = sum_i
         M_ij dy_i + w_j (G_c B_j); dCB_ij = sum_h L_ij dt_j dM_ij, so dC =
         dCB.B + sum_h e o (dy.S), dB = dCB^T.C + sum_h w o (x.G); dt_j as a
         factor of M and w; d cum from the intra, inter and state terms and
         gamma <G_c, S_enter[c]> on cum_last, summed back into d(dt * A) by
         a reversed prefix sum, which gives the rest of ddt and dA."""
    S = x.shape[1]
    Q = min(chunk, S)
    xc, dtc, Bc, Cc, cum, CB, L, w, gamma, S_in, _ = _forward_passes(
        x, dt, A, Bm, Cm, Q, init_state)
    (dyc,) = _chunked(Q, dy)
    e = torch.exp(cum)
    # 1-2. the chunks' own state gradients, then the reversed state pass
    D = torch.einsum("bcih,bcin,bcihp->bchpn", e, Cc, dyc)
    g = dfinal if dfinal is not None else torch.zeros_like(S_in[:, 0])
    leaving = [None] * xc.shape[1]
    for c in reversed(range(xc.shape[1])):
        leaving[c] = g
        g = gamma[:, c, :, None, None] * g + D[:, c]
    G = torch.stack(leaving, dim=1)                      # (B, nc, H, P, N)
    # 3. the chunk gradients
    dM = torch.einsum("bcihp,bcjhp->bcijh", dyc, xc)
    M = CB * L * dtc[:, :, None]
    U = torch.einsum("bcjn,bchpn->bcjhp", Bc, G)         # G_c B_j
    V = torch.einsum("bcin,bchpn->bcihp", Cc, S_in)      # S_enter C_i
    dx = torch.einsum("bcijh,bcihp->bcjhp", M, dyc) + w[..., None] * U
    dw = (xc * U).sum(-1)                                # (B, nc, Q, H)
    de = (dyc * V).sum(-1)
    T = M * dM
    dcum = T.sum(3) - T.sum(2) - w * dw + e * de
    dcum[:, :, -1] += (w * dw).sum(2) + gamma * (G * S_in).sum((-2, -1))
    da = dcum.flip(2).cumsum(2).flip(2)                  # d(dt * A)
    ddt = (CB * L * dM).sum(2) + torch.exp(cum[:, :, -1:] - cum) * dw \
        + da * A
    dA = (da * dtc).sum((0, 1, 2))
    dcb = (L * dM * dtc[:, :, None]).sum(-1)             # (B, nc, i, j)
    dC = torch.einsum("bcij,bcjn->bcin", dcb, Bc) + torch.einsum(
        "bcih,bcihp,bchpn->bcin", e, dyc, S_in)
    dB = torch.einsum("bcij,bcin->bcjn", dcb, Cc) + torch.einsum(
        "bcjh,bcjhp,bchpn->bcjn", w, xc, G)
    return (_rows(dx, S), _rows(ddt, S), dA, _rows(dB, S), _rows(dC, S),
            g if init_state is not None else None)


def ssd_sequential(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The O(S) recurrence from a zero state, one row at a time: the
    definitional ground truth (the reference's ``ref.ssd_sequential``)."""
    Bsz, S, H, P = x.shape
    state = torch.zeros((Bsz, H, P, Bm.shape[-1]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(S):
        dtt = dt[:, t].float()
        decay = torch.exp(dtt * A)[..., None, None]
        upd = torch.einsum("bh,bn,bhp->bhpn", dtt, Bm[:, t].float(),
                           x[:, t].float())
        state = decay * state + upd
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t].float(), state))
    return torch.stack(ys, dim=1).to(x.dtype), state.to(x.dtype)


def _check(x, dt, A, Bm, Cm, chunk, init_state) -> None:
    if x.dim() != 4:
        raise ValueError(f"ssd_scan takes x (B, S, H, P); got "
                         f"{tuple(x.shape)}")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    want = {"dt": (dt, (Bsz, S, H)), "A": (A, (H,)), "Bm": (Bm, (Bsz, S, N)),
            "Cm": (Cm, (Bsz, S, N))}
    if init_state is not None:
        want["init_state"] = (init_state, (Bsz, H, P, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_scan: {name} is {tuple(t.shape)}, x "
                             f"{tuple(x.shape)} needs {shape}")
    tensors = [x] + [t for t, _ in want.values()]
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"ssd_scan takes float32 tensors; got "
                         f"{[t.dtype for t in tensors]}")
    if any(t.device != x.device for t in tensors):
        raise ValueError("ssd_scan: every input must lie on x's device")
    if S < 1 or chunk < 1:
        raise ValueError(f"ssd_scan: sequence {S} and chunk {chunk} must be "
                         f">= 1")


def _kernel_layout(x, Bm, Cm, chunk):
    """Check the kernel's limits; x, Bm and Cm as the kernel reads them.
    They may be views with row strides of their own (the model's slices of
    one projection): the kernel takes those as they are."""
    Bsz, S, H, P = x.shape
    N, Q = Bm.shape[-1], min(chunk, S)
    if Q > MAX_CHUNK or N > MAX_STATE_DIM:
        raise ValueError(f"ssd_scan: the kernel takes chunks up to "
                         f"{MAX_CHUNK} rows and state dims up to "
                         f"{MAX_STATE_DIM}; got chunk {Q}, N {N}")
    if x.stride(3) != 1 or x.stride(2) != P:
        x = x.contiguous()
    if Bm.stride(2) != 1 or Cm.stride(2) != 1 or Bm.stride() != Cm.stride():
        Bm, Cm = Bm.contiguous(), Cm.contiguous()
    return x, Bm, Cm, Q


def _forward(x, dt, A, Bm, Cm, chunk, init_state):
    """y and the final state: the kernel on a CUDA tensor (counted once),
    ``ssd_scan_plain`` on a CPU one; counted as ``ssd_scan_work``."""
    return counted(
        "ssd_scan", lambda xs, _dt, _a, bs, _c, init: ssd_scan_work(
            xs, bs, init, chunk), (x, dt, A, Bm, Cm, init_state),
        lambda: _run_forward(x, dt, A, Bm, Cm, chunk, init_state))


def _run_forward(x, dt, A, Bm, Cm, chunk, init_state):
    if not _build.wants_kernel(x, "ssd_scan"):
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk, init_state)
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    x, Bm, Cm, Q = _kernel_layout(x, Bm, Cm, chunk)
    dt, A = dt.contiguous(), A.contiguous()
    init = None if init_state is None else init_state.contiguous()
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    final = torch.empty((Bsz, H, P, N), dtype=x.dtype, device=x.device)
    # the passes' scratch: chunk scores, in-chunk cumsums, the chunks' own
    # states and the states entering them
    scratch = torch.empty(_scratch_floats("repro_ssd_scan_scratch", Bsz, S,
                                          H, P, N, Q),
                          dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check_launch(_lib().repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), None if init is None else init.data_ptr(),
            y.data_ptr(), final.data_ptr(), scratch.data_ptr(), Bsz, S, H, P,
            N, Q, x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1),
            stream),
            "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    return y, final


def _per_example(fn, n, in_dims, args):
    """``fn`` once per vmapped example ``i`` of ``args`` (a tensor's
    ``select(dim, i)``, an unbatched one or a non-tensor as it is), the
    results stacked on a new axis 0 (a None result stays None)."""
    outs = [fn(*[a if d is None else a.select(d, i)
                 for a, d in zip(args, in_dims)]) for i in range(n)]
    res = tuple(None if o[0] is None else torch.stack(o) for o in zip(*outs))
    return res, tuple(None if r is None else 0 for r in res)


class _SSDScan(torch.autograd.Function):
    """The SSD scan with its gradient: saves the inputs alone (the
    backward recomputes the chunk scores, cumsums and entering states, so
    a remat layer keeps nothing more); the backward is ``_SSDScanBwd``,
    its ``dfinal`` None when the final state is unused."""

    @staticmethod
    def forward(x, dt, A, Bm, Cm, chunk, init_state):
        return _forward(x, dt, A, Bm, Cm, chunk, init_state)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dt, A, Bm, Cm, chunk, init_state = inputs
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state)
        ctx.chunk = chunk

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, Bm, Cm, init_state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddt, dA, dBm, dCm, dinit = _SSDScanBwd.apply(
            x, dt, A, Bm, Cm, ctx.chunk, init_state, dy, dfinal)
        return dx, ddt, dA, dBm, dCm, None, dinit

    @staticmethod
    def vmap(info, in_dims, *args):
        """One call a vmapped client: each holds its own ``A`` (a
        parameter), and a kernel call takes one ``A`` for its batch."""
        return _per_example(_SSDScan.apply, info.batch_size, in_dims, args)


class _SSDScanBwd(torch.autograd.Function):
    """``ssd_scan_bwd`` as a Function, so that ``torch.func`` runs it
    through its ``vmap`` rule (one call a client: each needs its own
    ``dA``) rather than batching the kernel's raw pointers.  No second
    derivative."""

    @staticmethod
    def forward(x, dt, A, Bm, Cm, chunk, init_state, dy, dfinal):
        return ssd_scan_bwd(x, dt, A, Bm, Cm, chunk, init_state, dy, dfinal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the SSD scan has no second derivative")

    @staticmethod
    def vmap(info, in_dims, *args):
        return _per_example(_SSDScanBwd.apply, info.batch_size, in_dims,
                            args)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y ``(B, S, H, P)`` and the final state ``(B, H, P, N)`` of the SSD
    recurrence over x, in chunks of ``min(chunk, S)`` rows; differentiable
    (``_SSDScan``) when grad is enabled and an input requires it, and
    ``_SSDScan`` too with grad off under a ``torch.func`` transform (a
    rematerialised layer's first run inside ``vmap``: batched operands,
    which its ``vmap`` rule hands the kernel a client at a time).  On
    ``meta`` (abstract evaluation: shapes and dtypes alone) it is
    the same path over fp32 casts, y and the state cast back to x's
    dtype, as the reference's bf16 ``ssd_chunked`` returns them."""
    if x.device.type == "meta" and x.dtype != torch.float32:
        f32 = [None if t is None else t.float()
               for t in (x, dt, A, Bm, Cm, init_state)]
        y, final = ssd_scan(*f32[:5], chunk, f32[5])
        return y.to(x.dtype), final.to(x.dtype)
    _check(x, dt, A, Bm, Cm, chunk, init_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, init_state)):
        return _SSDScan.apply(x, dt, A, Bm, Cm, chunk, init_state)
    if torch._C._are_functorch_transforms_active():
        return _SSDScan.apply(x, dt, A, Bm, Cm, chunk, init_state)
    return _forward(x, dt, A, Bm, Cm, chunk, init_state)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                 init_state: Optional[torch.Tensor], dy: torch.Tensor,
                 dfinal: Optional[torch.Tensor] = None):
    """``(dx, ddt, dA, dBm, dCm, dinit)``, the gradient of ``ssd_scan`` at
    these inputs from y's gradient ``dy`` (B, S, H, P) and the final
    state's ``dfinal`` (B, H, P, N; None skips it); ``dinit`` is None
    without an ``init_state``.  Each has its input's shape, float32.  A
    CUDA tensor launches the hand-written backward (``csrc/ssd_scan.cu``:
    the forward's first three passes again, then six backward kernels;
    ``LAUNCHES["ssd_scan_bwd"]`` counts the call once); a CPU tensor takes
    ``ssd_scan_bwd_plain``.  Counted as ``ssd_scan_bwd_work``."""
    _check(x, dt, A, Bm, Cm, chunk, init_state)
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(dy.shape) != (Bsz, S, H, P) or (
            dfinal is not None and tuple(dfinal.shape) != (Bsz, H, P, N)):
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} and dfinal "
                         f"{None if dfinal is None else tuple(dfinal.shape)} "
                         f"do not match x {tuple(x.shape)}, N {N}")
    grads = [dy] + ([] if dfinal is None else [dfinal])
    if any(t.dtype != torch.float32 or t.device != x.device for t in grads):
        raise ValueError("ssd_scan_bwd: dy and dfinal must be float32 on x's "
                         "device (the gradient is float32 only)")
    return counted(
        "ssd_scan_bwd", lambda xs, _dt, _a, bs, _c, init, _dy, dfin:
        ssd_scan_bwd_work(xs, bs, init, chunk, dfin is not None),
        (x, dt, A, Bm, Cm, init_state, dy, dfinal),
        lambda: _run_bwd(x, dt, A, Bm, Cm, chunk, init_state, dy, dfinal))


def _run_bwd(x, dt, A, Bm, Cm, chunk, init_state, dy, dfinal):
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if not _build.wants_kernel(x, "ssd_scan_bwd"):
        return ssd_scan_bwd_plain(x, dt, A, Bm, Cm, chunk, init_state, dy,
                                  dfinal)
    x, Bm, Cm, Q = _kernel_layout(x, Bm, Cm, chunk)
    dt, A, dy = dt.contiguous(), A.contiguous(), dy.contiguous()
    init = None if init_state is None else init_state.contiguous()
    dfin = None if dfinal is None else dfinal.contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((Bsz, S, H, P), **f32)
    ddt = torch.empty((Bsz, S, H), **f32)
    dA = torch.empty((H,), **f32)
    dBm = torch.empty((Bsz, S, N), **f32)
    dCm = torch.empty((Bsz, S, N), **f32)
    dinit = None if init is None else torch.empty((Bsz, H, P, N), **f32)
    # the forward passes' scratch, then the backward's: the chunks' state
    # gradients, the per-head score gradients and their sum over heads, the
    # rows' e and w, the per-chunk dA terms, the head groups' dB and dC
    scratch = torch.empty(_scratch_floats("repro_ssd_scan_bwd_scratch", Bsz,
                                          S, H, P, N, Q), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check_launch(_lib().repro_ssd_scan_bwd(
            ptr(x), ptr(dt), ptr(A), ptr(Bm), ptr(Cm), ptr(init), ptr(dy),
            ptr(dfin), ptr(dx), ptr(ddt), ptr(dA), ptr(dBm), ptr(dCm),
            ptr(dinit), ptr(scratch), Bsz, S, H, P, N, Q, x.stride(0),
            x.stride(1), Bm.stride(0), Bm.stride(1), stream),
            "ssd_scan_bwd")
    LAUNCHES["ssd_scan_bwd"] += 1
    return dx, ddt, dA, dBm, dCm, dinit
