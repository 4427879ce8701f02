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
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import LAUNCHES, _build

_SIGNATURES = {
    "repro_ssd_scan": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p),
    "repro_ssd_scan_scratch": (
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)),
}
MAX_CHUNK = 128
MAX_STATE_DIM = 128


def _lib():
    return _build.load("ssd_scan", _SIGNATURES)


@functools.lru_cache(maxsize=64)
def _scratch_floats(B: int, S: int, H: int, P: int, N: int, Q: int) -> int:
    """The floats of scratch one kernel call takes at these sizes: the
    source owns the layout (``repro_ssd_scan_scratch``)."""
    floats = ctypes.c_longlong()
    _build.check_launch(_lib().repro_ssd_scan_scratch(
        B, S, H, P, N, Q, ctypes.byref(floats)), "ssd_scan scratch")
    return floats.value


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``ssd_chunked`` in PyTorch (the CPU path and the
    kernel's yardstick on the card).  The decay above the diagonal
    overflows to inf, so it is masked with ``torch.where`` before it meets
    anything (a 0/1 mask multiplied in would give inf * 0 = NaN)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:
        # dt = 0 rows: identity decay, no state contribution
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S += pad
    nc = S // Q
    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H).float()
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)

    dtA = dtc * A[None, None, None, :]
    cum = torch.cumsum(dtA, dim=2)

    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    causal = torch.ones((Q, Q), dtype=torch.bool,
                        device=x.device).tril()[None, None, :, :, None]
    M = scores[..., None] * torch.where(causal, decay, 0.0) \
        * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M.to(x.dtype), xc)

    seg_end = torch.exp(cum[:, :, -1:, :] - cum) * dtc
    states = torch.einsum("bcjh,bcjn,bcjhp->bchpn", seg_end.to(x.dtype), Bc,
                          xc)
    gamma = torch.exp(dtA.sum(dim=2))

    s = init_state if init_state is not None else torch.zeros(
        (Bsz, H, P, N), dtype=x.dtype, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(s)
        s = gamma[:, c, :, None, None].to(s.dtype) * s + states[:, c]
    y_inter = torch.einsum("bcih,bcin,bchpn->bcihp",
                           torch.exp(cum).to(x.dtype), Cc,
                           torch.stack(entering, dim=1))
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)[:, :S_orig]
    return y, s


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


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y ``(B, S, H, P)`` and the final state ``(B, H, P, N)`` of the SSD
    recurrence over x, in chunks of ``min(chunk, S)`` rows."""
    _check(x, dt, A, Bm, Cm, chunk, init_state)
    if not _build.wants_kernel(x, "ssd_scan"):
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk, init_state)
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if Q > MAX_CHUNK or N > MAX_STATE_DIM:
        raise ValueError(f"ssd_scan: the kernel takes chunks up to "
                         f"{MAX_CHUNK} rows and state dims up to "
                         f"{MAX_STATE_DIM}; got chunk {Q}, N {N}")
    # x, Bm and Cm may be views with row strides of their own (the model's
    # slices of one projection): the kernel takes those as they are
    if x.stride(3) != 1 or x.stride(2) != P:
        x = x.contiguous()
    if Bm.stride(2) != 1 or Cm.stride(2) != 1 or Bm.stride() != Cm.stride():
        Bm, Cm = Bm.contiguous(), Cm.contiguous()
    dt, A = dt.contiguous(), A.contiguous()
    init = None if init_state is None else init_state.contiguous()
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    final = torch.empty((Bsz, H, P, N), dtype=x.dtype, device=x.device)
    # the passes' scratch: chunk scores, in-chunk cumsums, the chunks' own
    # states and the states entering them
    scratch = torch.empty(_scratch_floats(Bsz, S, H, P, N, Q),
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
