"""Rowwise int8 transfer compression (counterpart of
``repro/kernels/quant_transfer``): the smashed data at the cut and the
delta wire of the server step.

Rows are the tensor's *last* axis (the reference reshapes to
``(-1, shape[-1])``), so a channels-last activation ``(B, H, W, C)``
quantizes ``B*H*W`` rows of ``C``.  ``quantize_rows`` / ``dequantize_rows``
are the kernel wrappers over a 2-D fp32 matrix (``csrc/quant_transfer.cu``);
``*_plain`` are the same functions in plain PyTorch.  ``fake_quant_int8`` is
quantize -> dequantize with a straight-through gradient.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import LAUNCHES, _build, counted, work

_PLAN_ARGS = (ctypes.c_int,) * 4   # group_log2, width, vecs, threads
_SIGNATURES = {
    "repro_quantize_rows": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_longlong, ctypes.c_int, *_PLAN_ARGS,
                            ctypes.c_void_p),
    "repro_dequantize_rows": (ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_int, *_PLAN_ARGS, ctypes.c_void_p),
}


def _lib():
    return _build.load("quant_transfer", _SIGNATURES)


# -----------------------------------------------------------------------------
# launch plans (the kernels' thread layout, chosen here and checked there)
# -----------------------------------------------------------------------------
class Plan(NamedTuple):
    """How a kernel covers an (R, C) matrix: ``group`` threads a row (a
    power of two; at most 32 share a warp, more make the whole CTA), each
    holding ``vecs`` vectors of ``width`` elements per pass over the row,
    in CTAs of ``threads``.  Vector k of pass p of thread t sits at
    ``(p * vecs + k) * group + t``."""
    group: int
    width: int
    vecs: int
    threads: int

    def args(self):
        return (self.group.bit_length() - 1, self.width, self.vecs,
                self.threads)


MAX_GROUP = 256     # threads a row and a CTA at most: the launch bounds
MAX_VECS = 8        # vectors a thread holds per pass (32 floats at width 4)
MIN_THREADS = 128


def cta_threads(group: int) -> int:
    """A group above 32 threads is the whole CTA; smaller groups share CTAs
    of MIN_THREADS."""
    return group if group > 32 else MIN_THREADS


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


@functools.lru_cache(maxsize=256)     # the wrappers plan every call
def _row_plan(C: int, width: int) -> Plan:
    """About 4 elements a thread (one float4, or 4 scalars), as many
    threads as that gives the row up to a CTA of MAX_GROUP; a longer row up
    to MAX_VECS vectors a thread; longer still, passes of MAX_GROUP x
    MAX_VECS vectors.  Of the plans that hold a row in one pass, this was
    the fastest, or within 2% of it, at each main-path shape in one sweep on
    an H100 (``scripts/quant_ablation.py --sweep``)."""
    n = -(-C // width)                     # vectors in a row
    vecs = min(max(4 // width, 1), _pow2(n))
    group = _pow2(-(-n // vecs))
    if group > MAX_GROUP:
        group, vecs = MAX_GROUP, min(MAX_VECS, _pow2(-(-n // MAX_GROUP)))
    return Plan(group, width, vecs, cta_threads(group))


def _quant_plan(C: int, data_ptr: int) -> Plan:
    """float4 loads where every row starts 16-byte aligned, else scalar."""
    return _row_plan(C, 4 if C % 4 == 0 and data_ptr % 16 == 0 else 1)


def _dequant_plan(C: int, data_ptr: int) -> Plan:
    """4 codes a load (one float4 store) where every row of ``q`` starts
    4-byte aligned, else 1; the output is the wrapper's, aligned."""
    return _row_plan(C, 4 if C % 4 == 0 and data_ptr % 4 == 0 else 1)


# -----------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the kernels' yardstick)
# -----------------------------------------------------------------------------
def quantize_rows_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    absmax = x.abs().amax(dim=-1, keepdim=True)
    # times the fp32 reciprocal of 127, as the reference's compiled program
    # computes its `/ 127.0` (the Python scalar becomes fp32 here)
    scale = torch.clamp(absmax, min=1e-12) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_rows_plain(q: torch.Tensor, scales: torch.Tensor
                          ) -> torch.Tensor:
    return q.to(torch.float32) * scales[:, None]


# -----------------------------------------------------------------------------
# the written counts (per call; ``kernels.counted`` records them)
# -----------------------------------------------------------------------------
def quantize_work(x) -> Dict[str, float]:
    """Quantize at x ``(R, C)``: an abs, a max, a divide, a round and a
    clamp an element; the fp32 rows read, the codes and scales written."""
    R, C = x
    return work(5 * R * C, 0, 4 * R * C + R * C + 4 * R, 0)


def dequantize_work(q) -> Dict[str, float]:
    """Dequantize at q ``(R, C)``: a product an element; the codes and
    scales read, the fp32 rows written."""
    R, C = q
    return work(R * C, 0, R * C + 4 * R + 4 * R * C, 0)


# -----------------------------------------------------------------------------
# kernel wrappers
# -----------------------------------------------------------------------------
def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` (R, C) fp32 contiguous -> (int8 codes (R, C), fp32 scales
    (R,)); counted as ``quantize_work``."""
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"quantize_rows takes a contiguous 2-D float32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)} "
                         f"contiguous={x.is_contiguous()}")
    return counted("quantize", quantize_work, (x,),
                   lambda: _run_quantize(x))


def _run_quantize(x):
    if not _build.wants_kernel(x, "quantize_rows"):
        return quantize_rows_plain(x)
    R, C = x.shape
    q = torch.empty((R, C), dtype=torch.int8, device=x.device)
    s = torch.empty((R,), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return q, s
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check_launch(_lib().repro_quantize_rows(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), R, C,
            *_quant_plan(C, x.data_ptr()).args(), stream),
            "quantize_rows")
    LAUNCHES["quantize"] += 1
    return q, s


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 ``q`` (R, C) and fp32 ``scales`` (R,) -> fp32 (R, C); counted
    as ``dequantize_work``."""
    if q.dim() != 2 or q.dtype != torch.int8 or not q.is_contiguous():
        raise ValueError(f"dequantize_rows takes contiguous 2-D int8 codes, "
                         f"got {q.dtype} {tuple(q.shape)}")
    if (scales.shape != (q.shape[0],) or scales.dtype != torch.float32
            or not scales.is_contiguous() or scales.device != q.device):
        raise ValueError(f"dequantize_rows needs contiguous float32 scales of "
                         f"shape ({q.shape[0]},) on {q.device}, got "
                         f"{scales.dtype} {tuple(scales.shape)} on "
                         f"{scales.device}")
    return counted("dequantize", lambda qs, _s: dequantize_work(qs),
                   (q, scales), lambda: _run_dequantize(q, scales))


def _run_dequantize(q, scales):
    if not _build.wants_kernel(q, "dequantize_rows"):
        return dequantize_rows_plain(q, scales)
    R, C = q.shape
    out = torch.empty((R, C), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.check_launch(_lib().repro_dequantize_rows(
            q.data_ptr(), scales.data_ptr(), out.data_ptr(), R, C,
            *_dequant_plan(C, q.data_ptr()).args(), stream),
            "dequantize_rows")
    LAUNCHES["dequantize"] += 1
    return out


# -----------------------------------------------------------------------------
# any-shape entry points (the reference's ops.quantize / ops.dequantize)
# -----------------------------------------------------------------------------
def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Any-shape fp32 tensor -> (int8 same shape, fp32 scales over the
    leading dims)."""
    shape = x.shape
    q, s = quantize_rows(x.reshape(-1, shape[-1]).contiguous())
    return q.reshape(shape), s.reshape(shape[:-1])


def dequantize(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    shape = q.shape
    out = dequantize_rows(q.reshape(-1, shape[-1]).contiguous(),
                          scales.reshape(-1).contiguous())
    return out.reshape(shape)


class _FakeQuantInt8(torch.autograd.Function):
    @staticmethod
    def forward(x):
        q, s = quantize(x)
        return dequantize(q, s)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g   # straight-through, as the reference's custom_vjp

    @staticmethod
    def vmap(info, in_dims, x):
        """Under ``torch.func.vmap`` (the batched engine's clients): the
        rows are the last axis, quantized one by one, so the clients' rows
        go through one call over the stacked tensor, as the kernels see
        plain tensors and never a batched one."""
        if in_dims[0] is None:
            return _FakeQuantInt8.apply(x), None
        return _FakeQuantInt8.apply(x.movedim(in_dims[0], 0)), 0


def fake_quant_int8(x: torch.Tensor) -> torch.Tensor:
    """Quant + dequant with a straight-through gradient: what the model sees
    when the smashed data crosses the cut as int8."""
    return _FakeQuantInt8.apply(x)
