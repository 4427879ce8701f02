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
from typing import Tuple

import torch

from repro_torch.kernels import LAUNCHES, _build

_SIGNATURES = {
    "repro_quantize_rows": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p),
    "repro_dequantize_rows": (ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_int, ctypes.c_void_p),
}


def _lib():
    return _build.load("quant_transfer", _SIGNATURES)


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
# kernel wrappers
# -----------------------------------------------------------------------------
def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` (R, C) fp32 contiguous -> (int8 codes (R, C), fp32 scales
    (R,))."""
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"quantize_rows takes a contiguous 2-D float32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)} "
                         f"contiguous={x.is_contiguous()}")
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
            x.data_ptr(), q.data_ptr(), s.data_ptr(), R, C, stream),
            "quantize_rows")
    LAUNCHES["quantize"] += 1
    return q, s


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 ``q`` (R, C) and fp32 ``scales`` (R,) -> fp32 (R, C)."""
    if q.dim() != 2 or q.dtype != torch.int8 or not q.is_contiguous():
        raise ValueError(f"dequantize_rows takes contiguous 2-D int8 codes, "
                         f"got {q.dtype} {tuple(q.shape)}")
    if (scales.shape != (q.shape[0],) or scales.dtype != torch.float32
            or not scales.is_contiguous() or scales.device != q.device):
        raise ValueError(f"dequantize_rows needs contiguous float32 scales of "
                         f"shape ({q.shape[0]},) on {q.device}, got "
                         f"{scales.dtype} {tuple(scales.shape)} on "
                         f"{scales.device}")
    if not _build.wants_kernel(q, "dequantize_rows"):
        return dequantize_rows_plain(q, scales)
    R, C = q.shape
    out = torch.empty((R, C), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.check_launch(_lib().repro_dequantize_rows(
            q.data_ptr(), scales.data_ptr(), out.data_ptr(), R, C, stream),
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
    def forward(ctx, x):
        q, s = quantize(x)
        return dequantize(q, s)

    @staticmethod
    def backward(ctx, g):
        return g   # straight-through, as the reference's custom_vjp


def fake_quant_int8(x: torch.Tensor) -> torch.Tensor:
    """Quant + dequant with a straight-through gradient: what the model sees
    when the smashed data crosses the cut as int8."""
    return _FakeQuantInt8.apply(x)
