"""Flash attention (counterpart of ``repro/kernels/flash_attention``): the
attention of every prefill layer of the port's transformer.

``flash_attention`` takes the model's layout, q ``(B, Sq, H, D)`` and k/v
``(B, Sk, KV, D)``, fp32 or bf16, and returns ``(B, Sq, H, D)`` in q's
dtype.  Causal positions start at 0 for q and for k (the reference kernel
takes no query offset); ``window > 0`` keeps keys in ``(q - window, q]``;
``softcap > 0`` applies ``cap * tanh(s / cap)`` to the scaled scores before
the mask; query head ``h`` reads KV head ``h // (H // KV)``.  Everything
inside runs in fp32.  A CUDA tensor launches the hand-written kernel
(``csrc/flash_attention.cu``); a CPU tensor takes ``attention_plain``, the
semantics of the reference's ``ref.attention_ref`` (a row that sees no key
comes out 0).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import LAUNCHES, _build

_SIGNATURES = {
    "repro_flash_attention": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def _lib():
    return _build.load("flash_attention", _SIGNATURES)


def visible_mask(Sq: int, Sk: int, causal: bool, window: int,
                 device=None) -> torch.Tensor:
    """Boolean ``(Sq, Sk)``: which key each query sees."""
    q_pos = torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return mask


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Materialized-scores attention with the kernel's semantics (the CPU
    path and the kernel's yardstick on the card)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(D)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    mask = visible_mask(Sq, k.shape[1], causal, window, q.device)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B, Sq, H, D) and k, v "
                         f"(B, Sk, KV, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2] != 0:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} (same B and D, H a "
                         f"multiple of KV)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16 q, k, v "
                         f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must share a device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Attention of q ``(B, Sq, H, D)`` over k, v ``(B, Sk, KV, D)``."""
    _check(q, k, v)
    if not _build.wants_kernel(q, "flash_attention"):
        return attention_plain(q, k, v, causal, window, softcap)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {D} > {MAX_HEAD_DIM}")
    if q.numel() == 0 or Sk == 0:
        return torch.zeros_like(q)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.check_launch(_lib().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, KV, D, int(bool(causal)), int(window), float(softcap),
            _DTYPES[q.dtype], stream), "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
