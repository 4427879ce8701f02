"""Flash attention (counterpart of ``repro/kernels/flash_attention``): the
attention of every full-sequence layer of the port's models, and its
gradient.

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

With grad enabled and an input that requires it, the call goes through
``_FlashAttention``: the forward also keeps each row's log-sum-exp, and the
backward is ``flash_attention_bwd`` (two kernels on the card, dq then
dk/dv; ``attention_bwd_plain`` on the CPU), fp32 only, called through a
Function of its own (``_FlashAttentionBwd``).  Both Functions run under
``torch.func`` (``vmap(grad(...))``, the batched fleet engine): each has a
``vmap`` rule that folds the clients into the batch axis B, so one launch
serves every client.  The reference has no backward kernel: JAX
differentiates its jnp attention.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import LAUNCHES, _build, counted, work

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# B, Sq, Sk, H, KV, D, causal, window, softcap
_SHAPE = (_I,) * 8 + (_F,)
_SIGNATURES = {
    "repro_flash_attention": (_P,) * 5 + _SHAPE + (_I, _P),
    "repro_flash_attention_bwd_dq": (_P,) * 8 + _SHAPE + (_P,),
    "repro_flash_attention_bwd_dkdv": (_P,) * 8 + _SHAPE + (_P,),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def _lib():
    return _build.load("flash_attention", _SIGNATURES)


# -----------------------------------------------------------------------------
# the written counts (per call; ``kernels.counted`` records them)
# -----------------------------------------------------------------------------
# Causal and windowed attention count the pairs the mask leaves visible
# (``visible_pairs``), the least work the function needs (the kernels'
# tiles skip the masked ones), not the reference's full (Sq, Sk)
# products: one convention for the forward, both backward kernels and the
# bounds derived from them.
@functools.lru_cache(maxsize=256)
def visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs ``visible_mask`` leaves: query ``i`` sees
    keys up to ``i`` (causal, else all ``Sk``), and above ``i - window``
    (``window > 0``)."""
    n = 0
    for i in range(Sq):
        hi = min(i, Sk - 1) if causal else Sk - 1
        lo = max(0, i - window + 1) if window > 0 else 0
        n += max(0, hi - lo + 1)
    return n


def flash_attention_work(q, k, causal: bool = False, window: int = 0,
                         itemsize: int = 4, lse: bool = False,
                         softcap: float = 0.0) -> Dict[str, float]:
    """The forward at q ``(B, Sq, H, D)``, k ``(B, Sk, KV, D)`` shapes:
    S = QK^T and PV (``4 D`` a visible pair of each of ``B H`` heads); a
    scale, max, difference and sum a visible score (a softcap's two more
    and a tanh), an ``exp`` a visible score and a divide an output
    element; q, k, v read and the output (and the fp32 lse) written
    once."""
    B, Sq, H, D = q
    Sk, KV = k[1], k[2]
    pairs = B * H * visible_pairs(Sq, Sk, bool(causal), int(window))
    capped = softcap > 0
    return work(4 * pairs * D + (4 + 2 * capped) * pairs + B * Sq * H * D,
                4 * pairs * D,
                itemsize * 2 * (B * Sq * H * D + B * Sk * KV * D)
                + (4 * B * H * Sq if lse else 0),
                (1 + capped) * pairs + (B * H * Sq if lse else 0))


def flash_attention_bwd_dq_work(q, k, causal: bool = False, window: int = 0,
                                softcap: float = 0.0) -> Dict[str, float]:
    """The backward's first kernel: the gradient's products dP = dO V^T
    and dQ = dS K (``4 D`` a visible pair and head; the scores' own
    product, recomputed from q and k, is not counted: the four products
    of the whole backward are those of the reference's differentiated
    attention), P from the log-sum-exp (a difference and an ``exp`` a
    visible score), dS (two a visible score) and delta = rowsum(dO o O); q, k, v, o, dO and lse read, dq and delta
    written (fp32)."""
    B, Sq, H, D = q
    Sk, KV = k[1], k[2]
    pairs = B * H * visible_pairs(Sq, Sk, bool(causal), int(window))
    capped = softcap > 0
    return work(4 * pairs * D + (3 + 3 * capped) * pairs + 2 * B * Sq * H * D,
                4 * pairs * D,
                4 * (4 * B * Sq * H * D + 2 * B * Sk * KV * D
                     + 2 * B * H * Sq),
                (1 + capped) * pairs)


def flash_attention_bwd_dkdv_work(q, k, causal: bool = False,
                                  window: int = 0, softcap: float = 0.0
                                  ) -> Dict[str, float]:
    """The backward's second kernel: dV = P^T dO and dK = dS^T Q (``4 D``
    a visible pair and head), P and dS again (four a visible score and an
    ``exp``); q, k, v, dO, lse and delta read, dk and dv written
    (fp32)."""
    B, Sq, H, D = q
    Sk, KV = k[1], k[2]
    pairs = B * H * visible_pairs(Sq, Sk, bool(causal), int(window))
    capped = softcap > 0
    return work(4 * pairs * D + (4 + 3 * capped) * pairs, 4 * pairs * D,
                4 * (2 * B * Sq * H * D + 4 * B * Sk * KV * D
                     + 2 * B * H * Sq),
                (1 + capped) * pairs)


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


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int,
            softcap: float) -> torch.Tensor:
    """The scaled, soft-capped scores ``(B, KV, G, Sq, Sk)`` in fp32, -inf
    where a query does not see a key."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(D)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    mask = visible_mask(Sq, k.shape[1], causal, window, q.device)
    return s.masked_fill(~mask, float("-inf"))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Materialized-scores attention with the kernel's semantics (the CPU
    path and the kernel's yardstick on the card)."""
    return attention_plain_lse(q, k, v, causal, window, softcap)[0]


def attention_plain_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``attention_plain`` and the rows' log-sum-exp ``(B, H, Sq)`` fp32,
    +inf on a row that sees no key (the kernel's ``lse``)."""
    B, Sq, H, D = q.shape
    s = _scores(q, k, causal, window, softcap)
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    lse = torch.logsumexp(s, dim=-1)
    lse = torch.where(lse == float("-inf"), float("inf"), lse)
    return (out.reshape(B, Sq, H, D).to(q.dtype),
            lse.reshape(B, H, Sq))


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv of the attention from its inputs, its output ``o``, the
    rows' log-sum-exp ``lse`` (B, H, Sq) and the output's gradient ``do``,
    by the kernels' formulas in torch ops: ``P = exp(s - lse)`` (0 where
    masked), ``dS = P * (dP - rowsum(do * o))`` times the softcap's
    ``1 - tanh^2``.  A row that sees no key (lse = +inf) gets zeros.  The
    CPU's backward and the kernels' yardstick on the card; like the kernels
    it is two passes, ``attention_bwd_dq_plain`` then
    ``attention_bwd_dkdv_plain``, each recomputing P and dS."""
    dq, delta = attention_bwd_dq_plain(q, k, v, o, lse, do, causal, window,
                                       softcap)
    return (dq,) + attention_bwd_dkdv_plain(q, k, v, lse, delta, do, causal,
                                            window, softcap)


def attention_bwd_dq_plain(q, k, v, o, lse, do, causal=True, window=0,
                           softcap=0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dq kernel's plain version: dq, and delta = rowsum(do * o)
    (B, H, Sq) fp32."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    _, ds, _, _ = _p_ds_plain(q, k, v, delta, lse, do, causal, window,
                              softcap)
    B, Sq, H, D = q.shape
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()).reshape(B, Sq, H, D)
    return dq.to(q.dtype), delta


def attention_bwd_dkdv_plain(q, k, v, lse, delta, do, causal=True, window=0,
                             softcap=0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel's plain version: dk and dv, the GQA group's query
    heads summed into each KV head."""
    p, ds, qg, dog = _p_ds_plain(q, k, v, delta, lse, do, causal, window,
                                 softcap)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg)
    # contiguous, as the kernel writes them (so a step reads the same
    # downstream on every device)
    return dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous()


def _p_ds_plain(q, k, v, delta, lse, do, causal, window, softcap):
    """P and dS (times the scale) ``(B, KV, G, Sq, Sk)`` fp32, with q and do
    grouped ``(B, Sq, KV, G, D)``."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, KV, G, D).float()
    dog = do.reshape(B, Sq, KV, G, D).float()
    raw = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    if softcap > 0:
        t = torch.tanh(raw / softcap)
        s = softcap * t
    else:
        s = raw
    mask = visible_mask(Sq, Sk, causal, window, q.device)
    lse5 = lse.float().reshape(B, KV, G, Sq)[..., None]
    p = torch.where(mask, torch.exp(s - lse5), 0.0)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    ds = p * (dp - delta.float().reshape(B, KV, G, Sq)[..., None])
    if softcap > 0:
        ds = ds * (1.0 - t * t)
    return p, ds * scale, qg, dog


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


def _forward(q, k, v, causal, window, softcap, want_lse: bool):
    """The output and, with ``want_lse``, the rows' log-sum-exp (else
    None), counted as ``flash_attention_work``."""
    return counted(
        "flash_attention", lambda qs, ks, vs: flash_attention_work(
            qs, ks, causal, window, q.element_size(), want_lse, softcap),
        (q, k, v),
        lambda: _run_forward(q, k, v, causal, window, softcap, want_lse))


def _run_forward(q, k, v, causal, window, softcap, want_lse: bool):
    if not _build.wants_kernel(q, "flash_attention"):
        out, lse = attention_plain_lse(q, k, v, causal, window, softcap)
        return out, lse if want_lse else None
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {D} > {MAX_HEAD_DIM}")
    lse = torch.full((B, H, Sq), float("inf"), dtype=torch.float32,
                     device=q.device) if want_lse else None
    if q.numel() == 0 or Sk == 0:
        return torch.zeros_like(q), lse
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.check_launch(_lib().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Sq, Sk, H, KV, D,
            int(bool(causal)), int(window), float(softcap), _DTYPES[q.dtype],
            stream), "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out, lse


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention and its rows' log-sum-exp ``(B, H, Sq)`` fp32 (+inf on
    a row that sees no key), without a gradient: what the backward needs
    of the forward."""
    _check(q, k, v)
    return _forward(q, k, v, causal, window, softcap, want_lse=True)


def _fold(t: torch.Tensor, dim, n: int) -> torch.Tensor:
    """A vmapped operand ``t`` (``dim``: its vmapped axis, None when it is
    not batched) as one plain tensor whose axis 0 is the ``n`` examples'
    batch axes laid end to end: ``(n * B, ...)``."""
    t = t.expand(n, *t.shape) if dim is None else t.movedim(dim, 0)
    return t.reshape(n * t.shape[1], *t.shape[2:])


def _unfold(t: torch.Tensor, n: int) -> torch.Tensor:
    """``_fold``'s inverse on a result: ``(n * B, ...)`` -> ``(n, B,
    ...)``, the vmapped axis first."""
    return t.reshape(n, t.shape[0] // n, *t.shape[1:])


class _FlashAttention(torch.autograd.Function):
    """Attention with its gradient: returns the output and the rows'
    log-sum-exp (not differentiable), saves q, k, v and both; the backward
    is ``_FlashAttentionBwd``."""

    @staticmethod
    def forward(q, k, v, causal, window, softcap):
        return _forward(q, k, v, causal, window, softcap, want_lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, softcap = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, softcap)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _FlashAttentionBwd.apply(q, k, v, out, lse, do,
                                              *ctx.args)
        return dq, dk, dv, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, softcap):
        """The vmapped clients folded into B: one call over ``(n * B, S,
        H, D)``."""
        n = info.batch_size
        q, k, v = (_fold(t, d, n) for t, d in zip((q, k, v),
                                                       in_dims[:3]))
        out, lse = _FlashAttention.apply(q, k, v, causal, window, softcap)
        return (_unfold(out, n), _unfold(lse, n)), (0, 0)


class _FlashAttentionBwd(torch.autograd.Function):
    """``flash_attention_bwd`` as a Function, so that ``torch.func`` runs
    it through its ``vmap`` rule (the clients folded into B) rather than
    batching the kernels' raw pointers.  No second derivative."""

    @staticmethod
    def forward(q, k, v, o, lse, do, causal, window, softcap):
        return flash_attention_bwd(q, k, v, o, lse, do, causal, window,
                                   softcap)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash attention has no second "
                                  "derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, do, causal, window, softcap):
        n = info.batch_size
        args = [_fold(t, d, n)
                for t, d in zip((q, k, v, o, lse, do), in_dims[:6])]
        grads = _FlashAttentionBwd.apply(*args, causal, window, softcap)
        return tuple(_unfold(g, n) for g in grads), (0, 0, 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Attention of q ``(B, Sq, H, D)`` over k, v ``(B, Sk, KV, D)``;
    differentiable (fp32 only) when grad is enabled and an input requires
    it.  With grad off under a ``torch.func`` transform (a rematerialised
    layer's first run inside ``vmap``: batched operands, which the kernel
    cannot take) it is ``_FlashAttention`` too, whose ``vmap`` rule folds
    the clients into B, its lse dropped.  On ``meta`` (abstract
    evaluation: shapes and dtypes alone) it takes the same path in any
    dtype (the plain versions run on ``meta``)."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q.dtype != torch.float32 and q.device.type != "meta":
            raise ValueError(f"flash_attention: the gradient is float32 "
                             f"only (training in this repo is fp32); got "
                             f"{q.dtype}")
        return _FlashAttention.apply(q, k, v, causal, window, softcap)[0]
    if torch._C._are_functorch_transforms_active():
        return _FlashAttention.apply(q, k, v, causal, window, softcap)[0]
    return _forward(q, k, v, causal, window, softcap, want_lse=False)[0]


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, causal: bool = True,
                        window: int = 0, softcap: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv from q, k, v, the forward's output ``o`` and log-sum-exp
    ``lse`` (B, H, Sq), and ``do``: fp32 tensors of one device.  A CUDA
    tensor launches the dq kernel (which also writes each row's
    ``rowsum(do * o)``) and then the dk/dv kernel; a CPU tensor takes their
    plain versions, which make ``attention_bwd_plain`` (on ``meta``, in
    any dtype)."""
    _check(q, k, v)
    B, Sq, H, _ = q.shape
    tensors = (q, k, v, o, lse, do)
    if q.device.type != "meta" and any(t.dtype != torch.float32
                                       for t in tensors):
        raise ValueError(f"flash_attention_bwd takes float32 tensors; got "
                         f"{[t.dtype for t in tensors]}")
    if o.shape != q.shape or do.shape != q.shape or \
            tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_attention_bwd: every input must lie on q's "
                         "device")
    dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, causal, window,
                                       softcap)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, lse, delta, do, causal,
                                      window, softcap)
    return dq, dk, dv


def _bwd_launch(fn: str, q, k, causal, window, softcap, ptrs, what: str):
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head_dim {D} > {MAX_HEAD_DIM}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.check_launch(getattr(_lib(), fn)(
            *ptrs, B, Sq, Sk, H, KV, D, int(bool(causal)), int(window),
            float(softcap), stream), what)
    LAUNCHES[what] += 1


def flash_attention_bwd_dq(q, k, v, o, lse, do, causal=True, window=0,
                           softcap=0.0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward's first kernel (inputs as ``flash_attention_bwd``
    checks them): dq, and delta = rowsum(do * o) (B, H, Sq), which the
    dk/dv kernel reads.  A CPU tensor takes ``attention_bwd_dq_plain``.
    Counted as ``flash_attention_bwd_dq_work``."""
    return counted("flash_attention_bwd_dq",
                   lambda *s: flash_attention_bwd_dq_work(
                       s[0], s[1], causal, window, softcap),
                   (q, k, v, o, lse, do),
                   lambda: _run_bwd_dq(q, k, v, o, lse, do, causal, window,
                                       softcap))


def _run_bwd_dq(q, k, v, o, lse, do, causal, window, softcap):
    if not _build.wants_kernel(q, "flash_attention_bwd_dq"):
        return attention_bwd_dq_plain(q, k, v, o, lse, do, causal, window,
                                      softcap)
    if q.numel() == 0 or k.shape[1] == 0:
        return torch.zeros_like(q), torch.zeros(lse.shape, device=q.device)
    q, k, v, o, lse, do = (t.contiguous() for t in (q, k, v, o, lse, do))
    dq = torch.empty_like(q)
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    _bwd_launch("repro_flash_attention_bwd_dq", q, k, causal, window,
                softcap, (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), lse.data_ptr(), do.data_ptr(),
                          dq.data_ptr(), delta.data_ptr()),
                "flash_attention_bwd_dq")
    return dq, delta


def flash_attention_bwd_dkdv(q, k, v, lse, delta, do, causal=True, window=0,
                             softcap=0.0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward's second kernel: dk and dv, the GQA group's query
    heads summed into each KV head.  A CPU tensor takes
    ``attention_bwd_dkdv_plain``.  Counted as
    ``flash_attention_bwd_dkdv_work``."""
    return counted("flash_attention_bwd_dkdv",
                   lambda *s: flash_attention_bwd_dkdv_work(
                       s[0], s[1], causal, window, softcap),
                   (q, k, v, lse, delta, do),
                   lambda: _run_bwd_dkdv(q, k, v, lse, delta, do, causal,
                                         window, softcap))


def _run_bwd_dkdv(q, k, v, lse, delta, do, causal, window, softcap):
    if not _build.wants_kernel(q, "flash_attention_bwd_dkdv"):
        return attention_bwd_dkdv_plain(q, k, v, lse, delta, do, causal,
                                        window, softcap)
    if q.numel() == 0 or k.shape[1] == 0:
        return torch.zeros_like(k), torch.zeros_like(v)
    q, k, v, lse, delta, do = (t.contiguous()
                               for t in (q, k, v, lse, delta, do))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("repro_flash_attention_bwd_dkdv", q, k, causal, window,
                softcap, (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          lse.data_ptr(), delta.data_ptr(), do.data_ptr(),
                          dk.data_ptr(), dv.data_ptr()),
                "flash_attention_bwd_dkdv")
    return dk, dv
