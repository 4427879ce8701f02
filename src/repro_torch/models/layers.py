"""Transformer building blocks (counterpart of ``repro/models/layers.py``):
norms, rotary embeddings, grouped-query attention with a rolling KV cache,
and the feed-forward block.

Conventions kept from the reference: params are nested dicts of tensors;
activations are ``(batch, seq, d_model)``; q is ``(batch, seq, heads,
head_dim)`` and k/v ``(batch, seq, kv_heads, head_dim)``; norms and
softmax run in fp32 whatever the params' dtype.  Where PyTorch's default
differs from JAX's, the reference's choice is written out:

* ``jax.nn.gelu`` is the tanh approximation (``approximate="tanh"``);
* norm weights are stored as ``scale - 1`` and applied as ``(1 + scale)``;
* rotary embeddings rotate split halves, not interleaved pairs;
* masked scores are filled with ``-1e30`` (not ``-inf``), and the softmax
  probabilities are cast to q's dtype before the product with v.

The prefill branch of ``attention_block`` goes through the flash-attention
kernel (``kernels.flash_attention``); decode (one query row against the
rolling cache, per-row positions) stays plain PyTorch, as the reference
computes it outside any Pallas kernel.  The MoE block is not ported
(``transformer`` raises for MoE configs).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention

Params = Dict[str, torch.Tensor]
NEG_INF = -1e30


# =============================================================================
# initializers (same distributions as the reference; other random bits)
# =============================================================================
def _normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    out = torch.empty(shape, dtype=torch.float32, device=gen.device)
    out.normal_(0.0, 1.0, generator=gen)
    return (out * std).to(dtype)


def _dense_init(gen, d_in: int, d_out: int, dtype) -> torch.Tensor:
    return _normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype)


def _embed_init(gen, vocab: int, d: int, dtype) -> torch.Tensor:
    return _normal(gen, (vocab, d), 0.02, dtype)


# =============================================================================
# norms
# =============================================================================
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def init_rms_norm(d: int, dtype, device=None) -> torch.Tensor:
    # stored as (scale - 1): zeros are the identity (gemma convention)
    return torch.zeros((d,), dtype=dtype, device=device)


# =============================================================================
# rotary embeddings
# =============================================================================
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    # a Python-scalar base: no host-to-device copy, so no sync per layer
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs          # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]            # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# =============================================================================
# attention
# =============================================================================
def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


def attention_scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                          causal: bool, window: int) -> torch.Tensor:
    """Boolean (Sq, Sk) mask; ``window > 0`` keeps k in (q - window, q],
    ``k_pos < 0`` marks an invalid slot."""
    valid = (k_pos[None, :] >= 0).expand(q_pos.shape[0], -1)
    if causal:
        valid = valid & (k_pos[None, :] <= q_pos[:, None])
    if window > 0:
        valid = valid & (k_pos[None, :] > (q_pos[:, None] - window))
    return valid


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: torch.Tensor,
                         attn_softcap: float = 0.0) -> torch.Tensor:
    """Plain grouped-query attention: q (B, Sq, H, D), k/v (B, Sk, KV, D),
    mask (Sq, Sk) or (B, Sq, Sk); returns (B, Sq, H, D)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    scores = scores / math.sqrt(D)
    if attn_softcap > 0.0:
        scores = softcap(scores, attn_softcap)
    m = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
    scores = scores.masked_fill(~m, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, D)


def init_attention(gen, cfg: ModelConfig, dtype) -> Params:
    p: Params = {
        "wq": _dense_init(gen, cfg.d_model, cfg.q_dim, dtype),
        "wk": _dense_init(gen, cfg.d_model, cfg.kv_dim, dtype),
        "wv": _dense_init(gen, cfg.d_model, cfg.kv_dim, dtype),
        "wo": _dense_init(gen, cfg.q_dim, cfg.d_model, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(cfg.head_dim, dtype, gen.device)
        p["k_norm"] = init_rms_norm(cfg.head_dim, dtype, gen.device)
    return p


def attention_block(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,                     # (B, S, d)
    positions: torch.Tensor,             # (S,) or (B, S) integers
    *,
    window: int,
    kv_cache: Optional[Params] = None,   # {"k", "v": (B, W, KV, D)}
    cache_len: int = 0,
    decode_pos=None,                     # int / 0-d tensor, or (B,) tensor
) -> Tuple[torch.Tensor, Params]:
    """Self-attention with an optional rolling-buffer KV cache.

    Prefill (``kv_cache=None``): causal (+ window) attention over the whole
    sequence from position 0, through the flash-attention kernel.  Returns
    ``(y, {"k", "v"})`` with this sequence's rotated keys and values, which
    the reference recomputes for the cache.

    Decode: x is (B, 1, d); the new k/v row is written at slot
    ``decode_pos % W`` of ``kv_cache`` *in place* (the reference donates
    these buffers) and the updated dict is returned.  A vector
    ``decode_pos`` gives each batch row its own position and slot.
    """
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    pos_b = positions if positions.dim() == 2 else positions[None, :]
    q = apply_rope(q, pos_b, cfg.rope_theta)
    k = apply_rope(k, pos_b, cfg.rope_theta)

    if kv_cache is None:
        out = flash_attention(q, k, v, causal=True, window=int(window),
                              softcap=cfg.attn_softcap)
        new_cache = {"k": k, "v": v}
    else:
        W = cache_len
        dp = torch.as_tensor(decode_pos, device=x.device).long()
        slot = dp % W
        ck, cv = kv_cache["k"], kv_cache["v"]
        idx = torch.arange(W, device=x.device)
        if dp.dim() == 1:
            # per-row positions: each row writes its own slot and masks
            # against its own position (mask (B, 1, W))
            rows = torch.arange(B, device=x.device)
            ck[rows, slot] = k[:, 0]
            cv[rows, slot] = v[:, 0]
            dpc = dp[:, None]                              # (B, 1)
            k_pos = dpc - ((dpc - idx) % W)                # (B, W)
            mask = (k_pos >= 0) & (k_pos <= dpc)
            if window > 0:
                mask &= k_pos > dpc - window
            mask = mask[:, None, :]
        else:
            # index_copy_, not ck[:, slot]: a 0-d index would be read back
            # to the host (a sync per layer)
            ck.index_copy_(1, slot.reshape(1), k)
            cv.index_copy_(1, slot.reshape(1), v)
            # the position held in slot s: latest p <= pos with p % W == s
            k_pos = dp - ((dp - idx) % W)
            mask = ((k_pos >= 0) & (k_pos <= dp))[None, :]  # (1, W)
            if window > 0:
                mask &= (k_pos > dp - window)[None, :]
        out = multi_head_attention(q, ck, cv, mask, cfg.attn_softcap)
        new_cache = {"k": ck, "v": cv}
    y = out.reshape(B, S, cfg.q_dim) @ p["wo"]
    return y, new_cache


# =============================================================================
# feed-forward
# =============================================================================
def init_ffn(gen, d: int, f: int, act: str, dtype) -> Params:
    if act in ("swiglu", "geglu"):
        return {"w_gate": _dense_init(gen, d, f, dtype),
                "w_up": _dense_init(gen, d, f, dtype),
                "w_down": _dense_init(gen, f, d, dtype)}
    return {"w_up": _dense_init(gen, d, f, dtype),
            "w_down": _dense_init(gen, f, d, dtype)}


def ffn(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif act == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]
