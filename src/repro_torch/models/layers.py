"""Transformer building blocks (counterpart of ``repro/models/layers.py``):
norms, rotary embeddings, grouped-query attention with a rolling KV cache,
the feed-forward block and the token-choice mixture of experts.

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
computes it outside any Pallas kernel.  So does the MoE block: the
reference's dispatch is one-hot, cumsum, scatter and a batched einsum, and
its decode path a ``lax.ragged_dot``, none of them a Pallas kernel; here
they are ``torch.bmm`` and one ``torch.matmul`` per expert group.  The
reference's expert-parallel ``_moe_block_sharded`` needs sharding rules,
which the port does not have: ``moe_block`` is the single-device path.
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
    return out.mul_(std).to(dtype)


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


# =============================================================================
# mixture of experts (token-choice top-k, capacity-bounded)
# =============================================================================
def init_moe(gen, cfg: ModelConfig, dtype) -> Params:
    """The router ``(d, E)``, the experts' ``w_gate`` / ``w_up`` ``(E, d,
    f)`` and ``w_down`` ``(E, f, d)``, and arctic's dense residual FFN."""
    assert cfg.moe is not None
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    p: Params = {
        "router": _dense_init(gen, d, E, dtype),
        "w_gate": _normal(gen, (E, d, f), 1.0 / math.sqrt(d), dtype),
        "w_up": _normal(gen, (E, d, f), 1.0 / math.sqrt(d), dtype),
        "w_down": _normal(gen, (E, f, d), 1.0 / math.sqrt(f), dtype),
    }
    if cfg.moe.dense_residual:
        p["dense"] = init_ffn(gen, d, f, cfg.mlp_act, dtype)
    return p


def moe_route(cfg: ModelConfig, p: Params, xf: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing of ``xf`` (T, d): the renormalised fp32 weights and
    the experts, each (T, k), best first.  ``lax.top_k`` lets the lower
    expert win a tie; a stable descending sort keeps that order, where
    ``torch.topk``'s order among ties is unspecified."""
    probs = torch.softmax((xf @ p["router"]).float(), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    topw, topi = top.values[:, :k], top.indices[:, :k]
    return topw / topw.sum(dim=-1, keepdim=True), topi


def moe_dispatch(cfg: ModelConfig, topi: torch.Tensor
                 ) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """Capacity ``C`` and each of the ``T*k`` assignments' row of the
    ``(E*C + 1, d)`` dispatch buffer, and whether it was kept.  Positions
    within an expert follow the flat order (token-major, a token's first
    choice before its second); an assignment past ``C`` goes to the
    scratch row ``E*C`` and is dropped."""
    T, k = topi.shape
    E = cfg.moe.num_experts
    # the reference's Python float expression, so C is its integer
    C = max(1, int(cfg.moe.capacity_factor * T * k / E))
    flat_e = topi.reshape(-1)
    assign = F.one_hot(flat_e, E)                             # (T*k, E)
    pos_all = assign.cumsum(0) - assign
    pos = pos_all.gather(1, flat_e[:, None])[:, 0]
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos,
                       torch.full_like(flat_e, E * C))
    return C, slot, keep


def _expert_act(cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_act == "swiglu":
        return F.silu(h)
    return F.gelu(h, approximate="tanh")


def _moe_capacity(cfg: ModelConfig, p: Params, xf: torch.Tensor,
                  topw: torch.Tensor, topi: torch.Tensor) -> torch.Tensor:
    """The prefill path: tokens scattered into ``(E, C, d)``, the experts
    as three batched products, and the kept results combined with the
    top-k weights."""
    T, d = xf.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    C, slot, keep = moe_dispatch(cfg, topi)
    token_idx = torch.arange(T * k, device=xf.device) // k
    buf = torch.zeros((E * C + 1, d), dtype=xf.dtype, device=xf.device)
    buf[slot] = xf[token_idx]
    h = buf[:E * C].view(E, C, d)
    mid = _expert_act(cfg, torch.bmm(h, p["w_gate"])) * torch.bmm(
        h, p["w_up"])
    y = torch.bmm(mid, p["w_down"]).reshape(E * C, d)
    w_flat = topw.reshape(-1).to(xf.dtype)
    gathered = y[slot.clamp(max=E * C - 1)]
    contrib = torch.where(keep[:, None], w_flat[:, None] * gathered,
                          torch.zeros((), dtype=xf.dtype, device=xf.device))
    # k = 2 terms onto zeros sum alike in any order (every config has
    # top_k 2); more would need a fixed order to match the reference
    return torch.zeros((T, d), dtype=xf.dtype, device=xf.device
                       ).index_add_(0, token_idx, contrib)


def _moe_decode_exact(cfg: ModelConfig, p: Params, xf: torch.Tensor,
                      topw: torch.Tensor, topi: torch.Tensor
                      ) -> torch.Tensor:
    """Drop-free MoE (the reference's decode path): the ``T*k``
    assignments sorted by expert (stably, as ``jnp.argsort``), and each
    non-empty expert's contiguous rows through one ``torch.matmul`` per
    weight, the reference's ``lax.ragged_dot``.  Reads the group sizes on
    the host."""
    T, d = xf.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    token_idx = order // k
    rows = xf[token_idx]                        # (T*k, d) sorted by expert
    sizes = torch.bincount(flat_e, minlength=E).tolist()
    ys, start = [], 0
    for e, n in enumerate(sizes):
        if n:
            r = rows[start:start + n]
            mid = _expert_act(cfg, r @ p["w_gate"][e]) * (r @ p["w_up"][e])
            ys.append(mid @ p["w_down"][e])
        start += n
    w_sorted = topw.reshape(-1)[order].to(xf.dtype)
    return torch.zeros((T, d), dtype=xf.dtype, device=xf.device
                       ).index_add_(0, token_idx, w_sorted[:, None]
                                    * torch.cat(ys))


def moe_block(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Token-choice top-k MoE over ``x`` (B, S, d): capacity-bounded
    dispatch for ``S > 1``, the exact drop-free path for a decode step
    (``S == 1``); plus arctic's dense residual FFN in both."""
    assert cfg.moe is not None
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    topw, topi = moe_route(cfg, p, xf)
    if S == 1:
        out = _moe_decode_exact(cfg, p, xf, topw, topi)
    else:
        out = _moe_capacity(cfg, p, xf, topw, topi)
    out = out.reshape(B, S, d)
    if cfg.moe.dense_residual:
        out = out + ffn(p["dense"], x, cfg.mlp_act)
    return out
