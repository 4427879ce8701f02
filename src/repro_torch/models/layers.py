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
kernel (``kernels.flash_attention``), and so do the encdec family's
bidirectional encoder and cross-attention (``qkv_projection``, then the
kernel without causality); decode (one query row against the rolling
cache, per-row positions) stays plain PyTorch, as the reference computes
it outside any Pallas kernel.  So does the MoE block: the
reference's dispatch is one-hot, cumsum, scatter and a batched einsum, and
its decode path a ``lax.ragged_dot``, none of them a Pallas kernel; here
they are ``torch.bmm`` and one ``torch.matmul`` per expert group.  Under
active sharding rules (``parallel.sharding.use_rules``) ``moe_block``
takes the expert-parallel ``_moe_block_sharded``, the reference's
``shard_map`` body run once per mesh place: tokens split over the batch
axes, the experts (``E % tp == 0``) or ``d_ff`` split over ``model``, the
``d`` dim of the weights gathered over ``data`` (FSDP; under
``moe_int8_gather()`` as rowwise int8 with a straight-through gradient),
the partial outputs summed over ``model`` in place order.

Training: ``chunked_ce_loss`` (the LM loss, one ``remat`` per chunk of
1024 positions, so the ``(B, S, V)`` logits are never held for the
backward), ``moe_aux_loss`` (the Switch-style load-balancing term) and
``remat`` (the reference's ``jax.checkpoint`` of a block body, applied
while grad is on, under plain autograd and ``torch.func`` alike).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.parallel.sharding import (
    active_analysis,
    all_gather,
    current_rules,
    psum,
    psum_scatter,
)
from repro_torch.tree import tree_leaves, tree_structure, tree_unflatten

Params = Dict[str, torch.Tensor]
NEG_INF = -1e30


# =============================================================================
# initializers (same distributions as the reference; other random bits)
# =============================================================================
class _MetaDraws:
    """The generator of an init on the ``meta`` device, where no
    ``torch.Generator`` exists: it names the device and draws nothing (a
    meta tensor has a shape and a dtype and no storage), as
    ``jax.eval_shape`` traces the reference's init without running it."""
    device = torch.device("meta")


def make_generator(device: torch.device, seed: int):
    """An init's generator: a ``torch.Generator`` on ``device`` seeded with
    ``seed``; on ``meta``, ``_MetaDraws``."""
    if device.type == "meta":
        return _MetaDraws()
    return torch.Generator(device=device).manual_seed(seed)


def _normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    out = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if gen.device.type == "meta":
        return out.to(dtype)
    out.normal_(0.0, 1.0, generator=gen)
    return out.mul_(std).to(dtype)


def _uniform(gen: torch.Generator, shape, low: float, high: float
             ) -> torch.Tensor:
    """fp32 draws from U(low, high) (uninitialised on ``meta``)."""
    out = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if gen.device.type == "meta":
        return out
    return out.uniform_(low, high, generator=gen)


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


def softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0)
    return torch.logaddexp(x, x.new_zeros(()))


class _SiLU(torch.autograd.Function):
    """``F.silu`` whose backward is always aten's fused ``silu_backward``.
    ``torch.func.grad`` runs the backward with grad mode on (as
    create_graph), where ``F.silu``'s derivative is the decomposed,
    twice-differentiable formula; it rounds apart from plain autograd's
    fused kernel by an ulp in about a fifth of the lanes, so the batched
    fleet engine (``vmap`` of ``torch.func.grad``) and the sequential one
    (``torch.autograd.grad``) took different gradients.  Through this
    Function every transform runs the same two aten kernels and gets
    autograd's bits.  No second derivative (aten has none for
    ``silu_backward``); nothing in the port takes one."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return torch.ops.aten.silu.default(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        an = active_analysis()
        if an is not None:      # one op on meta too (torch.func splits it)
            return an.one_op(torch.ops.aten.silu_backward.default, (g, x))
        return torch.ops.aten.silu_backward.default(g, x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` (``x * sigmoid(x)``), one backward under plain
    autograd and every ``torch.func`` transform (``_SiLU``)."""
    return _SiLU.apply(x)


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


def qkv_projection(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   positions: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q ``(B, S, H, D)`` and k, v ``(B, S, KV, D)`` of ``x`` (B, S, d),
    q and k normed (qwen3) and rotated at ``positions``, (S,) or (B, S)."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    pos_b = positions if positions.dim() == 2 else positions[None, :]
    return (apply_rope(q, pos_b, cfg.rope_theta),
            apply_rope(k, pos_b, cfg.rope_theta), v)


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
    q, k, v = qkv_projection(cfg, p, x, positions)

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
# short causal convolution
# =============================================================================
def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal conv over ``x`` (B, S, C) with kernel ``w`` (W, C)
    and bias ``b`` (C,): mamba2's and the RG-LRU's short conv."""
    W, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + S] * w[i][None, None, :] for i in range(W))
    return out + b[None, None, :]


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
        h = silu(x @ p["w_gate"]) * (x @ p["w_up"])
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


def _router_probs(p: Params, xf: torch.Tensor) -> torch.Tensor:
    return torch.softmax((xf @ p["router"]).float(), dim=-1)


def _top_k(probs: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of each row and their indices, best first.
    ``lax.top_k`` lets the lower index win a tie; a stable descending sort
    keeps that order, where ``torch.topk``'s order among ties is
    unspecified."""
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    return top.values[:, :k], top.indices[:, :k]


def moe_route(cfg: ModelConfig, p: Params, xf: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing of ``xf`` (T, d): the renormalised fp32 weights and
    the experts, each (T, k), best first (ties to the lower expert)."""
    topw, topi = _top_k(_router_probs(p, xf), cfg.moe.top_k)
    return topw / topw.sum(dim=-1, keepdim=True), topi


def moe_dispatch(cfg: ModelConfig, topi: torch.Tensor
                 ) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """Capacity ``C`` and each of the ``T*k`` assignments' row of the
    ``(E*C + 1, d)`` dispatch buffer, and whether it was kept.  Positions
    within an expert follow the flat order (token-major, a token's first
    choice before its second); an assignment past ``C`` goes to the
    scratch row ``E*C`` and is dropped.  Runs under ``torch.func.vmap``
    (the batched fleet engine): the one-hot is a comparison with
    ``arange(E)``, where ``F.one_hot`` would read the range on the host,
    and ``T`` is then one client's tokens, so ``C`` is per client, as
    under the reference's ``jit(vmap(...))``."""
    T, k = topi.shape
    E = cfg.moe.num_experts
    # the reference's Python float expression, so C is its integer
    C = max(1, int(cfg.moe.capacity_factor * T * k / E))
    flat_e = topi.reshape(-1)
    assign = (flat_e[:, None] == torch.arange(E, device=flat_e.device)
              ).to(torch.int64)                               # (T*k, E)
    pos_all = assign.cumsum(0) - assign
    pos = pos_all.gather(1, flat_e[:, None])[:, 0]
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos,
                       torch.full_like(flat_e, E * C))
    return C, slot, keep


def _expert_act(cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_act == "swiglu":
        return silu(h)
    return F.gelu(h, approximate="tanh")


def _moe_capacity(cfg: ModelConfig, p: Params, xf: torch.Tensor,
                  topw: torch.Tensor, topi: torch.Tensor) -> torch.Tensor:
    """The prefill path: tokens scattered into ``(E, C, d)``, the experts
    as three batched products, and the kept results combined with the
    top-k weights.  Out of place throughout (``index_put``,
    ``index_add``), so it runs under ``torch.func.vmap``."""
    T, d = xf.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    C, slot, keep = moe_dispatch(cfg, topi)
    token_idx = torch.arange(T * k, device=xf.device) // k
    buf = torch.zeros((E * C + 1, d), dtype=xf.dtype,
                      device=xf.device).index_put((slot,), xf[token_idx])
    h = buf[:E * C].reshape(E, C, d)
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
                       ).index_add(0, token_idx, contrib)


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
    """Token-choice top-k MoE over ``x`` (B, S, d): the expert-parallel
    ``_moe_block_sharded`` under active sharding rules whose ``model``
    size divides the experts or ``d_ff``, else ``_moe_block_local``."""
    rules = current_rules()
    if rules is not None and rules.tp:
        tp = rules.axis_size(rules.tp)
        if cfg.moe.num_experts % tp == 0 or cfg.d_ff % tp == 0:
            return _moe_block_sharded(cfg, p, x, rules)
    return _moe_block_local(cfg, p, x)


def _moe_block_local(cfg: ModelConfig, p: Params, x: torch.Tensor
                     ) -> torch.Tensor:
    """Capacity-bounded dispatch for ``S > 1``, the exact drop-free path
    for a decode step (``S == 1``); plus arctic's dense residual FFN in
    both."""
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


# =============================================================================
# expert-parallel MoE over a mesh (the reference's shard_map body)
# =============================================================================
_GATHER = threading.local()


@contextlib.contextmanager
def moe_int8_gather(on: bool = True):
    """Int8-compress the sharded MoE's FSDP weight gathers (rowwise absmax
    along the dim that is not gathered; the gradient straight through)."""
    prev = getattr(_GATHER, "on", False)
    _GATHER.on = on
    try:
        yield
    finally:
        _GATHER.on = prev


class _Int8Gather(torch.autograd.Function):
    """The FSDP gather of a weight's shards as int8: each shard quantized
    rowwise along ``q_axis`` (absmax / 127, round half to even), codes and
    scales gathered along ``axis``, dequantized once for each of the
    group's places.  The backward is the plain gather's: the places'
    cotangents summed in place order and scattered back to the shards
    (``psum_scatter``)."""

    @staticmethod
    def forward(ctx, axis: int, places, *shards):
        w = shards[0]
        q_axis = w.dim() - 2 if axis == w.dim() - 1 else w.dim() - 1
        codes, scales = [], []
        for shard in shards:
            w32 = shard.float()
            scale = w32.abs().amax(dim=q_axis, keepdim=True).clamp_min(
                1e-12) / 127.0
            codes.append(torch.clamp(torch.round(w32 / scale), -127, 127
                                     ).to(torch.int8))
            scales.append(scale)
        ctx.axis = axis
        ctx.devices = [shard.device for shard in shards]
        return tuple((all_gather(codes, axis, place).float()
                      * all_gather(scales, axis, place)).to(w.dtype)
                     for place in places)

    @staticmethod
    def backward(ctx, *cts):
        return (None, None, *psum_scatter(cts, ctx.axis, ctx.devices))


def _gather_w(shards: List[torch.Tensor], axis: int, places, int8: bool
              ) -> List[torch.Tensor]:
    """The FSDP unshard of a weight for each place of a ``data`` group:
    its shards concatenated along ``axis`` (plain), or ``_Int8Gather``."""
    if int8:
        return list(_Int8Gather.apply(axis, tuple(places), *shards))
    return [all_gather(shards, axis, place) for place in places]


def _moe_shard(cfg: ModelConfig, xb: torch.Tensor, router: torch.Tensor,
               wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
               dense_w, e0: int, local_E: int, dense_div: int
               ) -> torch.Tensor:
    """One place's body: route its tokens ``xb`` over all ``E`` experts,
    dispatch those that chose one of its ``local_E`` experts (from ``e0``;
    the others go to the out-of-range row) with capacity ``C = cf * T_l *
    k / E`` (``T_l * k`` at ``S == 1``: lossless), run its experts
    (or its ``d_ff`` slice of all of them) and combine; plus the dense
    residual divided by ``dense_div``.  Returns the partial ``(T_l, d)``
    output."""
    Bl, Sl, d = xb.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    xf = xb.reshape(-1, d)
    T_l = xf.shape[0]
    topw, topi = moe_route(cfg, {"router": router}, xf)
    C = (T_l * k if Sl == 1
         else max(1, int(cfg.moe.capacity_factor * T_l * k / E)))
    flat_e = topi.reshape(-1) - e0
    in_range = (flat_e >= 0) & (flat_e < local_E)
    safe_e = torch.where(in_range, flat_e, torch.full_like(flat_e, local_E))
    assign = (safe_e[:, None] == torch.arange(local_E + 1,
                                              device=xf.device)
              ).to(torch.int64)
    pos_all = assign.cumsum(0) - assign
    pos = pos_all.gather(1, safe_e[:, None])[:, 0]
    keep = in_range & (pos < C)
    slot = torch.where(keep, safe_e * C + pos,
                       torch.full_like(safe_e, local_E * C))
    token_idx = torch.arange(T_l * k, device=xf.device) // k
    buf = torch.zeros((local_E * C + 1, d), dtype=xf.dtype,
                      device=xf.device).index_put((slot,), xf[token_idx])
    h = buf[:local_E * C].reshape(local_E, C, d)
    mid = _expert_act(cfg, torch.bmm(h, wg)) * torch.bmm(h, wu)
    y = torch.bmm(mid, wd).reshape(local_E * C, d)
    w_flat = topw.reshape(-1).to(xf.dtype)
    gathered = y[slot.clamp(max=local_E * C - 1)]
    contrib = torch.where(keep[:, None], w_flat[:, None] * gathered,
                          torch.zeros((), dtype=xf.dtype, device=xf.device))
    out = torch.zeros((T_l, d), dtype=xf.dtype, device=xf.device
                      ).index_add(0, token_idx, contrib)
    if dense_w is not None:
        dg, du, dd = dense_w
        hd = _expert_act(cfg, xf @ dg) * (xf @ du)
        dense_out = hd @ dd
        if dense_div > 1:
            # the experts are summed over tp; a replicated dense branch is
            # in every place's part
            dense_out = dense_out / dense_div
        out = out + dense_out
    return out


@dataclasses.dataclass(frozen=True)
class _MoEPlan:
    """How the expert-parallel body splits one MoE call over a mesh."""
    tp_ax: str
    tp: int
    fsdp_ax: Optional[str]
    expert_sharded: bool
    d_sh: bool
    f_sh: bool
    b_axes: Tuple[str, ...]
    n_b: int
    dense: bool
    dense_f_sh: bool
    local_E: int
    B_l: int
    d_l: int
    f_l: int


def _moe_plan(cfg: ModelConfig, rules, B: int) -> _MoEPlan:
    mesh = rules.mesh
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    tp_ax = rules.tp[0]
    tp = mesh.shape[tp_ax]
    fsdp_ax = rules.fsdp[0] if rules.fsdp else None
    fsdp = mesh.shape.get(fsdp_ax, 1) if fsdp_ax else 1
    expert_sharded = E % tp == 0
    d_sh = fsdp_ax is not None and d % fsdp == 0
    b_axes = rules.resolve("batch", B)
    b_axes = (() if b_axes is None else
              (b_axes,) if isinstance(b_axes, str) else tuple(b_axes))
    n_b = 1
    for a in b_axes:
        n_b *= mesh.shape[a]
    dense = cfg.moe.dense_residual
    return _MoEPlan(tp_ax, tp, fsdp_ax, expert_sharded, d_sh,
                    not expert_sharded and f % tp == 0, b_axes, n_b, dense,
                    dense and f % tp == 0, E // tp if expert_sharded else E,
                    B // n_b, d // fsdp if d_sh else d, f // tp)


def _moe_weights(p: Params, pl: _MoEPlan) -> List[torch.Tensor]:
    """The body's weights: the router, w_gate, w_up, w_down (and the
    dense three)."""
    ws = [p[k] for k in ("router", "w_gate", "w_up", "w_down")]
    if pl.dense:
        ws += [p["dense"][k] for k in ("w_gate", "w_up", "w_down")]
    return ws


def _gather_axes(pl: _MoEPlan) -> List[int]:
    """The dim each of ``_moe_weights`` gathers along (its ``d``)."""
    return [0, 1, 1, 2] + ([0, 0, 1] if pl.dense else [])


def _held(ws: List[torch.Tensor], pl: _MoEPlan, c) -> List[torch.Tensor]:
    """The shards of ``_moe_weights`` place ``c`` holds (views)."""
    i = c[pl.fsdp_ax] if pl.d_sh else 0
    dsl = slice(i * pl.d_l, (i + 1) * pl.d_l) if pl.d_sh else slice(None)
    j = c[pl.tp_ax]

    def fsl(sharded):
        return slice(j * pl.f_l, (j + 1) * pl.f_l) if sharded else slice(None)
    router, wg, wu, wd = ws[:4]
    if pl.expert_sharded:
        es = slice(j * pl.local_E, (j + 1) * pl.local_E)
        w = [wg[es, dsl, :], wu[es, dsl, :], wd[es, :, dsl]]
    else:
        w = [wg[:, dsl, fsl(pl.f_sh)], wu[:, dsl, fsl(pl.f_sh)],
             wd[:, fsl(pl.f_sh), dsl]]
    w = [router[dsl]] + w
    if pl.dense:
        dg, du, dd = ws[4:]
        df = fsl(pl.dense_f_sh)
        w += [dg[dsl, df], du[dsl, df], dd[df, dsl]]
    return w


def _moe_specs(pl: _MoEPlan) -> List[tuple]:
    """The reference's ``shard_map`` in_specs: x, then ``_moe_weights``."""
    d = pl.fsdp_ax if pl.d_sh else None
    if pl.expert_sharded:
        wg, wd = (pl.tp_ax, d, None), (pl.tp_ax, None, d)
    else:
        f = pl.tp_ax if pl.f_sh else None
        wg, wd = (None, d, f), (None, f, d)
    specs = [(pl.b_axes or None, None, None), (d, None), wg, wg, wd]
    if pl.dense:
        df = pl.tp_ax if pl.dense_f_sh else None
        specs += [(d, df), (d, df), (df, d)]
    return specs


def _moe_block_sharded(cfg: ModelConfig, p: Params, x: torch.Tensor,
                       rules) -> torch.Tensor:
    """Expert-parallel MoE, the reference's ``shard_map`` body run once per
    place of ``rules.mesh``.

    Tokens split over the batch axes when ``B`` divides them (else every
    place takes all of them).  Along ``model`` either the experts are
    sharded (case A, ``E % tp == 0``, arctic: a place's ``E/tp`` experts
    as views) or ``d_ff`` is (case B: a ``d_ff/tp`` slice of every
    expert).  The ``d`` dim of the weights is ``data``-sharded when it
    divides (FSDP) and gathered in the body, under ``moe_int8_gather()``
    as int8.  The partial outputs sum over ``model`` in place order, and
    the batch shards concatenate on the mesh's home place.  Under a step
    analysis (``launch.hlo_analysis``) the body is one device's program:
    place 0's, through ``shard_map_one_place``."""
    assert cfg.moe is not None
    mesh = rules.mesh
    B, S, d = x.shape
    pl = _moe_plan(cfg, rules, B)
    ws = _moe_weights(p, pl)
    axes = _gather_axes(pl)

    def body(xb, w, e0=0):
        return _moe_shard(cfg, xb, w[0], w[1], w[2], w[3],
                          w[4:] if pl.dense else None, e0, pl.local_E,
                          pl.tp if pl.dense and not pl.dense_f_sh else 1)

    an = active_analysis()
    if an is not None:
        if getattr(_GATHER, "on", False):
            raise NotImplementedError("the int8 weight gather under a step "
                                      "analysis is not modelled")
        zero = {a: 0 for a in mesh.axis_names}
        return an.shard_map_one_place(
            body, [x] + ws, _moe_specs(pl),
            lambda x, *ws: [x[:pl.B_l]] + _held(list(ws), pl, zero),
            [(ax, pl.fsdp_ax) if pl.d_sh else None for ax in axes],
            pl.tp_ax, "moe")
    tp_ax, tp, fsdp_ax, b_axes, n_b = (pl.tp_ax, pl.tp, pl.fsdp_ax,
                                       pl.b_axes, pl.n_b)
    int8 = pl.d_sh and getattr(_GATHER, "on", False)

    def held(c):
        """The weight shards place ``c`` holds (views of ``p``)."""
        place = mesh.place(c)
        return [v.to(place) for v in _held(ws, pl, c)]

    # each FSDP group: the places that differ only in their data index
    groups: Dict[tuple, list] = {}
    for c in mesh.coords():
        key = tuple(v for a, v in c.items() if a != fsdp_ax or not pl.d_sh)
        groups.setdefault(key, []).append(c)
    # the axis each held weight gathers along, and whether it goes int8
    # (the experts' three)
    gather_axes = [(ax, int8 and 1 <= n <= 3) for n, ax in enumerate(axes)]
    parts: Dict[tuple, torch.Tensor] = {}
    for members in groups.values():
        places = [mesh.place(c) for c in members]
        shards = [held(c) for c in members]
        weights = [_gather_w([s[n] for s in shards], ax, places, q)
                   for n, (ax, q) in enumerate(gather_axes)]
        for m, c in enumerate(members):
            w = [g[m] for g in weights]
            bi = 0
            for a in b_axes:
                bi = bi * mesh.shape[a] + c[a]
            xb = x[bi * pl.B_l:(bi + 1) * pl.B_l].to(places[m])
            parts[tuple(c.values())] = body(
                xb, w, c[tp_ax] * pl.local_E if pl.expert_sharded else 0)
    # psum over model, one batch shard from the places whose other
    # coordinates are 0; the shards concatenated on the home place
    outs = []
    for bi in range(n_b):
        c = {a: 0 for a in mesh.axis_names}
        rest = bi
        for a in reversed(b_axes):
            c[a] = rest % mesh.shape[a]
            rest //= mesh.shape[a]
        group = []
        for j in range(tp):
            c[tp_ax] = j
            group.append(parts[tuple(c[a] for a in mesh.axis_names)])
        outs.append(psum(group, group[0].device).to(mesh.home))
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out.reshape(B, S, d)


def moe_aux_loss(cfg: ModelConfig, p: Params, x: torch.Tensor
                 ) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style) of the router ``p`` on
    ``x`` (B, S, d): ``E * sum_e (fraction of top-k picks of e) * (mean
    router probability of e)``; the gradient flows through the
    probabilities."""
    assert cfg.moe is not None
    d = x.shape[-1]
    E = cfg.moe.num_experts
    probs = _router_probs(p, x.reshape(-1, d))
    _, topi = _top_k(probs, cfg.moe.top_k)
    frac_tokens = (topi[..., None] == torch.arange(E, device=topi.device)
                   ).float().sum(dim=1).mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return E * torch.sum(frac_tokens * frac_probs)


# =============================================================================
# training: activation remat and the chunked cross-entropy
# =============================================================================
class _Remat(torch.autograd.Function):
    """``run(*tensors)`` whose activations are recomputed in the backward:
    the forward runs ``run`` without recording and saves its inputs alone;
    the backward runs ``torch.func.vjp`` of ``run`` on them (the second
    run of the body) and returns the floating inputs' cotangents.  The
    outputs are floating; one the caller does not differentiate (the
    chunked CE's token count) hands the vjp zeros.  ``torch.func`` runs it
    through the generated ``vmap`` rule (the body vmapped in the forward
    and the backward alike) and its ``grad`` rule, so it composes as
    ``jax.checkpoint`` does; a kernel Function inside the body meets the
    transform through its own ``vmap`` rule.  No second derivative: the
    backward's cotangents carry no graph."""
    generate_vmap_rule = True

    @staticmethod
    def forward(run, *tensors):
        return run(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        run, *tensors = inputs
        ctx.run = run
        ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        tensors = list(ctx.saved_tensors)
        diff = [i for i, t in enumerate(tensors) if t.is_floating_point()]

        def body(*primals):
            for i, t in zip(diff, primals):
                tensors[i] = t
            return ctx.run(*tensors)
        with torch.enable_grad():
            out, vjp_fn = torch.func.vjp(body, *[tensors[i] for i in diff])
        outs = out if isinstance(out, tuple) else (out,)
        cots = tuple(torch.zeros_like(o) if g is None else g
                     for g, o in zip(grads, outs))
        dins = vjp_fn(cots if isinstance(out, tuple) else cots[0])
        # a ``torch.func.grad`` around this backward runs it with
        # create_graph, so the recompute is recorded at its level too:
        # detached, the cotangents let that record go with this call,
        # where kept they would hold every layer's recomputed
        # intermediates to the end of the backward
        in_grads = [None] * len(tensors)
        for i, g in zip(diff, dins):
            in_grads[i] = g.detach()
        return (None, *in_grads)


def remat(enabled: bool, fn, *args):
    """``fn(*args)``, its activations recomputed in the backward instead of
    kept when ``enabled`` and grad is on (the reference's
    ``jax.checkpoint``); else a plain call (serving, and ``no_grad``).
    Under a ``torch.func`` transform (the batched fleet engine's
    ``vmap(grad(...))``, ``launch.steps``' ``grad_and_value`` and its
    vmapped pod step) it is ``_Remat``; under plain autograd it stays
    ``torch.utils.checkpoint`` (non-reentrant): the two agree bit for bit
    on every family but encdec, where ``_Remat`` sums the encoder
    output's gradient a decoder layer at a time (the reference's scan
    transpose does the same) and ``checkpoint``, like the unrematerialised
    graph, in one running sum over all the layers' terms, an ulp apart.
    ``args`` may be trees of tensors (a layer's param dict) and
    non-tensor leaves (``remat_apply``).  Every tensor ``fn`` reads must be
    one of ``args``: a tensor it closes over is invisible to the
    backward's ``vjp`` and to the ``vmap`` rule (a closed-over parameter
    gets no gradient)."""
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args)
    if not torch._C._are_functorch_transforms_active():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return remat_apply(fn, *args)


def remat_apply(fn, *args):
    """``fn(*args)`` through ``_Remat``: the tensor leaves of the ``args``
    trees are its inputs, the rest is rebuilt around them in the body."""
    structure = tree_structure(args)
    leaves = tree_leaves(args)
    where = [i for i, t in enumerate(leaves) if isinstance(t, torch.Tensor)]

    def run(*tensors):
        full = list(leaves)
        for i, t in zip(where, tensors):
            full[i] = t
        return fn(*tree_unflatten(structure, full))
    return _Remat.apply(run, *[leaves[i] for i in where])


def _chunk_loss(h: torch.Tensor, lab: torch.Tensor, unembed: torch.Tensor,
                cap: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk's summed CE and its count of valid labels.  The chunk's
    rows are flattened before the product, so ``h @ unembed`` is one
    ``(B c, d) x (d, V)`` mm: under ``vmap`` with an unembedding of each
    pod or client, one bmm.  A 3-D ``h`` that is a strided slice of the
    sequence (S > chunk, B > 1) and an ``unembed`` that does not require
    grad (``_Remat``'s forward, no recording) would take matmul's
    broadcast path, which copies the batched unembedding once a row;
    this copies the activation chunk alone.  Outside a transform it is
    the fold plain autograd's matmul does itself, the same mm."""
    B, c, d = h.shape
    logits = (h.reshape(B * c, d) @ unembed).float().reshape(B, c, -1)
    if cap > 0.0:
        logits = softcap(logits, cap)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lab.clamp(min=0).long()[..., None])[..., 0]
    valid = (lab >= 0).float()
    return torch.sum((lse - gold) * valid), torch.sum(valid)


def chunked_ce_loss(hidden: torch.Tensor, unembed: torch.Tensor,
                    labels: torch.Tensor, logit_softcap_val: float = 0.0,
                    chunk: int = 1024) -> torch.Tensor:
    """Mean next-token cross-entropy of ``hidden`` (B, S, d) through
    ``unembed`` (d, V) against ``labels`` (B, S), -1 ignored, over chunks
    of ``min(chunk, S)`` positions (S must be a multiple), each chunk's
    logits recomputed in the backward (``remat``), as the reference's
    ``jax.checkpoint`` does: the (B, S, V) logits are never held."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"seq {S} must be divisible by loss chunk {chunk}")
    total = hidden.new_zeros((), dtype=torch.float32)
    count = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, S, chunk):
        tl, tc = remat(True, _chunk_loss, hidden[:, c0:c0 + chunk],
                       labels[:, c0:c0 + chunk], unembed, logit_softcap_val)
        total, count = total + tl, count + tc
    return total / torch.clamp(count, min=1.0)
