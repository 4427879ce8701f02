"""Decoder-only transformer LM, dense family (counterpart of
``repro/models/transformer.py``): init, the full-sequence forward, prefill
and one decode step over a rolling KV cache.

The reference's param layout is kept leaf for leaf: per-layer params are
stacked on a leading layer axis (``params["layers"]["attn"]["wq"]`` is
``(num_layers, d_model, q_dim)``), so ``convert`` maps either package's
params onto the other's.  Where the reference scans over that axis, the
port loops over the layer index.  Local/global attention (gemma2) is the
per-layer window from ``window_schedule``; the KV cache is one buffer per
layer of length ``cache_len`` (a rolling buffer when every layer is
windowed).  The MoE and VLM variants and ``loss_fn`` are not ported.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import not_ported, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = Dict[str, object]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.moe is not None or cfg.family != "dense":
        raise not_ported(f"the {cfg.family} transformer family", "LM families")


# =============================================================================
# init
# =============================================================================
def init_layer(cfg: ModelConfig, gen: torch.Generator, dtype) -> Params:
    """One layer's params, drawn from ``gen`` on its device."""
    p: Params = {
        "ln1": L.init_rms_norm(cfg.d_model, dtype, gen.device),
        "ln2": L.init_rms_norm(cfg.d_model, dtype, gen.device),
        "attn": L.init_attention(gen, cfg, dtype),
    }
    if cfg.post_block_norm:
        p["ln1_post"] = L.init_rms_norm(cfg.d_model, dtype, gen.device)
        p["ln2_post"] = L.init_rms_norm(cfg.d_model, dtype, gen.device)
    p["ffn"] = L.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype)
    return p


def _stack(layers: List[Params]) -> Params:
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lp[k] for lp in layers]) for k in first}
    return torch.stack(layers)


def init(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
         device=None) -> Params:
    """Random params with the reference's distributions (dense weights
    N(0, 1/d_in), embedding N(0, 0.02^2), norms 0), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (``None``: the
    card, raising if none is visible), so a full-width model's draws stay
    on the card.  They are not the reference's threefry draws: to hold the
    port against the reference, carry the reference's params across with
    ``convert.transformer_params_from_numpy``."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    p: Params = {"embed": L._embed_init(gen, cfg.vocab_size, cfg.d_model,
                                        dtype)}
    layers = []
    for _ in range(cfg.num_layers):
        layers.append(init_layer(cfg, gen, dtype))
    p["layers"] = _stack(layers)
    del layers
    p["final_norm"] = L.init_rms_norm(cfg.d_model, dtype, device)
    if not cfg.tie_embeddings:
        p["unembed"] = L._dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    return p


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked per-layer params (views)."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return take(params["layers"])


def window_schedule(cfg: ModelConfig) -> List[int]:
    """Per-layer window sizes (0 = global), from ``cfg.layer_pattern``."""
    return [cfg.window if cfg.layer_kind(i) == "L" else 0
            for i in range(cfg.num_layers)]


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Uniform per-layer KV-cache length for decode."""
    if cfg.window > 0 and all(cfg.layer_kind(i) == "L"
                              for i in range(cfg.num_layers)):
        return min(seq_len, cfg.window)   # rolling buffer
    return seq_len


def unembed_matrix(cfg: ModelConfig, params: Params) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


# =============================================================================
# forward
# =============================================================================
def _block(cfg: ModelConfig, p: Params, x: torch.Tensor,
           positions: torch.Tensor, window: int
           ) -> Tuple[torch.Tensor, Params]:
    """One layer over the full sequence; also returns its rotated k and v."""
    h = L.rms_norm(x, p["ln1"])
    attn_out, kv = L.attention_block(cfg, p["attn"], h, positions,
                                     window=window)
    if cfg.post_block_norm:
        attn_out = L.rms_norm(attn_out, p["ln1_post"])
    x = x + attn_out
    h = L.rms_norm(x, p["ln2"])
    ff = L.ffn(p["ffn"], h, cfg.mlp_act)
    if cfg.post_block_norm:
        ff = L.rms_norm(ff, p["ln2_post"])
    return x + ff, kv


def embed_inputs(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 patches=None) -> torch.Tensor:
    if cfg.family == "vlm" or patches is not None:
        raise not_ported("the VLM patch frontend", "LM families")
    x = params["embed"][tokens]
    if cfg.post_block_norm:          # gemma-style embedding scale
        x = x * math.sqrt(cfg.d_model)
    return x


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            patches=None, return_cache: bool = False,
            cache_seq: Optional[int] = None
            ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Full-sequence forward of ``tokens`` (B, S).  Returns the final-norm
    hidden states and, with ``return_cache``, the stacked KV cache
    ``{"k", "v": (layers, B, CL, KV, D)}`` with ``CL = cache_len(cfg,
    cache_seq or S)``: the last ``min(S, CL)`` positions, position ``p`` at
    slot ``p % CL``, zeros elsewhere."""
    _check_family(cfg)
    x = embed_inputs(cfg, params, tokens, patches)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    CL = cache_len(cfg, cache_seq or S) if return_cache else 0
    cache = None
    if return_cache:
        shape = (cfg.num_layers, B, CL, cfg.num_kv_heads, cfg.head_dim)
        cache = {"k": torch.zeros(shape, dtype=x.dtype, device=x.device),
                 "v": torch.zeros(shape, dtype=x.dtype, device=x.device)}
        take = min(S, CL)
        idx = torch.arange(S - take, S, device=x.device) % CL
    for i, window in enumerate(window_schedule(cfg)):
        x, kv = _block(cfg, layer_params(params, i), x, positions, window)
        if return_cache:
            cache["k"][i][:, idx] = kv["k"][:, S - take:]
            cache["v"][i][:, idx] = kv["v"][:, S - take:]
    return L.rms_norm(x, params["final_norm"]), cache


def lm_logits(cfg: ModelConfig, params: Params, h: torch.Tensor
              ) -> torch.Tensor:
    """fp32 logits of final hidden states ``h`` (soft-capped for gemma2)."""
    logits = (h @ unembed_matrix(cfg, params)).float()
    if cfg.logit_softcap > 0:
        logits = L.softcap(logits, cfg.logit_softcap)
    return logits


# =============================================================================
# serving: prefill + decode
# =============================================================================
def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            patches=None, target_seq: Optional[int] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Process the prompt; returns (last-token fp32 logits, kv cache)."""
    hidden, cache = forward(cfg, params, tokens, patches, return_cache=True,
                            cache_seq=target_seq)
    return lm_logits(cfg, params, hidden[:, -1]), cache


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype,
               device=None) -> Params:
    shape = (cfg.num_layers, batch, cache_len(cfg, seq_len),
             cfg.num_kv_heads, cfg.head_dim)
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                token: torch.Tensor, pos) -> Tuple[torch.Tensor, Params]:
    """One decode step of ``token`` (B, 1) at ``pos``: an int or 0-d tensor
    (the whole batch at one position) or a (B,) tensor of per-row positions
    (the serving engine's slot pool).  Writes the new k/v rows into
    ``cache`` in place and returns ``(fp32 logits (B, V), cache)``."""
    _check_family(cfg)
    x = params["embed"][token]
    if cfg.post_block_norm:
        x = x * math.sqrt(cfg.d_model)
    pos = torch.as_tensor(pos, device=x.device)
    positions = pos[None] if pos.dim() == 0 else pos[:, None]
    CL = cache["k"].shape[2]
    for i, window in enumerate(window_schedule(cfg)):
        p = layer_params(params, i)
        h = L.rms_norm(x, p["ln1"])
        attn_out, _ = L.attention_block(
            cfg, p["attn"], h, positions, window=window,
            kv_cache={"k": cache["k"][i], "v": cache["v"][i]},
            cache_len=CL, decode_pos=pos)
        if cfg.post_block_norm:
            attn_out = L.rms_norm(attn_out, p["ln1_post"])
        x = x + attn_out
        h = L.rms_norm(x, p["ln2"])
        ff = L.ffn(p["ffn"], h, cfg.mlp_act)
        if cfg.post_block_norm:
            ff = L.rms_norm(ff, p["ln2_post"])
        x = x + ff
    x = L.rms_norm(x, params["final_norm"])
    return lm_logits(cfg, params, x[:, -1]), cache
