"""Whisper-style encoder-decoder LM (counterpart of
``repro/models/encdec.py``, arXiv:2212.04356): a bidirectional encoder over
precomputed frame embeddings and a causal decoder with cross-attention.

The audio frontend (mel spectrogram and conv stem) is the reference's
stub: ``frames`` are frame embeddings ``(batch, encoder_seq, d_model)``.
The reference's param and cache trees are kept key for key (``"enc_layers"``
and ``"layers"`` stacked on a leading layer axis, a ``"cross"`` block per
decoder layer; caches ``{"k", "v": (layers, B, seq, KV, D), "xk", "xv":
(layers, B, frames, KV, D)}``), so ``convert`` carries them across; where
the reference scans over the layers, the port loops.

The reference computes the encoder's self-attention and the
cross-attention as plain masked attention with an all-true mask.  Here,
as the dense prefill's causal attention does, every attention over a
whole sequence goes through the flash-attention kernel: the encoder's
without causality, the cross-attention of more than one query row
without causality, the decoder's causal self-attention through
``layers.attention_block``.  A decode step (one query row against the
caches) stays plain PyTorch, as decode does in every family.  Rotary
embeddings rotate the encoder's q and k and the decoder's, never the cross
k and v.  ``loss_fn`` is the training loss (the chunked cross-entropy of
the decoder's final hidden states); while autograd records, every encoder
and decoder layer is rematerialised in the backward when ``cfg.remat``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tree import tree_map

Params = Dict[str, object]


# =============================================================================
# init
# =============================================================================
def _init_cross(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    return {
        "wq": L._dense_init(gen, cfg.d_model, cfg.q_dim, dtype),
        "wk": L._dense_init(gen, cfg.d_model, cfg.kv_dim, dtype),
        "wv": L._dense_init(gen, cfg.d_model, cfg.kv_dim, dtype),
        "wo": L._dense_init(gen, cfg.q_dim, cfg.d_model, dtype),
    }


def init_enc_layer(cfg: ModelConfig, gen: torch.Generator, dtype) -> Params:
    return {
        "ln1": L.init_rms_norm(cfg.d_model, dtype, gen.device),
        "ln2": L.init_rms_norm(cfg.d_model, dtype, gen.device),
        "attn": L.init_attention(gen, cfg, dtype),
        "ffn": L.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype),
    }


def init_dec_layer(cfg: ModelConfig, gen: torch.Generator, dtype) -> Params:
    return {
        "ln1": L.init_rms_norm(cfg.d_model, dtype, gen.device),
        "ln_x": L.init_rms_norm(cfg.d_model, dtype, gen.device),
        "ln2": L.init_rms_norm(cfg.d_model, dtype, gen.device),
        "attn": L.init_attention(gen, cfg, dtype),
        "cross": _init_cross(gen, cfg, dtype),
        "ffn": L.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype),
    }


def init(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
         device=None) -> Params:
    """Random params with the reference's distributions, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (``None``: the
    card, raising if none is visible), a layer at a time into the stacks.
    They are not the reference's threefry draws: to hold the port against
    the reference, carry the reference's params across with
    ``convert.lm_params_from_numpy``.
    On ``"meta"`` they are uninitialised meta tensors of the same
    shapes and dtypes, and nothing is drawn."""
    device = resolve_device(device)
    gen = L.make_generator(device, seed)
    return {
        "embed": L._embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "enc_layers": T.stacked_layers(cfg, gen, dtype, init_enc_layer,
                                       n=cfg.encoder_layers),
        "layers": T.stacked_layers(cfg, gen, dtype, init_dec_layer),
        "enc_norm": L.init_rms_norm(cfg.d_model, dtype, device),
        "final_norm": L.init_rms_norm(cfg.d_model, dtype, device),
        "unembed": L._dense_init(gen, cfg.d_model, cfg.vocab_size, dtype),
    }


# =============================================================================
# encoder
# =============================================================================
def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames (B, T_enc, d), precomputed frame embeddings (the frontend
    stub) -> the encoder's final-norm states (B, T_enc, d)."""
    x = frames
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for i in range(cfg.encoder_layers):
        x = L.remat(cfg.remat,
                    lambda x_, p, pos: _enc_layer(cfg, p, x_, pos), x,
                    tree_map(lambda t: t[i], params["enc_layers"]),
                    positions)
    return L.rms_norm(x, params["enc_norm"])


def _enc_layer(cfg: ModelConfig, p: Params, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    B, S, _ = x.shape
    h = L.rms_norm(x, p["ln1"])
    q, k, v = L.qkv_projection(cfg, p["attn"], h, positions)
    out = L.flash_attention(q, k, v, causal=False)   # bidirectional
    x = x + out.reshape(B, S, cfg.q_dim) @ p["attn"]["wo"]
    return x + L.ffn(p["ffn"], L.rms_norm(x, p["ln2"]), cfg.mlp_act)


def _cross_attend(cfg: ModelConfig, p: Params, h: torch.Tensor,
                  enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    """Attention of the decoder's ``h`` (B, S, d) onto the encoder's k, v
    (B, T_enc, KV, D), every query seeing every frame: through the flash
    kernel for S > 1, as plain attention for one row (a decode step)."""
    B, S, _ = h.shape
    q = (h @ p["wq"]).reshape(B, S, cfg.num_heads, cfg.head_dim)
    if S == 1:
        mask = torch.ones((1, enc_k.shape[1]), dtype=torch.bool,
                          device=h.device)
        out = L.multi_head_attention(q, enc_k, enc_v, mask)
    else:
        out = L.flash_attention(q, enc_k, enc_v, causal=False)
    return out.reshape(B, S, cfg.q_dim) @ p["wo"]


def _enc_kv(cfg: ModelConfig, p: Params, enc_out: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, _ = enc_out.shape
    k = (enc_out @ p["wk"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = (enc_out @ p["wv"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    return k, v


# =============================================================================
# decoder
# =============================================================================
def decode_stack(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 enc_out: torch.Tensor, return_cache: bool = False,
                 cache_seq: Optional[int] = None
                 ) -> Tuple[torch.Tensor, Optional[Params]]:
    """The decoder over ``tokens`` (B, S) from position 0: the final-norm
    hidden states and, with ``return_cache``, the caches: the rotated
    self-attention k/v of the S positions in the first S of ``cache_seq or
    S`` slots, and each layer's cross k/v of ``enc_out``."""
    x = params["embed"][tokens]
    if not return_cache:
        x = decoder_layers(cfg, params, x, enc_out, 0, cfg.num_layers)
        return L.rms_norm(x, params["final_norm"]), None
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    kv = (cfg.num_layers, B, cache_seq or S, cfg.num_kv_heads, cfg.head_dim)
    xkv = (cfg.num_layers, B, enc_out.shape[1], cfg.num_kv_heads,
           cfg.head_dim)
    cache = {name: x.new_zeros(shape) for name, shape in
             (("k", kv), ("v", kv), ("xk", xkv), ("xv", xkv))}
    for i in range(cfg.num_layers):
        x, self_kv, ek, ev = _dec_layer(cfg, T.layer_params(params, i), x,
                                        enc_out, positions)
        T.write_prefill_kv(cache["k"][i], cache["v"][i], self_kv)
        cache["xk"][i] = ek
        cache["xv"][i] = ev
    return L.rms_norm(x, params["final_norm"]), cache


def _dec_layer(cfg: ModelConfig, p: Params, x: torch.Tensor,
               enc_out: torch.Tensor, positions: torch.Tensor):
    """One decoder layer over the full sequence: ``(x, its self-attention
    k/v, the cross k, v of enc_out)``."""
    h = L.rms_norm(x, p["ln1"])
    attn_out, self_kv = L.attention_block(cfg, p["attn"], h, positions,
                                          window=0)
    x = x + attn_out
    hx = L.rms_norm(x, p["ln_x"])
    ek, ev = _enc_kv(cfg, p["cross"], enc_out)
    x = x + _cross_attend(cfg, p["cross"], hx, ek, ev)
    x = x + L.ffn(p["ffn"], L.rms_norm(x, p["ln2"]), cfg.mlp_act)
    return x, self_kv, ek, ev


def decoder_layers(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   enc_out: torch.Tensor, start: int, stop: int
                   ) -> torch.Tensor:
    """Decoder layers ``[start, stop)`` over the full sequence ``x`` from
    position 0, each rematerialised in the backward when ``cfg.remat``: the
    whole decoder, and the two stages of the encdec split path."""
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for i in range(start, stop):
        x = L.remat(cfg.remat, lambda x_, p, e, pos: _dec_layer(
            cfg, p, x_, e, pos)[0], x, T.layer_params(params, i), enc_out,
            positions)
    return x


# =============================================================================
# model API
# =============================================================================
def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            frames: Optional[torch.Tensor] = None,
            return_cache: bool = False, cache_seq: Optional[int] = None
            ) -> Tuple[torch.Tensor, Optional[Params]]:
    if frames is None:
        raise ValueError("the encdec family needs precomputed frame "
                         "embeddings (batch['frames'])")
    enc_out = encode(cfg, params, frames)
    return decode_stack(cfg, params, tokens, enc_out, return_cache,
                        cache_seq)


def loss_fn(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` (decoded over
    the encoded ``batch["frames"]``) against ``batch["labels"]``."""
    hidden, _ = forward(cfg, params, batch["tokens"], batch["frames"])
    return L.chunked_ce_loss(hidden, params["unembed"], batch["labels"])


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype,
               device=None) -> Params:
    device = resolve_device(device)
    kv = (cfg.num_layers, batch, seq_len, cfg.num_kv_heads, cfg.head_dim)
    xkv = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads,
           cfg.head_dim)
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, shape in (("k", kv), ("v", kv), ("xk", xkv),
                                ("xv", xkv))}


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            frames: Optional[torch.Tensor] = None,
            target_seq: Optional[int] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Encode ``frames`` and process the prompt; returns (last-token fp32
    logits, caches for ``target_seq`` decoder positions)."""
    hidden, cache = forward(cfg, params, tokens, frames, return_cache=True,
                            cache_seq=target_seq)
    return (hidden[:, -1] @ params["unembed"]).float(), cache


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                token: torch.Tensor, pos) -> Tuple[torch.Tensor, Params]:
    """One decode step of ``token`` (B, 1) at ``pos``, an int or 0-d tensor
    or a (B,) tensor of per-row positions.  Writes the new self-attention
    k/v rows into ``cache`` in place and returns ``(fp32 logits (B, V),
    cache)``."""
    x = params["embed"][token]
    pos = torch.as_tensor(pos, device=x.device)
    positions = pos[None] if pos.dim() == 0 else pos[:, None]
    CL = cache["k"].shape[2]
    for i in range(cfg.num_layers):
        p = T.layer_params(params, i)
        h = L.rms_norm(x, p["ln1"])
        attn_out, _ = L.attention_block(
            cfg, p["attn"], h, positions, window=0,
            kv_cache={"k": cache["k"][i], "v": cache["v"][i]},
            cache_len=CL, decode_pos=pos)
        x = x + attn_out
        hx = L.rms_norm(x, p["ln_x"])
        x = x + _cross_attend(cfg, p["cross"], hx, cache["xk"][i],
                              cache["xv"][i])
        x = x + L.ffn(p["ffn"], L.rms_norm(x, p["ln2"]), cfg.mlp_act)
    x = L.rms_norm(x, params["final_norm"])
    return (x[:, -1] @ params["unembed"]).float(), cache
