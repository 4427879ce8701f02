"""Mamba-2 (SSD, state-space duality) LM (counterpart of
``repro/models/ssm.py``): init, the full-sequence forward, prefill and one
decode step over an O(1) recurrent cache.

Each block is norm -> in_proj -> causal depthwise conv -> SSD sequence
mixing -> gated norm -> out_proj.  The reference's param layout is kept
leaf for leaf (per-layer params stacked on a leading layer axis), so
``convert`` maps either package's params onto the other's; where the
reference scans over that axis, the port loops over the layer index.

The full-sequence SSD (``ssd_chunked``, every prefill layer) goes through
the SSD-scan kernel (``kernels.ssd_scan``), which returns y and the final
state the prefill caches.  Decode (``ssd_decode_step`` and the conv
window) stays plain PyTorch, as the reference computes it outside any
Pallas kernel.  ``loss_fn`` is the training loss (the chunked
cross-entropy of the final hidden states), each layer rematerialised in
the backward when ``cfg.remat``; the SSD scan's gradient is its own
backward (``kernels.ssd_scan._SSDScan``: the hand-written kernel on the
card, its plain passes on the CPU).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = Dict[str, object]


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.state_dim
    proj_dim = 2 * d_inner + 2 * s.state_dim + nheads   # z, x, B, C, dt
    return d_inner, nheads, conv_dim, proj_dim, s.state_dim


# =============================================================================
# init
# =============================================================================
def init_layer(cfg: ModelConfig, gen: torch.Generator, dtype) -> Params:
    """One layer's params, drawn from ``gen`` on its device."""
    d_inner, nheads, conv_dim, proj_dim, N = dims(cfg)
    device = gen.device
    dt = torch.exp(L._uniform(gen, (nheads,), math.log(1e-3),
                              math.log(1e-1)))
    return {
        "ln": L.init_rms_norm(cfg.d_model, dtype, device),
        "in_proj": L._dense_init(gen, cfg.d_model, proj_dim, dtype),
        "conv_w": L._normal(gen, (cfg.ssm.conv_width, conv_dim), 0.1, dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads,
                                          dtype=torch.float32,
                                          device=device)),
        "D": torch.ones((nheads,), dtype=torch.float32, device=device),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "gate_ln": L.init_rms_norm(d_inner, dtype, device),
        "out_proj": L._dense_init(gen, d_inner, cfg.d_model, dtype),
    }


def init(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
         device=None) -> Params:
    """Random params with the reference's distributions, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (``None``: the
    card, raising if none is visible).  They are not the reference's
    threefry draws: to hold the port against the reference, carry the
    reference's params across with ``convert.lm_params_from_numpy``.
    On ``"meta"`` they are uninitialised meta tensors of the same
    shapes and dtypes, and nothing is drawn."""
    device = resolve_device(device)
    gen = L.make_generator(device, seed)
    p: Params = {"embed": L._embed_init(gen, cfg.vocab_size, cfg.d_model,
                                        dtype)}
    p["layers"] = T.stacked_layers(cfg, gen, dtype, init_layer)
    p["final_norm"] = L.init_rms_norm(cfg.d_model, dtype, device)
    p["unembed"] = L._dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    return p


# =============================================================================
# SSD core
# =============================================================================
def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P), dt (B,S,H) post-softplus, A (H,) negative, Bm/Cm
    (B,S,N) -> (y (B,S,H,P), final_state (B,H,P,N)), through the SSD-scan
    kernel on the card."""
    return ssd_scan(x, dt, A, Bm, Cm, chunk, init_state)


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One row: x (B,H,P), dt (B,H), Bm/Cm (B,N), state (B,H,P,N)."""
    dtA = (dt * A[None, :]).float()
    decay = torch.exp(dtA)[..., None, None].to(state.dtype)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt.to(x.dtype), Bm, x)
    new_state = decay * state + upd
    y = torch.einsum("bn,bhpn->bhp", Cm, new_state)
    return y, new_state


# =============================================================================
# block
# =============================================================================
def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_inner, nheads, conv_dim, _, N = dims(cfg)
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:d_inner + conv_dim]
    dt = proj[..., d_inner + conv_dim:]
    return z, xbc, dt


def block(cfg: ModelConfig, p: Params, x: torch.Tensor,
          conv_state: Optional[torch.Tensor] = None,
          ssm_state: Optional[torch.Tensor] = None):
    """One layer, (B,S,d) -> ``(out (B,S,d), conv cache, ssm state)``.
    Over the full sequence (no states given) the caches are the last
    ``conv_width - 1`` conv inputs and the SSD's final state, which a
    prefill keeps (the reference's cacheless ``block`` returns ``out``
    alone); in decode (states given, S == 1) the rolled conv window and
    the updated state."""
    d_inner, nheads, conv_dim, _, N = dims(cfg)
    Bsz, S, _ = x.shape
    h = L.rms_norm(x, p["ln"])
    proj = h @ p["in_proj"]
    z, xbc_raw, dt = _split_proj(cfg, proj)
    dt = L.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    if conv_state is None:
        xbc = L.silu(L.causal_conv(xbc_raw, p["conv_w"], p["conv_b"]))
        new_conv = xbc_raw[:, S - (cfg.ssm.conv_width - 1):, :]
    else:
        window = torch.cat([conv_state, xbc_raw], dim=1)      # (B, W, C)
        out = torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"]
        xbc = L.silu(out)[:, None, :]
        new_conv = window[:, 1:]

    xin = xbc[..., :d_inner].reshape(Bsz, S, nheads, cfg.ssm.head_dim)
    Bm = xbc[..., d_inner:d_inner + N]
    Cm = xbc[..., d_inner + N:]

    if ssm_state is None:
        y, new_ssm = ssd_chunked(xin, dt, A, Bm, Cm, cfg.ssm.chunk)
    else:
        y, new_ssm = ssd_decode_step(xin[:, 0], dt[:, 0], A, Bm[:, 0],
                                     Cm[:, 0], ssm_state)
        y = y[:, None]

    y = y + p["D"][None, None, :, None].to(y.dtype) * xin
    y = y.reshape(Bsz, S, d_inner)
    y = L.rms_norm(y * L.silu(z), p["gate_ln"])
    return x + y @ p["out_proj"], new_conv, new_ssm


# =============================================================================
# model API (mirrors transformer.py)
# =============================================================================
def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            patches=None, return_cache: bool = False,
            cache_seq: Optional[int] = None
            ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Full-sequence forward of ``tokens`` (B, S): the final-norm hidden
    states and, with ``return_cache``, the stacked caches ``{"conv":
    (layers, B, conv_width - 1, conv_dim), "state": (layers, B, H, P,
    N)}``.  ``patches`` and ``cache_seq`` are ignored, as in the reference
    (the cache does not grow with the sequence)."""
    x = params["embed"][tokens]
    if not return_cache:
        x = layers_forward(cfg, params, x, 0, cfg.num_layers)
        return L.rms_norm(x, params["final_norm"]), None
    Bsz, S = tokens.shape
    W = cfg.ssm.conv_width
    if S < W - 1:
        raise ValueError(f"a prefill needs at least conv_width - 1 = {W - 1} "
                         f"tokens to fill the conv cache; got {S}")
    cache = init_cache(cfg, Bsz, S, x.dtype, x.device)
    for i in range(cfg.num_layers):
        x, conv, state = block(cfg, T.layer_params(params, i), x)
        cache["conv"][i] = conv
        cache["state"][i] = state
    return L.rms_norm(x, params["final_norm"]), cache


def layers_forward(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   start: int, stop: int) -> torch.Tensor:
    """Layers ``[start, stop)`` over the full sequence, each
    rematerialised in the backward when ``cfg.remat``."""
    for i in range(start, stop):
        x = L.remat(cfg.remat, lambda x_, p: block(cfg, p, x_)[0], x,
                    T.layer_params(params, i))
    return x


def loss_fn(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (-1 ignored)."""
    hidden, _ = forward(cfg, params, batch["tokens"])
    return L.chunked_ce_loss(hidden, params["unembed"], batch["labels"])


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype,
               device=None) -> Params:
    d_inner, nheads, conv_dim, _, N = dims(cfg)
    device = resolve_device(device)
    W = cfg.ssm.conv_width
    return {
        "conv": torch.zeros((cfg.num_layers, batch, W - 1, conv_dim),
                            dtype=dtype, device=device),
        "state": torch.zeros((cfg.num_layers, batch, nheads,
                              cfg.ssm.head_dim, N), dtype=dtype,
                             device=device),
    }


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            patches=None, target_seq: Optional[int] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Process the prompt (at least ``conv_width - 1`` tokens); returns
    (last-token fp32 logits, cache)."""
    hidden, cache = forward(cfg, params, tokens, return_cache=True)
    logits = (hidden[:, -1] @ params["unembed"]).float()
    return logits, cache


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                token: torch.Tensor, pos) -> Tuple[torch.Tensor, Params]:
    """One decode step of ``token`` (B, 1); ``pos`` is unused (the state
    carries the position).  Writes the new conv windows and states into
    ``cache`` in place and returns ``(fp32 logits (B, V), cache)``."""
    x = params["embed"][token]
    for i in range(cfg.num_layers):
        x, conv, state = block(cfg, T.layer_params(params, i), x,
                               cache["conv"][i], cache["state"][i])
        cache["conv"][i] = conv
        cache["state"][i] = state
    x = L.rms_norm(x, params["final_norm"])
    return (x[:, -1] @ params["unembed"]).float(), cache
