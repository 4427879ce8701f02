"""Decoder-only transformer LM, the dense, MoE and VLM families
(counterpart of ``repro/models/transformer.py``, which serves mixtral-8x22b,
arctic-480b, qwen3-0.6b, llama3-8b, minicpm-2b, gemma2-2b and internvl2-2b):
init, the full-sequence forward, prefill and one decode step over a
rolling KV cache.

The reference's param layout is kept leaf for leaf: per-layer params are
stacked on a leading layer axis (``params["layers"]["attn"]["wq"]`` is
``(num_layers, d_model, q_dim)``), so ``convert`` maps either package's
params onto the other's.  Where the reference scans over that axis, the
port loops over the layer index.  Local/global attention (gemma2) is the
per-layer window from ``window_schedule``; the KV cache is one buffer per
layer of length ``cache_len`` (a rolling buffer when every layer is
windowed).  An MoE layer holds ``"moe"`` (``layers.moe_block``) where a
dense one holds ``"ffn"``.  The VLM variant projects precomputed patch
embeddings (the frontend stub) through ``patch_proj`` and puts them before
the token embeddings; positions and the cache count the patches.

``loss_fn`` is the training loss: the chunked cross-entropy of the final
hidden states (labels -1 over the VLM's patches), plus 0.01 times the first
layer's MoE load-balancing term for an MoE config.  While autograd records,
each layer is rematerialised in the backward when ``cfg.remat`` (the
reference's ``jax.checkpoint`` of the scan body); serving is unchanged.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import not_ported, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = Dict[str, object]
FAMILIES = ("dense", "moe", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
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
    if cfg.moe is not None:
        p["moe"] = L.init_moe(gen, cfg, dtype)
    else:
        p["ffn"] = L.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                              dtype)
    return p


def stacked_layers(cfg: ModelConfig, gen: torch.Generator, dtype,
                   init_one=init_layer, n: Optional[int] = None) -> Params:
    """``init_one`` for each of ``n`` layers (``cfg.num_layers`` unless
    given) in turn, copied into stacked buffers as it is drawn, so the peak
    is the stack plus one layer (a full-width mixtral layer is 10 GB in
    fp32; stacking a list would double the whole)."""

    def alloc(t):
        return {k: alloc(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.new_empty((n,) + tuple(t.shape))

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i].copy_(v)

    n = cfg.num_layers if n is None else n
    stacked = None
    for i in range(n):
        lp = init_one(cfg, gen, dtype)
        if stacked is None:
            stacked = alloc(lp)
        put(stacked, lp, i)
        del lp
    return stacked


def init(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
         device=None) -> Params:
    """Random params with the reference's distributions (dense weights
    N(0, 1/d_in), embedding N(0, 0.02^2), norms 0), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (``None``: the
    card, raising if none is visible), so a full-width model's draws stay
    on the card.  They are not the reference's threefry draws: to hold the
    port against the reference, carry the reference's params across with
    ``convert.lm_params_from_numpy``.
    On ``"meta"`` they are uninitialised meta tensors of the same
    shapes and dtypes, and nothing is drawn."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = L.make_generator(device, seed)
    p: Params = {"embed": L._embed_init(gen, cfg.vocab_size, cfg.d_model,
                                        dtype)}
    p["layers"] = stacked_layers(cfg, gen, dtype)
    p["final_norm"] = L.init_rms_norm(cfg.d_model, dtype, device)
    if not cfg.tie_embeddings:
        p["unembed"] = L._dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    if cfg.family == "vlm":
        p["patch_proj"] = L._dense_init(gen, cfg.d_model, cfg.d_model, dtype)
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
    ff = _feed_forward(cfg, p, L.rms_norm(x, p["ln2"]))
    return x + ff, kv


def _feed_forward(cfg: ModelConfig, p: Params, h: torch.Tensor
                  ) -> torch.Tensor:
    """The layer's FFN or MoE block on the normed ``h``, post-normed for
    gemma2."""
    if cfg.moe is not None:
        ff = L.moe_block(cfg, p["moe"], h)
    else:
        ff = L.ffn(p["ffn"], h, cfg.mlp_act)
    if cfg.post_block_norm:
        ff = L.rms_norm(ff, p["ln2_post"])
    return ff


def embed_inputs(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings (B, S, d); for the VLM, ``patches`` (B, P, d)
    projected by ``patch_proj`` and put before them (B, P + S, d).  Other
    families ignore ``patches``, as the reference does."""
    x = params["embed"][tokens]
    if cfg.post_block_norm:          # gemma-style embedding scale
        x = x * math.sqrt(cfg.d_model)
    if cfg.family == "vlm":
        if patches is None:
            raise ValueError("the vlm family needs precomputed patch "
                             "embeddings (batch['patches'])")
        px = patches.to(x.dtype) @ params["patch_proj"]
        x = torch.cat([px, x], dim=1)
    return x


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            patches=None, return_cache: bool = False,
            cache_seq: Optional[int] = None
            ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Full-sequence forward of ``tokens`` (B, S_text), after the VLM's
    ``patches``: S = P + S_text positions.  Returns the final-norm
    hidden states and, with ``return_cache``, the stacked KV cache
    ``{"k", "v": (layers, B, CL, KV, D)}`` with ``CL = cache_len(cfg,
    cache_seq or S)``: the last ``min(S, CL)`` positions, position ``p`` at
    slot ``p % CL``, zeros elsewhere."""
    _check_family(cfg)
    x = embed_inputs(cfg, params, tokens, patches)
    if not return_cache:
        x = layers_forward(cfg, params, x, 0, cfg.num_layers)
        return L.rms_norm(x, params["final_norm"]), None
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    cache = init_cache(cfg, B, cache_seq or S, x.dtype, x.device)
    for i, window in enumerate(window_schedule(cfg)):
        x, kv = _block(cfg, layer_params(params, i), x, positions, window)
        write_prefill_kv(cache["k"][i], cache["v"][i], kv)
    return L.rms_norm(x, params["final_norm"]), cache


def layers_forward(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   start: int, stop: int) -> torch.Tensor:
    """Layers ``[start, stop)`` over the full sequence ``x`` (B, S, d) from
    position 0, each rematerialised in the backward when ``cfg.remat``
    (``layers.remat``): the whole stack's forward, and the two stages of
    the LM split path (``models/split.py``)."""
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    windows = window_schedule(cfg)
    for i in range(start, stop):
        x = L.remat(cfg.remat, lambda x_, p, pos, w=windows[i]: _block(
            cfg, p, x_, pos, w)[0], x, layer_params(params, i), positions)
    return x


def loss_fn(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """The training loss of ``batch`` (``tokens``, ``labels`` (B, S_text),
    -1 ignored; ``patches`` for the VLM): mean next-token cross-entropy,
    plus ``0.01 * moe_aux_loss`` of the first layer's router on the
    embeddings for an MoE config (the reference's representative term)."""
    tokens, patches = batch["tokens"], batch.get("patches")
    hidden, _ = forward(cfg, params, tokens, patches)
    labels = batch["labels"]
    if cfg.family == "vlm":   # patch positions carry no labels
        pad = labels.new_full((labels.shape[0], cfg.num_patches), -1)
        labels = torch.cat([pad, labels], dim=1)
    loss = L.chunked_ce_loss(hidden, unembed_matrix(cfg, params), labels,
                             cfg.logit_softcap)
    if cfg.moe is not None:
        h0 = embed_inputs(cfg, params, tokens, patches)
        loss = loss + 0.01 * L.moe_aux_loss(
            cfg, layer_params(params, 0)["moe"], h0)
    return loss


def write_prefill_kv(ck: torch.Tensor, cv: torch.Tensor, kv: Params
                     ) -> None:
    """A prefill's rotated ``kv["k"]``, ``kv["v"]`` (B, S, KV, D) into one
    layer's cache buffers ``ck``, ``cv`` (B, CL, KV, D): the last
    ``min(S, CL)`` positions, position ``p`` at slot ``p % CL`` (a rolling
    buffer when S > CL); other slots keep what they hold."""
    S, CL = kv["k"].shape[1], ck.shape[1]
    take = min(S, CL)
    idx = torch.arange(S - take, S, device=ck.device) % CL
    ck[:, idx] = kv["k"][:, S - take:]
    cv[:, idx] = kv["v"][:, S - take:]


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
        x = x + _feed_forward(cfg, p, L.rms_norm(x, p["ln2"]))
    x = L.rms_norm(x, params["final_norm"])
    return lm_logits(cfg, params, x[:, -1]), cache
