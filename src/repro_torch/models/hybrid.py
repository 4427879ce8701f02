"""RecurrentGemma / Griffin hybrid LM (counterpart of
``repro/models/hybrid.py``, arXiv:2402.19427): RG-LRU recurrent blocks and
local attention in the pattern (R, R, L): init, the full-sequence forward,
prefill and one decode step.

The reference's param and cache trees are kept key for key, so ``convert``
carries them across.  Layers are grouped into super-blocks of
``len(cfg.layer_pattern)`` (= 3): ``params["layers"]["slots"]`` is a list
of one dict per slot of the pattern, its leaves stacked over the
``num_layers // 3`` groups, and ``params["rem"]`` a list of the remainder
layers (38 = 12 * 3 + 2), applied after the groups.  The cache is
``{"slots": tuple of per-slot stacked caches, "rem": list}``: an R layer
holds its last ``conv_width - 1`` conv inputs and its LRU state, an L
layer a rolling ``min(seq, window)``-slot KV buffer.  Where the reference
scans over the groups, the port loops.

* The RG-LRU's full-sequence recurrence is ``lax.associative_scan`` in the
  reference, no Pallas kernel; ``associative_scan`` here is that
  function's own recursion in torch ops (combine adjacent pairs, recurse
  on the half, fill the even positions), so the launches per layer grow
  as log S and the sums associate as the reference's do.
* A prefill computes each R layer's scan once and keeps ``h[:, -1]`` and
  the last ``conv_width - 1`` conv inputs from that run (the reference
  runs the scan a second time to rebuild them: the same values).  It needs
  at least ``conv_width - 1`` tokens (``ValueError`` below).
* The local-attention layers go through ``layers.attention_block`` with
  ``window=cfg.window``: the flash-attention kernel at prefill, the rolling
  cache in decode (its prefill placement ``transformer.write_prefill_kv``).
* A decode step takes a scalar position or a ``(B,)`` vector of per-row
  positions, as the dense transformer's does.

``loss_fn`` is the training loss (the chunked cross-entropy of the final
hidden states, soft-capped logits).  While autograd records, each
super-block is rematerialised in the backward when ``cfg.remat`` (the
reference's ``jax.checkpoint`` of its scan body); the remainder layers are
not, as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.parallel.sharding import shard
from repro_torch.tree import tree_map

Params = Dict[str, object]
_LRU_C = 8.0


# =============================================================================
# RG-LRU
# =============================================================================
def init_rglru(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d = cfg.d_model
    w = cfg.rglru.lru_width or d
    device = gen.device
    # Λ so that a lies in (0.9, 0.999) at r = 1 (Griffin appendix)
    lam = L._uniform(gen, (w,), 0.9, 0.999)
    lam = torch.log(torch.expm1(-torch.log(lam) / _LRU_C))  # inv. softplus
    return {
        "w_in1": L._dense_init(gen, d, w, dtype),
        "w_in2": L._dense_init(gen, d, w, dtype),
        "conv_w": L._normal(gen, (cfg.rglru.conv_width, w), 0.1, dtype),
        "conv_b": torch.zeros((w,), dtype=dtype, device=device),
        "w_r": L._dense_init(gen, w, w, dtype),
        "w_i": L._dense_init(gen, w, w, dtype),
        "lam": lam,
        "w_lru_out": L._dense_init(gen, w, d, dtype),
    }


def _rglru_coeffs(p: Params, u: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: conv output (..., w) -> fp32 (a, b) of h_t = a_t h_{t-1} + b_t."""
    r = torch.sigmoid((u @ p["w_r"]).float())
    i = torch.sigmoid((u @ p["w_i"]).float())
    log_a = -_LRU_C * L.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    gate = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-8))
    b = gate * i * u.float()
    return a, b


def _combine(a1, b1, a2, b2):
    # the earlier element (a1, b1) then the later one: h = a2 (a1 h + b1) + b2
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1])
                         + tuple(even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(a: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of the pairs ``(a_t, b_t)`` over dim 1 under
    ``_combine``: ``lax.associative_scan``'s recursion, so each prefix is
    summed in the reference's association order."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = associative_scan(*_combine(a[:, 0:-1:2], b[:, 0:-1:2],
                                        a[:, 1::2], b[:, 1::2]))
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_scan(p: Params, u: torch.Tensor) -> torch.Tensor:
    """The full-sequence recurrence over u (B, S, w), h_0 = 0."""
    _, h = associative_scan(*_rglru_coeffs(p, u))
    return h.to(u.dtype)


def rglru_step(p: Params, u: torch.Tensor, h: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode: u (B, 1, w), h (B, w) -> (out (B, 1, w), new h)."""
    a, b = _rglru_coeffs(p, u[:, 0])
    new_h = a * h.float() + b
    return new_h[:, None].to(u.dtype), new_h.to(u.dtype)


def recurrent_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  cache: Optional[Params] = None
                  ) -> Tuple[torch.Tensor, Params]:
    """The Griffin recurrent block (gated branch x conv -> RG-LRU branch).
    Over the full sequence (no cache) it also returns what a prefill
    caches: the last ``conv_width - 1`` conv inputs and the final state;
    in decode the rolled conv window and the updated state."""
    gate = F.gelu(x @ p["w_in1"], approximate="tanh")
    u = x @ p["w_in2"]
    if cache is None:
        h = rglru_scan(p, L.causal_conv(u, p["conv_w"], p["conv_b"]))
        W = cfg.rglru.conv_width
        new_cache = {"conv": u[:, u.shape[1] - (W - 1):], "state": h[:, -1]}
    else:
        window = torch.cat([cache["conv"], u], dim=1)
        conv_out = (torch.einsum("bwc,wc->bc", window, p["conv_w"])
                    + p["conv_b"])[:, None]
        h, state = rglru_step(p, conv_out, cache["state"])
        new_cache = {"conv": window[:, 1:], "state": state}
    return (gate * h) @ p["w_lru_out"], new_cache


# =============================================================================
# layer init / apply (kind 'R' or 'L')
# =============================================================================
def init_block(cfg: ModelConfig, kind: str, gen: torch.Generator,
               dtype) -> Params:
    """One layer's params, drawn from ``gen`` on its device."""
    p: Params = {"ln1": L.init_rms_norm(cfg.d_model, dtype, gen.device),
                 "ln2": L.init_rms_norm(cfg.d_model, dtype, gen.device)}
    if kind == "R":
        p["rglru"] = init_rglru(gen, cfg, dtype)
    else:
        p["attn"] = L.init_attention(gen, cfg, dtype)
    p["ffn"] = L.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype)
    return p


def apply_block(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[Params] = None,
                decode_pos=None) -> Tuple[torch.Tensor, Params]:
    """One layer.  Without ``cache`` (the full sequence) returns ``(x,
    what a prefill caches)``: an R layer's conv inputs and final state,
    an L layer's rotated k and v of every position.  With ``cache`` (a
    decode step, x (B, 1, d)) the layer's cache is updated in place and
    returned."""
    h = L.rms_norm(x, p["ln1"])
    if kind == "R":
        mix, new_cache = recurrent_mix(cfg, p["rglru"], h, cache)
        if cache is not None:
            cache["conv"].copy_(new_cache["conv"])
            cache["state"].copy_(new_cache["state"])
            new_cache = cache
    elif cache is None:
        mix, new_cache = L.attention_block(cfg, p["attn"], h, positions,
                                           window=cfg.window)
    else:
        mix, new_cache = L.attention_block(
            cfg, p["attn"], h, positions, window=cfg.window, kv_cache=cache,
            cache_len=cache["k"].shape[1], decode_pos=decode_pos)
    x = x + mix
    x = x + L.ffn(p["ffn"], L.rms_norm(x, p["ln2"]), cfg.mlp_act)
    return shard(x, ("batch", "seq", "none")), new_cache


# =============================================================================
# model init
# =============================================================================
def _pattern_info(cfg: ModelConfig) -> Tuple[int, int]:
    P = len(cfg.layer_pattern)
    return cfg.num_layers // P, cfg.num_layers % P


def init(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
         device=None) -> Params:
    """Random params with the reference's distributions, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (``None``: the
    card, raising if none is visible), a layer at a time into each slot's
    stack (``transformer.stacked_layers``).  They are not the reference's
    threefry draws: to hold the port against the reference, carry the
    reference's params across with ``convert.lm_params_from_numpy``.
    On ``"meta"`` they are uninitialised meta tensors of the same
    shapes and dtypes, and nothing is drawn."""
    device = resolve_device(device)
    gen = L.make_generator(device, seed)
    n_groups, rem = _pattern_info(cfg)
    p: Params = {"embed": L._embed_init(gen, cfg.vocab_size, cfg.d_model,
                                        dtype)}
    p["layers"] = {"slots": [
        T.stacked_layers(cfg, gen, dtype, lambda c, g, dt, kind=kind:
                         init_block(c, kind, g, dt), n=n_groups)
        for kind in cfg.layer_pattern]}
    p["rem"] = [init_block(cfg, cfg.layer_pattern[i], gen, dtype)
                for i in range(rem)]
    p["final_norm"] = L.init_rms_norm(cfg.d_model, dtype, device)
    if not cfg.tie_embeddings:
        p["unembed"] = L._dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    return p


unembed_matrix = T.unembed_matrix    # embed.T when tied (recurrentgemma)


def _layers(cfg: ModelConfig, params: Params, cache: Optional[Params]
            ) -> Iterator[Tuple[str, Params, Optional[Params]]]:
    """(kind, params, cache) of each layer in the reference's order: the
    groups' slots, then the remainder layers; a group's params and cache
    are views of the slot's stacks."""
    n_groups, rem = _pattern_info(cfg)
    slots = params["layers"]["slots"]
    for g in range(n_groups):
        for s, kind in enumerate(cfg.layer_pattern):
            yield (kind, tree_map(lambda t: t[g], slots[s]),
                   None if cache is None
                   else tree_map(lambda t: t[g], cache["slots"][s]))
    for i in range(rem):
        yield (cfg.layer_pattern[i], params["rem"][i],
               None if cache is None else cache["rem"][i])


# =============================================================================
# forward / serving
# =============================================================================
def _cache_len(cfg: ModelConfig, seq: int) -> int:
    return min(seq, cfg.window) if cfg.window > 0 else seq


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor
           ) -> torch.Tensor:
    x = params["embed"][tokens] * math.sqrt(cfg.d_model)
    return shard(x.to(params["embed"].dtype), ("batch", "seq", "none"))


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            patches=None, return_cache: bool = False,
            cache_seq: Optional[int] = None
            ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Full-sequence forward of ``tokens`` (B, S): the final-norm hidden
    states and, with ``return_cache``, the cache for ``cache_seq or S``
    positions (``init_cache``'s layout: an L layer's last ``min(S, CL)``
    positions at slots ``p % CL``, zeros elsewhere).  ``patches`` is
    ignored, as in the reference."""
    x = _embed(cfg, params, tokens)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    if not return_cache:
        x = groups_forward(cfg, params, x, positions, 0,
                           _pattern_info(cfg)[0])
        x = rem_forward(cfg, params, x, positions)
        return L.rms_norm(x, params["final_norm"]), None
    W = cfg.rglru.conv_width
    if S < W - 1:
        raise ValueError(f"a prefill needs at least conv_width - 1 = {W - 1} "
                         f"tokens to fill the conv cache; got {S}")
    cache = init_cache(cfg, B, cache_seq or S, x.dtype, x.device)
    for kind, p, c in _layers(cfg, params, cache):
        x, made = apply_block(cfg, kind, p, x, positions)
        if kind == "R":
            c["conv"].copy_(made["conv"])
            c["state"].copy_(made["state"])
        else:
            T.write_prefill_kv(c["k"], c["v"], made)
    return L.rms_norm(x, params["final_norm"]), cache


def _group(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
           slot_params: List[Params]) -> torch.Tensor:
    for kind, p in zip(cfg.layer_pattern, slot_params):
        x, _ = apply_block(cfg, kind, p, x, positions)
    return x


def groups_forward(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   positions: torch.Tensor, start: int, stop: int
                   ) -> torch.Tensor:
    """Super-blocks ``[start, stop)`` (each the ``layer_pattern``'s layers
    of one group) over the full sequence, each rematerialised in the
    backward when ``cfg.remat``: the split path cuts between them."""
    slots = params["layers"]["slots"]
    for g in range(start, stop):
        x = L.remat(cfg.remat, lambda x_, pos, ps: _group(cfg, x_, pos, ps),
                    x, positions, [tree_map(lambda t: t[g], slot)
                                   for slot in slots])
    return x


def rem_forward(cfg: ModelConfig, params: Params, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """The remainder layers after the groups (no remat, as the
    reference)."""
    for i, p in enumerate(params["rem"]):
        x, _ = apply_block(cfg, cfg.layer_pattern[i], p, x, positions)
    return x


def loss_fn(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (-1 ignored), the logits soft-capped."""
    hidden, _ = forward(cfg, params, batch["tokens"])
    return L.chunked_ce_loss(hidden, unembed_matrix(cfg, params),
                             batch["labels"], cfg.logit_softcap)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype,
               device=None) -> Params:
    device = resolve_device(device)
    n_groups, rem = _pattern_info(cfg)
    CL = _cache_len(cfg, seq_len)
    w = cfg.rglru.lru_width or cfg.d_model
    W = cfg.rglru.conv_width

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def one(kind: str, lead: Tuple[int, ...]) -> Params:
        if kind == "R":
            return {"conv": zeros(lead + (batch, W - 1, w)),
                    "state": zeros(lead + (batch, w))}
        shape = lead + (batch, CL, cfg.num_kv_heads, cfg.head_dim)
        return {"k": zeros(shape), "v": zeros(shape)}

    rem_caches: List[Params] = [one(cfg.layer_pattern[i], ())
                                for i in range(rem)]
    return {"slots": tuple(one(k, (n_groups,)) for k in cfg.layer_pattern),
            "rem": rem_caches}


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            patches=None, target_seq: Optional[int] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Process the prompt (at least ``conv_width - 1`` tokens); returns
    (last-token fp32 logits, cache for ``target_seq`` positions)."""
    hidden, cache = forward(cfg, params, tokens, return_cache=True,
                            cache_seq=target_seq)
    return T.lm_logits(cfg, params, hidden[:, -1]), cache


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                token: torch.Tensor, pos) -> Tuple[torch.Tensor, Params]:
    """One decode step of ``token`` (B, 1) at ``pos``, an int or 0-d tensor
    or a (B,) tensor of per-row positions.  Updates ``cache`` in place and
    returns ``(fp32 logits (B, V), cache)``."""
    x = _embed(cfg, params, token)
    pos = torch.as_tensor(pos, device=x.device)
    positions = pos[None] if pos.dim() == 0 else pos[:, None]
    for kind, p, c in _layers(cfg, params, cache):
        x, _ = apply_block(cfg, kind, p, x, positions, cache=c,
                           decode_pos=pos)
    x = L.rms_norm(x, params["final_norm"])
    return T.lm_logits(cfg, params, x[:, -1]), cache
