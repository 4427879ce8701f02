"""The plain reference of the dense transformer family (qwen3's block:
RMS norm, q/k norm, rotary embeddings, grouped-query causal attention,
SwiGLU, tied or separate unembedding), in the port's parameter layout.

``cfg`` is the configuration file's ``port`` object (the port's
``ModelConfig`` fields).  Attention is the materialised softmax in fp32,
one layer at a time, each layer recomputed in the backward.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import common as C
from portbench.work import counts

KERNELS = "flash"


def _dims(cfg: dict):
    d, f = cfg["d_model"], cfg["d_ff"]
    H, KV, D = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    return d, f, H, KV, D, H * D, KV * D


def init(cfg: dict, seed: int, device) -> C.Tree:
    """Weights from ``seed`` on ``device``: dense weights N(0, 1/d_in),
    the embedding N(0, 0.02^2), norms at the identity (stored 0), as the
    port draws them, in one draw over one buffer."""
    d, f, H, KV, D, qd, kvd = _dims(cfg)
    L, V = cfg["num_layers"], cfg["vocab_size"]
    normal = [("embed", (V, d), 0.02),
              ("layers/attn/wq", (L, d, qd), d ** -0.5),
              ("layers/attn/wk", (L, d, kvd), d ** -0.5),
              ("layers/attn/wv", (L, d, kvd), d ** -0.5),
              ("layers/attn/wo", (L, qd, d), qd ** -0.5),
              ("layers/ffn/w_gate", (L, d, f), d ** -0.5),
              ("layers/ffn/w_up", (L, d, f), d ** -0.5),
              ("layers/ffn/w_down", (L, f, d), f ** -0.5)]
    if not cfg.get("tie_embeddings", False):
        normal.append(("unembed", (d, V), d ** -0.5))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = C.draw(gen, device, normal)
    zeros = {"layers/ln1": (L, d), "layers/ln2": (L, d),
             "final_norm": (d,)}
    if cfg.get("qk_norm", False):
        zeros.update({"layers/attn/q_norm": (L, D),
                      "layers/attn/k_norm": (L, D)})
    for path, shape in zeros.items():
        flat[path] = torch.zeros(shape, dtype=torch.float32, device=device)
    return C.nest(flat)


def _attention(cfg: dict, p: C.Tree, h: torch.Tensor) -> torch.Tensor:
    d, f, H, KV, D, qd, kvd = _dims(cfg)
    B, S, _ = h.shape
    q = (h @ p["wq"]).view(B, S, H, D)
    k = (h @ p["wk"]).view(B, S, KV, D)
    v = (h @ p["wv"]).view(B, S, KV, D)
    if cfg.get("qk_norm", False):
        q = C.rms_norm(q, p["q_norm"])
        k = C.rms_norm(k, p["k_norm"])
    theta = cfg.get("rope_theta", 10000.0)
    q, k = C.rope(q, theta), C.rope(k, theta)
    qg = q.view(B, S, KV, H // KV, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k) / math.sqrt(D)
    causal = torch.ones((S, S), dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, dim=-1), v)
    return o.reshape(B, S, qd) @ p["wo"]


def block(cfg: dict):
    def run(p: C.Tree, x: torch.Tensor) -> torch.Tensor:
        x = x + _attention(cfg, p["attn"], C.rms_norm(x, p["ln1"]))
        h = C.rms_norm(x, p["ln2"])
        ff = p["ffn"]
        return x + (F.silu(h @ ff["w_gate"]) * (h @ ff["w_up"])) \
            @ ff["w_down"]
    return run


def loss(cfg: dict, params: C.Tree, tokens: torch.Tensor,
         labels: torch.Tensor, op: int, quantize: bool) -> torch.Tensor:
    """Mean next-token cross-entropy through the cut at ``op``."""
    x = params["embed"][tokens.long()]
    x = C.through_cut(block(cfg), params, x, op, cfg["num_layers"],
                      quantize)
    h = C.rms_norm(x, params["final_norm"])
    unembed = params["embed"].T if cfg.get("tie_embeddings", False) \
        else params["unembed"]
    return C.cross_entropy(h, unembed, labels)


def matmul_params(cfg: dict) -> int:
    """Parameters that multiply an activation: the projections, the FFN
    and the unembedding (tied or not); not the embedding lookup or the
    norms."""
    d, f, H, KV, D, qd, kvd = _dims(cfg)
    per_layer = d * qd + 2 * d * kvd + qd * d + 3 * d * f
    return cfg["num_layers"] * per_layer + d * cfg["vocab_size"]


def mixer_work(cfg: dict, rows: int, seq: int, train: bool
               ) -> List[Tuple[str, Dict[str, float]]]:
    """The attention kernels' model work of one layer: a forward (with
    the log-sum-exp while training) and, while training, the backward's
    two kernels.  The remat recompute is not model work."""
    d, f, H, KV, D, qd, kvd = _dims(cfg)
    q, k = (rows, seq, H, D), (rows, seq, KV, D)
    out = [("forward", counts.flash_attention_work(q, k, True, 0, lse=train))]
    if train:
        out += [("backward_dq", counts.flash_attention_bwd_dq_work(q, k, True)),
                ("backward_dkdv",
                 counts.flash_attention_bwd_dkdv_work(q, k, True))]
    return out
