"""The plain reference of the Mamba-2 family (arXiv:2405.21060): each
block is RMS norm, the in-projection to (z, x, B, C, dt), a depthwise
causal conv and SiLU over (x, B, C), the SSD over chunks, the D skip, the
gated RMS norm and the out-projection; a final norm and a separate
unembedding.  In the port's parameter layout.

The SSD is the chunked form of the paper's listing: within a chunk the
causal decay matrix from segment sums (masked to -inf before the
``exp``, so the gradient stays finite), across chunks the states carried
by the chunks' total decays.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import common as C
from portbench.work import counts

KERNELS = "ssd"


def _dims(cfg: dict):
    s = cfg["ssm"]
    d_inner = s["expand"] * cfg["d_model"]
    heads = d_inner // s["head_dim"]
    N = s["state_dim"]
    conv_dim = d_inner + 2 * N
    return d_inner, heads, s["head_dim"], N, conv_dim, \
        2 * d_inner + 2 * N + heads


def init(cfg: dict, seed: int, device) -> C.Tree:
    """Weights from ``seed`` on ``device`` with the port's distributions:
    projections N(0, 1/d_in), the embedding N(0, 0.02^2), the conv kernel
    N(0, 0.1^2), norms and the conv bias 0, A_log = log(1..16) over the
    heads, D = 1, dt_bias the softplus inverse of dt ~ logU(1e-3, 1e-1)."""
    d, L, V = cfg["d_model"], cfg["num_layers"], cfg["vocab_size"]
    d_inner, H, P, N, conv_dim, proj = _dims(cfg)
    W = cfg["ssm"]["conv_width"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = C.draw(gen, device, [
        ("embed", (V, d), 0.02),
        ("layers/in_proj", (L, d, proj), d ** -0.5),
        ("layers/conv_w", (L, W, conv_dim), 0.1),
        ("layers/out_proj", (L, d_inner, d), d_inner ** -0.5),
        ("unembed", (d, V), d ** -0.5)])
    dt = torch.empty((L, H), dtype=torch.float32, device=device)
    dt = torch.exp(dt.uniform_(math.log(1e-3), math.log(1e-1),
                               generator=gen))
    flat.update({
        "layers/ln": torch.zeros((L, d), device=device),
        "layers/conv_b": torch.zeros((L, conv_dim), device=device),
        "layers/A_log": torch.log(torch.linspace(
            1.0, 16.0, H, device=device)).repeat(L, 1),
        "layers/D": torch.ones((L, H), device=device),
        "layers/dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "layers/gate_ln": torch.zeros((L, d_inner), device=device),
        "final_norm": torch.zeros((d,), device=device)})
    return C.nest(flat)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """``out[..., i, j] = sum(x[..., j+1 : i+1])`` for ``j <= i``, -inf
    above the diagonal."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    below = torch.ones(T, T, dtype=torch.bool, device=x.device).tril(-1)
    seg = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    keep = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    return seg.masked_fill(~keep, float("-inf"))


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """y of the SSD: x (b, s, h, p), dt (b, s, h), A (h,), B and C
    (b, s, n), s a multiple of ``chunk``."""
    b, s, h, p = x.shape
    c, q = s // chunk, chunk
    X = (x * dt[..., None]).view(b, c, q, h, p)
    Adt = (dt * A).view(b, c, q, h).permute(0, 3, 1, 2)      # b h c q
    Bc, Cc = Bm.view(b, c, q, -1), Cm.view(b, c, q, -1)
    cum = torch.cumsum(Adt, dim=-1)
    Ldec = torch.exp(_segsum(Adt))                            # b h c q q
    y_in = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", Cc, Bc, Ldec, X)
    decay = torch.exp(cum[..., -1:] - cum)                     # b h c q
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(_segsum(F.pad(cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    y_out = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, states,
                         torch.exp(cum))
    return (y_in + y_out).reshape(b, s, h, p)


def block(cfg: dict):
    d_inner, H, P, N, conv_dim, proj = _dims(cfg)
    W, chunk = cfg["ssm"]["conv_width"], cfg["ssm"]["chunk"]

    def run(p: C.Tree, x: torch.Tensor) -> torch.Tensor:
        B, S, _ = x.shape
        zxbcdt = C.rms_norm(x, p["ln"]) @ p["in_proj"]
        z = zxbcdt[..., :d_inner]
        xbc = zxbcdt[..., d_inner:d_inner + conv_dim]
        dt = torch.logaddexp(zxbcdt[..., d_inner + conv_dim:] + p["dt_bias"],
                             x.new_zeros(()))
        pad = F.pad(xbc, (0, 0, W - 1, 0))
        xbc = F.silu(sum(pad[:, i:i + S] * p["conv_w"][i] for i in range(W))
                     + p["conv_b"])
        xs = xbc[..., :d_inner].reshape(B, S, H, P)
        y = ssd(xs, dt, -torch.exp(p["A_log"]), xbc[..., d_inner:d_inner + N],
                xbc[..., d_inner + N:], min(chunk, S))
        y = (y + p["D"][:, None] * xs).reshape(B, S, d_inner)
        return x + C.rms_norm(y * F.silu(z), p["gate_ln"]) @ p["out_proj"]
    return run


def loss(cfg: dict, params: C.Tree, tokens: torch.Tensor,
         labels: torch.Tensor, op: int, quantize: bool) -> torch.Tensor:
    """Mean next-token cross-entropy through the cut at ``op``."""
    x = params["embed"][tokens.long()]
    x = C.through_cut(block(cfg), params, x, op, cfg["num_layers"],
                      quantize)
    return C.cross_entropy(C.rms_norm(x, params["final_norm"]),
                           params["unembed"], labels)


def matmul_params(cfg: dict) -> int:
    """The in- and out-projections and the unembedding."""
    d_inner, H, P, N, conv_dim, proj = _dims(cfg)
    d = cfg["d_model"]
    return cfg["num_layers"] * (d * proj + d_inner * d) \
        + d * cfg["vocab_size"]


def mixer_work(cfg: dict, rows: int, seq: int, train: bool
               ) -> List[Tuple[str, Dict[str, float]]]:
    """The SSD kernels' model work of one layer: the forward and, while
    training, its backward.  The remat recompute, and the forward passes
    the backward kernel runs again, are not model work."""
    d_inner, H, P, N, conv_dim, proj = _dims(cfg)
    x, Bm = (rows, seq, H, P), (rows, seq, N)
    chunk = cfg["ssm"]["chunk"]
    out = [("forward", counts.ssd_scan_work(x, Bm, chunk=chunk))]
    if train:
        out.append(("backward", counts.ssd_scan_bwd_work(x, Bm, chunk=chunk)))
    return out
