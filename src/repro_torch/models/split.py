"""Split-point (Offloading Point) execution for the dense, MoE and VLM
transformers (counterpart of ``repro/models/split.py``).

FedAdapt's mechanism on an LM: the client runs the embedding and layers
[0, op), ships the cut activation ("smashed data", (B, S, d_model) at every
boundary), the server runs layers [op, L), the final norm and the loss.
The cut slices the stacked per-layer params, so both stages are
``transformer.layers_forward`` over their range, each layer
rematerialised in the backward when ``cfg.remat``.  ``quantize=True``
sends the cut through the int8 fake-quant (``kernels/quant_transfer``,
straight-through gradient).

``cut_bytes`` is L(mu) of Eq. 1: constant across OPs for an LM, unlike
VGG's pooled activations.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.quant_transfer import fake_quant_int8
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = Dict[str, object]


def num_boundaries(cfg: ModelConfig) -> int:
    """OP candidates: after each layer, 0..num_layers (0 = everything on
    the server ... num_layers = device-native)."""
    return cfg.num_layers + 1


def prefix_forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   op: int, patches: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Client stage: embed (+ the VLM's patches) and layers [0, op).
    Returns the cut activations (B, S, d)."""
    x = T.embed_inputs(cfg, params, tokens, patches)
    return T.layers_forward(cfg, params, x, 0, op)


def suffix_forward(cfg: ModelConfig, params: Params, acts: torch.Tensor,
                   op: int) -> torch.Tensor:
    """Server stage: layers [op, L) and the final norm."""
    x = T.layers_forward(cfg, params, acts, op, cfg.num_layers)
    return L.rms_norm(x, params["final_norm"])


def suffix_loss(cfg: ModelConfig, params: Params, acts: torch.Tensor,
                labels: torch.Tensor, op: int) -> torch.Tensor:
    """Server stage ending in the loss: layers [op, L), norm and the
    chunked cross-entropy (labels -1 over the VLM's patches)."""
    if cfg.family == "vlm":
        pad = labels.new_full((labels.shape[0], cfg.num_patches), -1)
        labels = torch.cat([pad, labels], dim=1)
    hidden = suffix_forward(cfg, params, acts, op)
    return L.chunked_ce_loss(hidden, T.unembed_matrix(cfg, params), labels,
                             cfg.logit_softcap)


def split_loss(cfg: ModelConfig, params: Params, batch, op: int,
               quantize: bool = False) -> torch.Tensor:
    """End-to-end loss through the cut, differentiable through the
    transfer."""
    acts = prefix_forward(cfg, params, batch["tokens"], op,
                          batch.get("patches"))
    if quantize:
        acts = fake_quant_int8(acts)      # straight-through int8 transfer
    return suffix_loss(cfg, params, acts, batch["labels"], op)


def cut_bytes(cfg: ModelConfig, batch: int, seq: int,
              bytes_per_el: int = 2, quantize: bool = False) -> float:
    """L(mu): activation bytes crossing the cut, one way, per step (the
    backward sends the same-shaped gradient back: callers double it)."""
    per = 1 if quantize else bytes_per_el
    return float(batch * seq * cfg.d_model * per)
