"""Weights carried across between the reference and the port.

The reference's params are pytrees of arrays; as numpy (``np.asarray`` of
each leaf) they map leaf for leaf onto the port's tensors, bitwise, since
both keep the same layout: per-layer dicts, HWIO conv weights, ``(in, out)``
FC and agent weights for VGG and PPO; for the language models, nested
dicts with the per-layer leaves stacked on a leading layer axis: the
transformer's ``{"embed", "layers": {"ln1", "attn": {"wq", ...}, "ffn":
{...}, ...}, "final_norm"}`` (an MoE layer holds ``"moe": {"router",
"w_gate", "w_up", "w_down"}`` with the experts' ``(layers, E, d, f)``
weights, and arctic's ``"dense"`` FFN, where a dense one holds ``"ffn"``;
the VLM adds ``"patch_proj"``) and mamba2's ``{"embed", "layers": {"ln",
"in_proj", "conv_w", ...}, "final_norm", "unembed"}``.  The same two
functions carry the decode caches (``{"k", "v"}`` and ``{"conv",
"state"}``).  The hybrid (recurrentgemma) holds lists: ``{"layers":
{"slots": [one stacked dict per pattern slot]}, "rem": [one dict per
remainder layer]}``, and its caches a tuple ``"slots"`` and a list
``"rem"``; encdec (whisper) adds ``"enc_layers"``, ``"enc_norm"`` and a
``"cross"`` block per decoder layer, and its caches ``"xk"``/``"xv"``.
``tests/test_torch_transformer.py``, ``tests/test_torch_moe.py``,
``tests/test_torch_vlm.py``, ``tests/test_torch_ssm.py``,
``tests/test_torch_hybrid.py`` and ``tests/test_torch_encdec.py`` check
the round trip (reference -> port -> numpy) bit for bit.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import tree_map


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def vgg_params_from_numpy(params: List[Dict[str, np.ndarray]],
                          device=None) -> List[Dict[str, torch.Tensor]]:
    """Reference VGG params (per-layer dicts of arrays) -> port tensors on
    ``device`` (``None``: the card, raising if none is visible)."""
    device = resolve_device(device)
    return [{k: _tensor(v, device) for k, v in layer.items()}
            for layer in params]


def vgg_params_to_numpy(params: List[Dict[str, torch.Tensor]]
                        ) -> List[Dict[str, np.ndarray]]:
    """Port params -> per-layer dicts of numpy arrays (the reference's
    layout)."""
    return [{k: v.detach().cpu().numpy() for k, v in layer.items()}
            for layer in params]


def agent_params_from_numpy(params: Dict[str, Dict[str, np.ndarray]],
                            device=None
                            ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Reference PPO params ``{"actor": {...}, "critic": {...}}`` -> port
    tensors on ``device`` (``None``: the card, raising if none is
    visible).  ``PPOAgent`` runs its actor where these params lie."""
    device = resolve_device(device)
    return {net: {k: _tensor(v, device) for k, v in p.items()}
            for net, p in params.items()}


def lm_params_from_numpy(params, device=None):
    """Reference language-model params or caches (nested dicts, lists and
    tuples of arrays, layers stacked) -> port tensors on ``device``
    (``None``: the card, raising if none is visible), each container kept
    as its own type."""
    device = resolve_device(device)
    return tree_map(lambda a: _tensor(a, device), params)


def lm_params_to_numpy(params):
    """Port language-model params or caches -> the same nesting of numpy
    arrays (the reference's layout)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
