"""Model API by family (counterpart of ``repro/models/api.py``).

    params = init(cfg, seed, dtype, device)
    logits, cache = prefill(cfg, params, {"tokens": tokens}, target_seq)
    logits, cache = decode(cfg, params, cache, token, pos)

Only the ``dense`` family is ported; ``moe``, ``vlm``, ``ssm``, ``hybrid``
and ``encdec`` raise ``NotImplementedError`` naming their ROADMAP item, as
does ``loss`` (LM training).
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict

import torch

from repro_torch import not_ported
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

_FAMILIES: Dict[str, ModuleType] = {"dense": transformer}
_KNOWN = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")


def get_model(cfg: ModelConfig) -> ModuleType:
    if cfg.family in _FAMILIES:
        return _FAMILIES[cfg.family]
    if cfg.family in _KNOWN:
        raise not_ported(f"the {cfg.family} model family", "LM families")
    raise KeyError(f"unknown family {cfg.family!r}")


def init(cfg: ModelConfig, seed: int = 0, dtype=torch.float32, device=None):
    return get_model(cfg).init(cfg, seed, dtype, device)


def loss(cfg: ModelConfig, params, batch):
    raise not_ported("the LM training loss (loss_fn)", "LM training")


def prefill(cfg: ModelConfig, params, batch, target_seq=None):
    return get_model(cfg).prefill(cfg, params, batch["tokens"],
                                  batch.get("patches"), target_seq=target_seq)


def init_cache(cfg: ModelConfig, batch_size: int, seq_len: int, dtype,
               device=None):
    return get_model(cfg).init_cache(cfg, batch_size, seq_len, dtype, device)


def decode(cfg: ModelConfig, params, cache, token, pos):
    return get_model(cfg).decode_step(cfg, params, cache, token, pos)
