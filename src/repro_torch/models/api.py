"""Model API by family (counterpart of ``repro/models/api.py``).

    params = init(cfg, seed, dtype, device)
    loss   = loss(cfg, params, batch)
    logits, cache = prefill(cfg, params, batch, target_seq)
    logits, cache = decode(cfg, params, cache, token, pos)

``batch`` holds ``tokens`` (and ``labels`` for the loss), plus the
frontend stubs: ``patches`` for the VLM and ``frames`` for encdec.  All six LM families are ported: ``dense``,
``moe`` and ``vlm`` (module ``transformer``), ``ssm`` (mamba2, module
``ssm``), ``hybrid`` (recurrentgemma, module ``hybrid``) and ``encdec``
(whisper, module ``encdec``).  ``loss`` is the family's ``loss_fn``, the
training loss.
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, ssm, transformer

_FAMILIES: Dict[str, ModuleType] = {"dense": transformer, "moe": transformer,
                                    "vlm": transformer, "ssm": ssm,
                                    "hybrid": hybrid, "encdec": encdec}


def get_model(cfg: ModelConfig) -> ModuleType:
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise KeyError(f"unknown family {cfg.family!r}") from None


def init(cfg: ModelConfig, seed: int = 0, dtype=torch.float32, device=None):
    return get_model(cfg).init(cfg, seed, dtype, device)


def loss(cfg: ModelConfig, params, batch) -> torch.Tensor:
    return get_model(cfg).loss_fn(cfg, params, batch)


def prefill(cfg: ModelConfig, params, batch, target_seq=None):
    extra = batch.get("frames") if cfg.family == "encdec" \
        else batch.get("patches")
    return get_model(cfg).prefill(cfg, params, batch["tokens"], extra,
                                  target_seq=target_seq)


def init_cache(cfg: ModelConfig, batch_size: int, seq_len: int, dtype,
               device=None):
    return get_model(cfg).init_cache(cfg, batch_size, seq_len, dtype, device)


def decode(cfg: ModelConfig, params, cache, token, pos):
    return get_model(cfg).decode_step(cfg, params, cache, token, pos)
