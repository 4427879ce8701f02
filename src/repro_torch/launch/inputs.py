"""Stand-ins for every model input of every (arch x shape) cell, and their
specs (counterpart of ``repro/launch/inputs.py``).

A stand-in is a ``meta`` tensor, the counterpart of JAX's
``ShapeDtypeStruct``: shape and dtype, no storage.  A spec is a plain
tuple with one entry a dim (a mesh axis name, a tuple of them, or
``None``), as ``parallel.sharding.param_pspecs`` gives them.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import api
from repro_torch.parallel.sharding import AxisRules, map_with_path

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def text_len(cfg: ModelConfig, seq: int) -> int:
    return seq - cfg.num_patches if cfg.family == "vlm" else seq


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                      dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    batch = {
        "tokens": _meta((B, text_len(cfg, S)), torch.int32),
        "labels": _meta((B, text_len(cfg, S)), torch.int32),
    }
    if cfg.family == "vlm":
        batch["patches"] = _meta((B, cfg.num_patches, cfg.d_model), dtype)
    if cfg.family == "encdec":
        batch["frames"] = _meta((B, cfg.encoder_seq, cfg.d_model), dtype)
    return batch


def batch_pspecs(cfg: ModelConfig, batch: Dict[str, Any],
                 rules: AxisRules) -> Dict[str, tuple]:
    out = {}
    for k, v in batch.items():
        names = ["batch"] + ["none"] * (len(v.shape) - 1)
        out[k] = tuple(rules.resolve(n, d) for n, d in zip(names, v.shape))
    return out


# =============================================================================
# cache specs (decode / prefill)
# =============================================================================
def cache_shapes(cfg: ModelConfig, shape: ShapeConfig,
                 dtype=torch.bfloat16) -> Any:
    return api.init_cache(cfg, shape.global_batch, shape.seq_len, dtype,
                          device=META)


def cache_pspecs(cfg: ModelConfig, cache: Any, rules: AxisRules) -> Any:
    """Name+rank dispatch over cache leaves.

    k/v (…, B, S, KV, D): batch over data, *sequence over model* (seq-sharded
    decode: partial softmax + small cross-shard reduction, flash-decoding
    style; avoids any KV-head divisibility constraint).
    ssm conv (…, B, W, C): channels over model.   ssm state (…, B, H, P, N):
    heads over model.   rg-lru conv/state: width over model.
    """
    def one(path: str, leaf) -> tuple:
        name = path.split("/")[-1]
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec = [None] * nd

        def fits(dim_idx, axis="model"):
            return shape[dim_idx] % rules.mesh.shape.get(axis, 1) == 0
        if name in ("k", "v", "xk", "xv"):
            # (..., B, S, KV, D)
            if fits(nd - 4, "data") and rules.resolve("batch"):
                spec[nd - 4] = rules.resolve("batch", shape[nd - 4])
            if fits(nd - 3):
                spec[nd - 3] = "model"
        elif name == "conv":
            if fits(nd - 3, "data"):
                spec[nd - 3] = rules.resolve("batch", shape[nd - 3])
            if fits(nd - 1):
                spec[nd - 1] = "model"
        elif name == "state":
            b_idx = 1 if nd >= 3 else 0
            if fits(b_idx, "data"):
                spec[b_idx] = rules.resolve("batch", shape[b_idx])
            if fits(nd - 2 if nd >= 4 else nd - 1):
                spec[nd - 2 if nd >= 4 else nd - 1] = "model"
        return tuple(spec)

    return map_with_path(one, cache)


def decode_inputs(cfg: ModelConfig, shape: ShapeConfig
                  ) -> Tuple[Any, torch.Tensor, torch.Tensor]:
    """(cache stand-ins, token stand-in, position stand-in) for the decode
    step."""
    B = shape.global_batch
    return (cache_shapes(cfg, shape),
            _meta((B, 1), torch.int32),
            _meta((), torch.int32))


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                        dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    return train_batch_specs(cfg, shape, dtype)
