"""The paper's VGG-5 / VGG-8 (counterpart of ``repro/models/vgg.py``) with
split execution at offloading points.

The reference's layout is kept at every public function: activations are
NHWC ``(B, H, W, C)``, conv weights HWIO ``(3, 3, I, O)``, FC weights
``(in, out)`` with the rows of the first FC in H, W, C order.  Params are a
per-layer list of dicts (``{b, bn_bias, bn_scale, w}`` per conv, ``{b, w}``
per FC, ``{}`` per max-pool), which is also the flat buffer's leaf order.
The conv and pool calls see an NCHW view of the NHWC tensor (PyTorch's
channels-last memory format), so no activation is copied to change layout.

Batch norm always normalizes with the batch's own statistics (population
variance, no running stats), in training and in evaluation alike, as the
reference does; ``nn.BatchNorm2d`` in eval mode would not.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.vgg import VGGConfig

Params = List[Dict[str, torch.Tensor]]


def _layer_shapes(cfg: VGGConfig) -> List[Tuple[int, int, int]]:
    """(H, W, C) *after* each layer (FC layers: (1, 1, units))."""
    h = w = cfg.input_hw
    c = cfg.input_ch
    out = []
    for spec in cfg.layers:
        if spec.startswith("C"):
            c = int(spec[1:])
        elif spec == "MP":
            h //= 2
            w //= 2
        else:  # FC
            h = w = 1
            c = int(spec[2:])
        out.append((h, w, c))
    return out


def init(cfg: VGGConfig, generator: Optional[torch.Generator] = None,
         device=None) -> Params:
    """Random params with the reference's distributions (conv and FC
    weights N(0, 1) / sqrt(fan_in), biases 0, BN scale 1 and bias 0).  The
    draws come from ``generator`` on the CPU, so a seed gives the same
    weights on every device; they are not the reference's threefry draws.
    ``device=None`` puts them on the card (raising if none is visible);
    pass ``device="cpu"`` for the CPU."""
    device = resolve_device(device)
    shapes = _layer_shapes(cfg)
    params: Params = []
    in_c = cfg.input_ch
    in_feat = None

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    for i, spec in enumerate(cfg.layers):
        if spec.startswith("C"):
            out_c = int(spec[1:])
            params.append({
                "w": normal(3, 3, in_c, out_c) / math.sqrt(9 * in_c),
                "b": torch.zeros(out_c),
                "bn_scale": torch.ones(out_c),
                "bn_bias": torch.zeros(out_c),
            })
            in_c = out_c
        elif spec == "MP":
            params.append({})
        else:
            units = int(spec[2:])
            if in_feat is None:
                ph, pw, pc = shapes[i - 1]
                in_feat = ph * pw * pc
            params.append({"w": normal(in_feat, units) / math.sqrt(in_feat),
                           "b": torch.zeros(units)})
            in_feat = units
    return [{k: v.to(device) for k, v in layer.items()} for layer in params]


def _batch_norm(x: torch.Tensor, scale, bias, eps=1e-5) -> torch.Tensor:
    var, mean = torch.var_mean(x, dim=(0, 1, 2), correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def apply_range(cfg: VGGConfig, params: Params, x: torch.Tensor,
                start: int, stop: int) -> torch.Tensor:
    """Run layers [start, stop). x is the NHWC input / cut activation."""
    for i in range(start, stop):
        spec = cfg.layers[i]
        p = params[i]
        if spec.startswith("C"):
            x = F.conv2d(x.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1),
                         padding=1).permute(0, 2, 3, 1)
            x = torch.relu(_batch_norm(x + p["b"], p["bn_scale"],
                                       p["bn_bias"]))
        elif spec == "MP":
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        else:
            if x.dim() == 4:
                x = x.reshape(x.shape[0], -1)       # H, W, C order
            x = x @ p["w"] + p["b"]
            if i < len(cfg.layers) - 1:
                x = torch.relu(x)
    return x


def forward(cfg: VGGConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    return apply_range(cfg, params, x, 0, len(cfg.layers))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean of logsumexp - gold logit; int32 labels become int64 only here,
    at the gather."""
    logits = logits.to(torch.float32)
    gold = logits.gather(-1, labels.to(torch.int64)[:, None])[:, 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - gold)


def loss_fn(cfg: VGGConfig, params: Params, batch) -> torch.Tensor:
    return cross_entropy(forward(cfg, params, batch["images"]),
                         batch["labels"])


def split_loss(cfg: VGGConfig, params: Params, batch, op_layer: int
               ) -> torch.Tensor:
    """The loss through an explicit cut: layers ``[0, op_layer)``, then
    ``[op_layer, L)`` on their activation."""
    acts = apply_range(cfg, params, batch["images"], 0, op_layer)
    return cross_entropy(apply_range(cfg, params, acts, op_layer,
                                     len(cfg.layers)), batch["labels"])


def accuracy(cfg: VGGConfig, params: Params, batch) -> torch.Tensor:
    logits = forward(cfg, params, batch["images"])
    return torch.mean((torch.argmax(logits, -1)
                       == batch["labels"].to(torch.int64)).to(torch.float32))


# =============================================================================
# cost-model hooks (per-sample)
# =============================================================================
def layer_flops(cfg: VGGConfig) -> List[float]:
    """Forward FLOPs per layer per sample (backward ~ 2x, applied by the
    caller)."""
    shapes = _layer_shapes(cfg)
    in_c = cfg.input_ch
    flops = []
    in_feat = None
    for i, spec in enumerate(cfg.layers):
        h, w, c = shapes[i]
        if spec.startswith("C"):
            flops.append(2.0 * h * w * c * in_c * 9)
            in_c = c
        elif spec == "MP":
            flops.append(float(h * w * c * 4))
        else:
            if in_feat is None:
                ph, pw, pc = shapes[i - 1]
                in_feat = ph * pw * pc
            flops.append(2.0 * in_feat * c)
            in_feat = c
    return flops


def activation_bytes(cfg: VGGConfig, layer_idx: int, bytes_per_el: int = 4
                     ) -> float:
    """Bytes of the activation *after* layer_idx, per sample."""
    h, w, c = _layer_shapes(cfg)[layer_idx]
    return float(h * w * c * bytes_per_el)


def op_flops_fraction(cfg: VGGConfig) -> List[float]:
    """Fraction of total fwd FLOPs on the device for each OP (paper: VGG-5
    -> 0.1, 0.66, 0.94, 1.0)."""
    fl = layer_flops(cfg)
    total = sum(fl)
    return [sum(fl[:op]) / total for op in cfg.ops]
