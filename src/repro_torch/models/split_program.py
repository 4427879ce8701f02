"""``SplitProgram``: offloading-point execution (counterpart of
``repro/models/split_program.py``; the VGG family only so far).

    program = get_split_program(VGG5)
    params  = program.init(generator, device)
    acts    = program.client_forward(params, batch, op)    # device stage
    loss    = program.server_forward(params, acts, batch, op)
    loss    = program.loss_through_cut(params, batch, op, quantize=True)

``op`` counts the split units kept on the device; ``op == native_op`` is
device-native execution (classic FL: nothing crosses the network, so nothing
is quantized).  ``quantize=True`` sends the cut activation through the int8
fake-quant (``kernels/quant_transfer``) with a straight-through gradient.

``width_mask(params, w)`` is a HeteroFL client's static 0/1 subnetwork
(``fl/hetero.py``): the first ``ceil(w * C)`` channels of every hidden
layer, as tensors on the params' device with their dtypes.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import not_ported
from repro_torch.configs.vgg import VGGConfig
from repro_torch.kernels.quant_transfer import fake_quant_int8
from repro_torch.models import vgg as vgg_model

Params = List[Dict[str, torch.Tensor]]


class SplitProgram:
    """Base protocol; subclasses adapt one model family."""

    family: str = ""

    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> Params:
        """Random params on ``device`` (``None``: the card)."""
        raise NotImplementedError

    def client_forward(self, params: Params, batch: Dict, op: int):
        raise NotImplementedError

    def server_forward(self, params: Params, acts, batch: Dict,
                       op: int) -> torch.Tensor:
        raise NotImplementedError

    def loss_through_cut(self, params: Params, batch: Dict, op: int,
                         quantize: bool = False) -> torch.Tensor:
        """End-to-end loss, differentiable through the (optionally int8)
        transfer.  ``op == native_op`` never quantizes: nothing is shipped."""
        acts = self.client_forward(params, batch, op)
        if quantize and op < self.native_op:
            acts = fake_quant_int8(acts)
        return self.server_forward(params, acts, batch, op)

    def eval_metric(self, params: Params, batch: Dict) -> torch.Tensor:
        raise NotImplementedError

    @property
    def num_boundaries(self) -> int:
        """OP candidates 0..U (0 = all-server, U = device-native)."""
        raise NotImplementedError

    @property
    def native_op(self) -> int:
        return self.num_boundaries - 1

    def cut_bytes(self, op: int, batch: int, bytes_per_el: int = 4,
                  quantize: bool = False) -> float:
        raise NotImplementedError

    @staticmethod
    def _width_keep(n: int, width: float) -> int:
        """How many of ``n`` channels a ``width``-fraction client keeps."""
        return max(1, int(math.ceil(float(width) * n)))

    def width_dims(self) -> frozenset:
        """Axis sizes the generic width mask slices (the reference's LM
        families)."""
        raise not_ported("width_dims (generic width masks)", "LM families")

    def width_mask(self, params: Params, width: float) -> Params:
        """The static 0/1 mask tree of a ``width``-fraction client, nested
        across widths (a narrower mask is a subset of a wider one).  The
        generic version over ``width_dims`` is the LM families'."""
        raise not_ported("width_mask (generic width masks)", "LM families")


class VGGSplitProgram(SplitProgram):
    family = "vgg"

    def init(self, generator=None, device=None) -> Params:
        return vgg_model.init(self.cfg, generator, device)

    def client_forward(self, params, batch, op):
        return vgg_model.apply_range(self.cfg, params, batch["images"], 0, op)

    def server_forward(self, params, acts, batch, op):
        logits = vgg_model.apply_range(self.cfg, params, acts, op,
                                       len(self.cfg.layers))
        return vgg_model.cross_entropy(logits, batch["labels"])

    def eval_metric(self, params, batch):
        return vgg_model.accuracy(self.cfg, params, batch)

    @property
    def num_boundaries(self) -> int:
        return len(self.cfg.layers) + 1

    def cut_bytes(self, op, batch, bytes_per_el=4, quantize=False):
        if op >= self.native_op:
            return 0.0
        per = 1 if quantize else bytes_per_el
        if op == 0:
            return float(batch * self.cfg.input_hw ** 2 * self.cfg.input_ch
                         * per)
        return vgg_model.activation_bytes(self.cfg, op - 1, per) * batch

    def width_mask(self, params, width: float) -> Params:
        """Channel-aware HeteroFL mask: every conv and hidden FC keeps its
        first ``ceil(width * C)`` output channels, and its input rows
        follow the previous layer's kept channels.  The first FC's rows
        come from the NHWC flatten (``models/vgg.py``: H, W, C order), so
        a row at position ``pos`` holds channel ``pos % C``.  The logits
        layer keeps every class column."""
        if not 0.0 < width <= 1.0:
            raise ValueError(f"width={width} outside (0, 1]")
        cfg = self.cfg
        masks: List[Dict[str, np.ndarray]] = []
        prev_c = prev_keep = cfg.input_ch          # the full input image
        prev_is_fc = False
        last = len(cfg.layers) - 1
        for i, (spec, p) in enumerate(zip(cfg.layers, params)):
            if spec == "MP":
                masks.append({})
                continue
            if spec.startswith("C"):
                cout = p["w"].shape[-1]
                keep = self._width_keep(cout, width)
                w = np.ones(tuple(p["w"].shape), np.float32)
                w[:, :, prev_keep:, :] = 0.0
                w[:, :, :, keep:] = 0.0
                vec = (np.arange(cout) < keep).astype(np.float32)
                masks.append({"w": w, "b": vec, "bn_scale": vec,
                              "bn_bias": vec})
                prev_c, prev_keep, prev_is_fc = cout, keep, False
            else:                                    # FC
                in_feat, units = p["w"].shape
                keep = units if i == last else self._width_keep(units, width)
                w = np.ones((in_feat, units), np.float32)
                if prev_is_fc:
                    w[prev_keep:, :] = 0.0
                else:
                    w[np.arange(in_feat) % prev_c >= prev_keep, :] = 0.0
                w[:, keep:] = 0.0
                vec = (np.arange(units) < keep).astype(np.float32)
                masks.append({"w": w, "b": vec})
                prev_c, prev_keep, prev_is_fc = units, keep, True
        return [{k: torch.tensor(m[k], dtype=layer[k].dtype,
                                 device=layer[k].device)
                 for k in m} for m, layer in zip(masks, params)]


def get_split_program(cfg) -> SplitProgram:
    if isinstance(cfg, VGGConfig):
        return VGGSplitProgram(cfg)
    raise not_ported(f"config {type(cfg).__name__} (only VGG runs)",
                     "LM families")
