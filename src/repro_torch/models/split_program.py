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
"""
from __future__ import annotations

from typing import Dict, List, Optional

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


def get_split_program(cfg) -> SplitProgram:
    if isinstance(cfg, VGGConfig):
        return VGGSplitProgram(cfg)
    raise not_ported(f"config {type(cfg).__name__} (only VGG runs)",
                     "LM families")
