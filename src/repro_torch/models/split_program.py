"""``SplitProgram``: offloading-point execution (counterpart of
``repro/models/split_program.py``): one protocol over VGG and every LM
family, so the loops, planners and cost model are generic.

    program = get_split_program(cfg)        # VGGConfig or any ModelConfig
    params  = program.init(seed_or_generator, device)
    acts    = program.client_forward(params, batch, op)    # device stage
    loss    = program.server_forward(params, acts, batch, op)
    loss    = program.loss_through_cut(params, batch, op, quantize=True)
    program.layer_flops(batch, seq)         # fwd FLOPs per split unit
    program.cut_bytes(op, batch, seq)       # L(mu) of Eq. 1, one way

``op`` counts the split units kept on the device: a layer for VGG and the
stacked families (dense, MoE, VLM, SSM, encdec), a super-block of
``len(layer_pattern)`` layers for the hybrid.  ``op == native_op`` is
device-native execution (classic FL: nothing crosses the network, so
nothing is quantized).  ``quantize=True`` sends every tensor of the cut
payload through the int8 fake-quant (``kernels/quant_transfer``) with a
straight-through gradient.  An LM's stages rematerialise their layers in
the backward when ``cfg.remat``.

``width_mask(params, w)`` is a HeteroFL client's static 0/1 subnetwork
(``fl/hetero.py``), as tensors on the params' device with their dtypes:
for VGG the first ``ceil(w * C)`` channels of every hidden layer; for the
LM families the first ``ceil(w * n)`` entries of every axis whose size is
one of the family's ``width_dims`` (the reference's rule, quirks
included).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.vgg import VGGConfig
from repro_torch.core import costmodel as cm
from repro_torch.kernels.quant_transfer import fake_quant_int8
from repro_torch.models import encdec as encdec_model
from repro_torch.models import hybrid as hybrid_model
from repro_torch.models import layers as L
from repro_torch.models import split as lm_split
from repro_torch.models import ssm as ssm_model
from repro_torch.models import transformer as T
from repro_torch.models import vgg as vgg_model
from repro_torch.parallel.sharding import shard
from repro_torch.tree import tree_map

Params = Any


class SplitProgram:
    """Base protocol; subclasses adapt one model family."""

    family: str = ""

    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, generator=None, device=None) -> Params:
        """Random params on ``device`` (``None``: the card) from an integer
        seed (VGG also takes a ``torch.Generator``)."""
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
            acts = tree_map(fake_quant_int8, acts)
        return self.server_forward(params, acts, batch, op)

    def eval_metric(self, params: Params, batch: Dict) -> torch.Tensor:
        """Higher-is-better scalar (accuracy for VGG, -CE loss for LMs)."""
        return -self.loss_through_cut(params, batch, self.native_op)

    @property
    def num_boundaries(self) -> int:
        """OP candidates 0..U (0 = all-server, U = device-native)."""
        raise NotImplementedError

    @property
    def native_op(self) -> int:
        return self.num_boundaries - 1

    def layer_flops(self, batch: int, seq: Optional[int] = None
                    ) -> np.ndarray:
        """Forward FLOPs per split unit for one iteration (one batch)."""
        raise NotImplementedError

    def cut_bytes(self, op: int, batch: int, seq: Optional[int] = None,
                  bytes_per_el: int = 4, quantize: bool = False) -> float:
        """L(mu): bytes crossing the cut at ``op``, one way, per iteration
        (the backward ships the same-shaped gradient; callers double)."""
        raise NotImplementedError

    def op_candidates(self) -> List[int]:
        """The default OP grid for planners (a family may restrict it)."""
        return list(range(self.num_boundaries))

    def flat_layout(self, params: Params, mesh=None):
        """The flat-buffer layout of this program's parameter structure
        (``fl.flatbuf.FlatLayout``): one contiguous fp32 buffer with a
        block-aligned offset per leaf, in the reference's leaf order.  The
        server step, ``serving.ParamStore`` and ``ServeEngine.maybe_swap``
        share it.  ``mesh`` (``parallel.sharding.make_flat_mesh``) selects
        the ``ShardedFlatLayout``."""
        from repro_torch.fl.flatbuf import layout_of
        return layout_of(params, mesh=mesh)

    def shard_params(self, params: Params, mesh) -> Params:
        """``params`` placed for a mesh: on its home place, where the one
        copy of the global lives (a sharded body reads its shard as a view,
        copied only to a place on another device).  The specs a placement
        over distinct cards would use are ``parallel.sharding
        .param_pspecs(params, make_axis_rules(mesh, fsdp=False,
        tp=True))``: tensor-parallel over ``model``, none for VGG."""
        home = mesh.home
        return tree_map(lambda v: v.to(home), params)

    def shard_batches(self, batches: Dict[str, torch.Tensor], mesh
                      ) -> List[Dict[str, torch.Tensor]]:
        """A stacked client-batch dict (leaves ``(G, ...)``, ``G`` a
        multiple of the mesh's ``data`` size: ``client_chunk_pad``) split
        along ``data``: one dict a data shard, its ``G / data`` clients on
        place ``(i, 0)``."""
        data = int(mesh.shape["data"])
        G = int(next(iter(batches.values())).shape[0])
        if G % data:
            raise ValueError(f"{G} clients do not split over data={data}")
        n = G // data
        return [{k: v[i * n:(i + 1) * n].to(mesh.devices[i, 0])
                 for k, v in batches.items()} for i in range(data)]

    @staticmethod
    def _width_keep(n: int, width: float) -> int:
        """How many of ``n`` channels a ``width``-fraction client keeps."""
        return max(1, int(math.ceil(float(width) * n)))

    def width_dims(self) -> frozenset:
        """Axis sizes that scale with the model's width (hidden dims): any
        param axis whose length is in this set is sliced by
        ``width_mask``.  Each family says which."""
        raise NotImplementedError

    def width_mask(self, params: Params, width: float) -> Params:
        """The static 0/1 mask tree of a ``width``-fraction client, nested
        across widths (a narrower mask is a subset of a wider one), in the
        params' structure, each mask a tensor of its leaf's dtype on its
        device.  Every axis whose size is in ``width_dims()`` keeps its
        first ``ceil(width * n)`` entries, whatever the axis means (an
        axis that merely has a hidden dim's size is sliced too, as in the
        reference), except axis 0 of a leaf under a dict key containing
        ``"layers"`` (the stacked layer axis: ``layers``, ``enc_layers``,
        the hybrid's ``layers.slots``; the hybrid's ``rem`` list holds
        unstacked layers, so its axis 0 is sliced).  ``width=1.0`` gives
        all ones."""
        if not 0.0 < width <= 1.0:
            raise ValueError(f"width={width} outside (0, 1]")
        dims = self.width_dims()

        def one(leaf, stacked):
            m = np.ones(tuple(leaf.shape), np.float32)
            for ax in range(1 if stacked else 0, leaf.dim()):
                n = leaf.shape[ax]
                if n in dims:
                    keep = self._width_keep(n, width)
                    if keep < n:
                        sl = [slice(None)] * leaf.dim()
                        sl[ax] = slice(keep, None)
                        m[tuple(sl)] = 0.0
            return torch.tensor(m, dtype=leaf.dtype, device=leaf.device)

        def walk(tree, stacked):
            if isinstance(tree, dict):
                return {k: walk(v, stacked or "layers" in str(k))
                        for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(walk(t, stacked) for t in tree)
            return one(tree, stacked)

        return walk(params, False)


class VGGSplitProgram(SplitProgram):
    family = "vgg"

    def init(self, generator=None, device=None) -> Params:
        """Random params from ``generator``: an integer seed draws from
        ``torch.Generator().manual_seed(seed)``."""
        if isinstance(generator, int):
            generator = torch.Generator().manual_seed(generator)
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

    def layer_flops(self, batch, seq=None) -> np.ndarray:
        return np.asarray(vgg_model.layer_flops(self.cfg),
                          np.float64) * batch

    def cut_bytes(self, op, batch, seq=None, bytes_per_el=4,
                  quantize=False):
        if op >= self.native_op:
            return 0.0
        per = 1 if quantize else bytes_per_el
        if op == 0:
            return float(batch * self.cfg.input_hw ** 2 * self.cfg.input_ch
                         * per)
        return vgg_model.activation_bytes(self.cfg, op - 1, per) * batch

    def op_candidates(self) -> List[int]:
        return list(self.cfg.ops)

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


# =============================================================================
# dense / MoE / VLM transformers (through models/split.py)
# =============================================================================
class LMSplitProgram(SplitProgram):
    family = "lm"

    def init(self, generator=0, device=None) -> Params:
        """Random params (``models.<family>.init``) from the integer seed
        ``generator``."""
        return T.init(self.cfg, int(generator), device=device)

    def client_forward(self, params, batch, op):
        return lm_split.prefix_forward(self.cfg, params, batch["tokens"], op,
                                       batch.get("patches"))

    def server_forward(self, params, acts, batch, op):
        return lm_split.suffix_loss(self.cfg, params, acts, batch["labels"],
                                    op)

    @property
    def num_boundaries(self) -> int:
        return lm_split.num_boundaries(self.cfg)

    def _eff_seq(self, seq: int) -> int:
        return seq + (self.cfg.num_patches if self.cfg.family == "vlm"
                      else 0)

    def layer_flops(self, batch, seq=None) -> np.ndarray:
        assert seq is not None, "LM split programs need the sequence length"
        return cm.lm_layer_flops(self.cfg, self._eff_seq(seq)) * batch

    def cut_bytes(self, op, batch, seq=None, bytes_per_el=4,
                  quantize=False):
        if op >= self.native_op:
            return 0.0
        assert seq is not None, "LM split programs need the sequence length"
        return lm_split.cut_bytes(self.cfg, batch, self._eff_seq(seq),
                                  bytes_per_el, quantize)

    def width_dims(self) -> frozenset:
        cfg = self.cfg
        dims = {cfg.d_model, cfg.d_ff, cfg.q_dim, cfg.kv_dim}
        dims.discard(cfg.vocab_size)    # vocab axes are never width-scaled
        return frozenset(d for d in dims if d > 1)


# =============================================================================
# SSM (Mamba-2): the same stacked cut, attention-free blocks
# =============================================================================
class SSMSplitProgram(LMSplitProgram):
    family = "ssm"

    def init(self, generator=0, device=None) -> Params:
        return ssm_model.init(self.cfg, int(generator), device=device)

    def client_forward(self, params, batch, op):
        x = shard(params["embed"][batch["tokens"]], ("batch", "seq", "none"))
        return ssm_model.layers_forward(self.cfg, params, x, 0, op)

    def server_forward(self, params, acts, batch, op):
        x = ssm_model.layers_forward(self.cfg, params, acts, op,
                                     self.cfg.num_layers)
        hidden = L.rms_norm(x, params["final_norm"])
        return L.chunked_ce_loss(hidden, params["unembed"], batch["labels"])

    def width_dims(self) -> frozenset:
        # the residual stream and the out-projection's input; the
        # in-projection's segments (z|x|B|C|dt) and the per-head params
        # stay full width
        d_inner = ssm_model.dims(self.cfg)[0]
        dims = {self.cfg.d_model, d_inner}
        dims.discard(self.cfg.vocab_size)
        return frozenset(d for d in dims if d > 1)


# =============================================================================
# hybrid (RecurrentGemma): the cut between super-blocks
# =============================================================================
class HybridSplitProgram(LMSplitProgram):
    """Layers of mixed kinds are grouped into super-blocks of
    ``len(cfg.layer_pattern)`` layers, and the cut lands between them.  The
    remainder layers (38 = 12 * 3 + 2) ride with the last unit: they run on
    the device only at the native OP, on the server otherwise."""

    family = "hybrid"

    def init(self, generator=0, device=None) -> Params:
        return hybrid_model.init(self.cfg, int(generator), device=device)

    def _groups(self) -> int:
        return hybrid_model._pattern_info(self.cfg)[0]

    @staticmethod
    def _positions(x: torch.Tensor) -> torch.Tensor:
        return torch.arange(x.shape[1], dtype=torch.int32, device=x.device)

    def client_forward(self, params, batch, op):
        x = hybrid_model._embed(self.cfg, params, batch["tokens"])
        return hybrid_model.groups_forward(self.cfg, params, x,
                                           self._positions(x), 0, op)

    def server_forward(self, params, acts, batch, op):
        positions = self._positions(acts)
        x = hybrid_model.groups_forward(self.cfg, params, acts, positions,
                                        op, self._groups())
        x = hybrid_model.rem_forward(self.cfg, params, x, positions)
        hidden = L.rms_norm(x, params["final_norm"])
        return L.chunked_ce_loss(hidden,
                                 hybrid_model.unembed_matrix(self.cfg, params),
                                 batch["labels"], self.cfg.logit_softcap)

    @property
    def num_boundaries(self) -> int:
        return self._groups() + 1

    def layer_flops(self, batch, seq=None) -> np.ndarray:
        assert seq is not None, "LM split programs need the sequence length"
        per_layer = cm.lm_layer_flops(self.cfg, seq) * batch
        P = len(self.cfg.layer_pattern)
        G = self._groups()
        units = [per_layer[g * P:(g + 1) * P].sum() for g in range(G)]
        units[-1] += per_layer[G * P:].sum()    # the remainder: last unit
        return np.asarray(units, np.float64)

    def width_dims(self) -> frozenset:
        cfg = self.cfg
        lru = (cfg.rglru.lru_width or cfg.d_model) if cfg.rglru \
            else cfg.d_model
        dims = {cfg.d_model, cfg.d_ff, cfg.q_dim, cfg.kv_dim, lru}
        dims.discard(cfg.vocab_size)
        return frozenset(d for d in dims if d > 1)


# =============================================================================
# encoder-decoder (Whisper): the encoder on the device, the cut in the
# decoder
# =============================================================================
class EncDecSplitProgram(LMSplitProgram):
    """The encoder is the modality frontend and always runs on the device;
    the cut moves through the decoder stack.  The payload is (decoder acts,
    encoder output): the server's cross-attention needs ``enc_out``."""

    family = "encdec"

    def init(self, generator=0, device=None) -> Params:
        return encdec_model.init(self.cfg, int(generator), device=device)

    def client_forward(self, params, batch, op):
        enc_out = encdec_model.encode(self.cfg, params, batch["frames"])
        x = shard(params["embed"][batch["tokens"]], ("batch", "seq", "none"))
        x = encdec_model.decoder_layers(self.cfg, params, x, enc_out, 0, op)
        return (x, enc_out)

    def server_forward(self, params, acts, batch, op):
        x, enc_out = acts
        x = encdec_model.decoder_layers(self.cfg, params, x, enc_out, op,
                                        self.cfg.num_layers)
        hidden = L.rms_norm(x, params["final_norm"])
        return L.chunked_ce_loss(hidden, params["unembed"], batch["labels"])

    def layer_flops(self, batch, seq=None) -> np.ndarray:
        assert seq is not None, "LM split programs need the sequence length"
        cfg = self.cfg
        S, Tn = seq, cfg.encoder_seq
        n_mlp = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
        ffn = 2.0 * S * n_mlp * cfg.d_model * cfg.d_ff
        self_attn = (2.0 * S * cfg.d_model * (2 * cfg.q_dim + 2 * cfg.kv_dim)
                     + 4.0 * S * S * cfg.q_dim)
        cross = (2.0 * S * cfg.d_model * cfg.q_dim
                 + 4.0 * Tn * cfg.d_model * cfg.kv_dim
                 + 4.0 * S * Tn * cfg.q_dim
                 + 2.0 * S * cfg.q_dim * cfg.d_model)
        dec = self_attn + cross + ffn
        enc_layer = (2.0 * Tn * cfg.d_model * (2 * cfg.q_dim + 2 * cfg.kv_dim)
                     + 4.0 * Tn * Tn * cfg.q_dim
                     + 2.0 * Tn * n_mlp * cfg.d_model * cfg.d_ff)
        units = np.full(cfg.num_layers, dec, np.float64)
        # the encoder frontend rides the first unit (it always runs on the
        # device, so Eq. 1's device fraction is approximate at OP 0)
        units[0] += cfg.encoder_layers * enc_layer
        return units * batch

    def cut_bytes(self, op, batch, seq=None, bytes_per_el=4,
                  quantize=False):
        if op >= self.native_op:
            return 0.0
        assert seq is not None, "LM split programs need the sequence length"
        # the payload: the decoder's acts and the encoder's output
        return lm_split.cut_bytes(self.cfg, batch, seq + self.cfg.encoder_seq,
                                  bytes_per_el, quantize)


# =============================================================================
# registry
# =============================================================================
_FAMILY_PROGRAMS = {
    "dense": LMSplitProgram,
    "moe": LMSplitProgram,
    "vlm": LMSplitProgram,
    "ssm": SSMSplitProgram,
    "hybrid": HybridSplitProgram,
    "encdec": EncDecSplitProgram,
}


def get_split_program(cfg) -> SplitProgram:
    """The SplitProgram of a VGGConfig or of any ModelConfig family."""
    if isinstance(cfg, VGGConfig):
        return VGGSplitProgram(cfg)
    if isinstance(cfg, ModelConfig):
        try:
            return _FAMILY_PROGRAMS[cfg.family](cfg)
        except KeyError:
            raise KeyError(
                f"no SplitProgram for family {cfg.family!r}; known: "
                f"{sorted(_FAMILY_PROGRAMS)}") from None
    raise TypeError(f"unsupported config type {type(cfg).__name__}")
