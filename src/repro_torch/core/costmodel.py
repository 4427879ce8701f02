"""Eq. 1 cost model (counterpart of ``repro/core/costmodel.py``, numpy).

    T_t^k = mu * W / C_dev  +  (1 - mu) * W / C_srv  +  L(mu) / Net      (Eq. 1)

A ``Workload`` is the paper's (W, L(mu)) pair materialized per layer:
forward FLOPs per layer and the activation bytes crossing each candidate cut
(Offloading Point).  ``calibrate_linear`` / ``calibrate_device`` fit the
device and server speeds to the paper's measured per-OP tables
(``core/testbed.py``).  ``lm_layer_flops`` / ``lm_workload`` /
``program_workload`` materialize the LM families' workloads, and
``slice_profile`` models a fleet of pod slices as FedAdapt devices (the LM
training driver's simulated cluster).  ``analytic_step_memory_bytes`` is the dry runs' HBM-traffic
model (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.vgg import VGGConfig
from repro_torch.models import vgg as vgg_model

TRAIN_FLOP_MULT = 3.0     # fwd + bwd(2x)


@dataclasses.dataclass(frozen=True)
class Workload:
    """Per-layer forward FLOPs and per-boundary cut sizes, per *iteration*
    (one batch)."""
    name: str
    layer_flops: np.ndarray          # (L,) fwd FLOPs per layer
    cut_bytes: np.ndarray            # (L+1,) activation bytes at boundary i
    train_mult: float = TRAIN_FLOP_MULT

    @property
    def num_layers(self) -> int:
        return len(self.layer_flops)

    @property
    def total_train_flops(self) -> float:
        """One iteration's training FLOPs: the forward's times
        ``train_mult``."""
        return float(self.layer_flops.sum() * self.train_mult)

    def device_fraction(self, op: int) -> float:
        """mu: fraction of compute kept on the device for cut at ``op``."""
        return float(self.layer_flops[:op].sum() / self.layer_flops.sum())

    def op_fractions(self, ops: Sequence[int]) -> List[float]:
        """``device_fraction`` of each OP in ``ops``."""
        return [self.device_fraction(op) for op in ops]


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """A worker: an IoT device in the paper."""
    name: str
    flops_per_s: float               # C_t^k
    bandwidth_bps: float             # Net_t^k (bits/s, matching the paper)


def vgg_workload(cfg: VGGConfig, batch_size: int = 100,
                 bytes_per_el: int = 4) -> Workload:
    fl = np.asarray(vgg_model.layer_flops(cfg), np.float64) * batch_size
    cuts = [float(batch_size * cfg.input_hw ** 2 * cfg.input_ch * bytes_per_el)]
    cuts += [vgg_model.activation_bytes(cfg, i, bytes_per_el) * batch_size
             for i in range(len(cfg.layers))]
    return Workload(cfg.name, fl, np.asarray(cuts, np.float64))


def lm_layer_flops(cfg: ModelConfig, seq: int) -> np.ndarray:
    """Forward FLOPs per layer for one sequence (active params only for
    MoE), the reference's formulas term for term."""
    d, S = cfg.d_model, seq
    per_layer = []
    n_mlp = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
    for i in range(cfg.num_layers):
        kind = cfg.layer_kind(i)
        if cfg.family == "ssm":
            s = cfg.ssm
            di, N = s.expand * d, s.state_dim
            nheads = di // s.head_dim
            proj = 2 * S * d * (2 * di + 2 * N + nheads) + 2 * S * di * d
            conv = 2 * S * (di + 2 * N) * s.conv_width
            Q = min(s.chunk, S)
            ssd = 2 * S * Q * N + 2 * S * Q * di          # scores + intra
            ssd += 2 * S * N * di * 2                     # states + inter
            per_layer.append(proj + conv + ssd)
            continue
        if kind == "R":                                   # RG-LRU block
            w = (cfg.rglru.lru_width or d)
            mix = 2 * S * d * w * 2 + 2 * S * w * w * 2 \
                + 2 * S * w * cfg.rglru.conv_width + 10 * S * w \
                + 2 * S * w * d
        else:                                             # attention
            eff = min(S, cfg.window) if (kind == "L" and cfg.window) else S
            qkvo = 2 * S * d * (2 * cfg.q_dim + 2 * cfg.kv_dim)
            scores = 2 * S * eff * cfg.q_dim * 2          # qk^T + pv
            mix = qkvo + scores
        if cfg.moe is not None:
            ffn = 2 * S * cfg.moe.top_k * n_mlp * d * cfg.d_ff
            ffn += 2 * S * d * cfg.moe.num_experts        # router
            if cfg.moe.dense_residual:
                ffn += 2 * S * n_mlp * d * cfg.d_ff
        elif cfg.d_ff:
            ffn = 2 * S * n_mlp * d * cfg.d_ff
        else:
            ffn = 0.0
        per_layer.append(mix + ffn)
    return np.asarray(per_layer, np.float64)


def lm_embed_head_flops(cfg: ModelConfig, seq: int) -> float:
    return 2.0 * seq * cfg.d_model * cfg.vocab_size      # unembed matmul


def lm_workload(cfg: ModelConfig, batch: int, seq: int,
                bytes_per_el: int = 2) -> Workload:
    fl = lm_layer_flops(cfg, seq) * batch
    # the LM cut activation is (B, S, d) at every boundary
    cut = float(batch * seq * cfg.d_model * bytes_per_el)
    cuts = np.full(cfg.num_layers + 1, cut, np.float64)
    cuts[-1] = 0.0                                       # native: no transfer
    return Workload(cfg.name, fl, cuts)


def program_workload(program, batch: int, seq: Optional[int] = None,
                     bytes_per_el: int = 4) -> Workload:
    """(W, L(mu)) of any ``models.split_program.SplitProgram``: its
    per-unit FLOPs and the cut bytes at every OP."""
    fl = np.asarray(program.layer_flops(batch, seq), np.float64)
    cuts = np.asarray(
        [program.cut_bytes(op, batch, seq, bytes_per_el=bytes_per_el)
         for op in range(program.num_boundaries)], np.float64)
    return Workload(getattr(program.cfg, "name", program.family), fl, cuts)


# =============================================================================
# Eq. 1
# =============================================================================
def compute_time(w: Workload, op: int, c_dev: float, c_srv: float) -> float:
    """The device + server compute terms of Eq. 1, no network."""
    total = w.layer_flops.sum() * w.train_mult
    dev = w.layer_flops[:op].sum() * w.train_mult
    return dev / c_dev + (total - dev) / c_srv


def iteration_time(w: Workload, op: int, c_dev: float, c_srv: float,
                   net_bps: float, overhead_s: float = 0.0) -> float:
    native = op >= w.num_layers
    comm_bits = 0.0 if native else 2.0 * w.cut_bytes[op] * 8.0   # acts + grads
    t = compute_time(w, op, c_dev, c_srv) + comm_bits / net_bps
    return t + (0.0 if native else overhead_s)


def round_times(w: Workload, ops: Sequence[int],
                devices: Sequence[DeviceProfile], c_srv: float,
                iterations: int = 100, overhead_s: float = 0.0) -> np.ndarray:
    """Per-device round time T_t^k (Eq. 1 x iterations)."""
    return np.asarray([
        iteration_time(w, op, dev.flops_per_s, c_srv, dev.bandwidth_bps,
                       overhead_s) * iterations
        for op, dev in zip(ops, devices)
    ])


# =============================================================================
# calibration against the paper's measured tables
# =============================================================================
def calibrate_linear(w: Workload, ops: Sequence[int],
                     measured_s: Sequence[float], net_bps: float
                     ) -> Tuple[float, float, float]:
    """Least-squares fit of (C_dev, C_srv, overhead) to measured times:
    T(op) = dev_flops(op)/C_dev + srv_flops(op)/C_srv + comm(op)/net + c is
    linear in (1/C_dev, 1/C_srv, c)."""
    rows, rhs = [], []
    total = w.layer_flops.sum() * w.train_mult
    for op, t in zip(ops, measured_s):
        dev = w.layer_flops[:op].sum() * w.train_mult
        srv = total - dev
        native = op >= w.num_layers
        comm = 0.0 if native else 2.0 * w.cut_bytes[op] * 8.0 / net_bps
        rows.append([dev, srv, 0.0 if native else 1.0])
        rhs.append(t - comm)
    sol, *_ = np.linalg.lstsq(np.asarray(rows), np.asarray(rhs), rcond=None)
    inv_cdev, inv_csrv, overhead = sol
    inv_cdev = max(inv_cdev, 1e-15)
    inv_csrv = max(inv_csrv, 1e-15)
    return 1.0 / inv_cdev, 1.0 / inv_csrv, max(overhead, 0.0)


def calibrate_device(w: Workload, ops: Sequence[int],
                     measured_s: Sequence[float], c_srv: float,
                     overhead_s: float, net_bps: float) -> float:
    """Fit only C_dev, holding the server speed + overhead fixed."""
    total = w.layer_flops.sum() * w.train_mult
    num, den = 0.0, 0.0
    for op, t in zip(ops, measured_s):
        dev = w.layer_flops[:op].sum() * w.train_mult
        srv = total - dev
        native = op >= w.num_layers
        comm = 0.0 if native else 2.0 * w.cut_bytes[op] * 8.0 / net_bps
        resid = t - srv / c_srv - comm - (0.0 if native else overhead_s)
        if resid > 1e-9 and dev > 0:
            # least squares on 1/c: minimize sum (dev/c - resid)^2
            num += dev * resid
            den += dev * dev
    inv_c = num / max(den, 1e-30)
    return 1.0 / max(inv_c, 1e-15)


# =============================================================================
# analytic HBM-traffic model (fused-attention semantics)
# =============================================================================
def analytic_step_memory_bytes(cfg: ModelConfig, kind: str, batch: int,
                               seq: int, dp: int, tp: int,
                               act_bytes: int = 2,
                               cache_len: Optional[int] = None) -> float:
    """Per-device HBM bytes per step, assuming fused kernels that keep the
    (Sq, Sk) attention scores and the elementwise chains on chip (as the
    port's flash kernel keeps the scores in shared memory and registers),
    so that only these move:
      * weights: param shard per device (P/tp after the FSDP gather),
        x3 passes for training (fwd, bwd, remat-fwd);
      * activations: block I/O per layer per local token (d-wide residual
        traffic, f/tp-wide MLP intermediates, attention qkvo), x3 for train;
      * logits: chunked CE traffic (2 passes over tokens x vocab/tp);
      * decode: the KV-cache read (sharded dp x tp) dominates.
    ``kind`` is ``"train"``, ``"prefill"`` or ``"decode"``; ``dp`` and
    ``tp`` the data- and model-parallel sizes.  The formula and its
    constants are the reference's (``repro/core/costmodel.py``), which
    aims to be within ~2x, enough to rank bottlenecks; it states no
    measured rate."""
    P_dev = cfg.param_count() * 2.0 / tp          # bf16 shard per device
    toks = batch * seq / dp if kind != "decode" else batch / dp
    n_mlp = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
    f_active = (cfg.d_ff * (cfg.moe.top_k * cfg.moe.capacity_factor
                            if cfg.moe else 1.0))
    if cfg.moe and cfg.moe.dense_residual:
        f_active += cfg.d_ff
    heads_div = cfg.num_heads and cfg.q_dim % tp == 0
    qkv_dim = (cfg.q_dim + 2 * cfg.kv_dim) / (tp if heads_div else 1)
    if cfg.family == "ssm":
        di = cfg.ssm.expand * cfg.d_model
        per_tok_layer = (8 * cfg.d_model + 6 * di / tp
                         + 4 * cfg.ssm.state_dim)
    else:
        per_tok_layer = (10 * cfg.d_model + n_mlp * f_active / tp
                         + 2 * qkv_dim)
    act_io = toks * per_tok_layer * act_bytes * cfg.num_layers
    logit_io = 2.0 * toks * cfg.vocab_size / tp * act_bytes

    if kind == "train":
        total = 3.0 * P_dev + 3.0 * act_io + 2.0 * logit_io
        total += 12.0 * cfg.param_count() / (dp * tp)   # optimizer update
    elif kind == "prefill":
        total = P_dev + act_io + logit_io
    else:  # decode
        CL = cache_len if cache_len is not None else seq
        if cfg.family == "ssm":
            di = cfg.ssm.expand * cfg.d_model
            nheads = di // cfg.ssm.head_dim
            cache = (cfg.num_layers * batch * nheads * cfg.ssm.head_dim
                     * cfg.ssm.state_dim * act_bytes) / (dp * tp)
        else:
            cache = (2.0 * cfg.num_layers * batch * CL * cfg.kv_dim
                     * act_bytes) / (dp * tp)
        total = P_dev + act_io + logit_io + cache
    return float(total)


# =============================================================================
# the simulated fleet of pod slices (the reference's datacenter adaptation)
# =============================================================================
# The reference's TPU v5e figures, kept so that Eq. 1's modelled times come
# out exactly the reference's.  They model the LM training driver's
# simulated cluster of slices (``launch/train.py``); they are not this
# card's rates, and nothing measured on the card is compared with them.
V5E_PEAK_FLOPS = 197e12          # bf16 FLOP/s per chip
V5E_HBM_BPS = 819e9              # bytes/s per chip
V5E_ICI_BPS = 50e9               # bytes/s per link
DCN_BPS = 25e9 / 8               # conservative cross-pod bytes/s (25 Gbit/s)


def slice_profile(name: str, chips: int, mfu: float = 0.4,
                  link_bytes_per_s: float = V5E_ICI_BPS) -> DeviceProfile:
    """A pod slice as a FedAdapt 'device' (the datacenter adaptation)."""
    return DeviceProfile(name, chips * V5E_PEAK_FLOPS * mfu,
                         link_bytes_per_s * 8.0)
