"""Eq. 1 cost model (the VGG half of ``repro/core/costmodel.py``, numpy).

    T_t^k = mu * W / C_dev  +  (1 - mu) * W / C_srv  +  L(mu) / Net      (Eq. 1)

A ``Workload`` is the paper's (W, L(mu)) pair materialized per layer:
forward FLOPs per layer and the activation bytes crossing each candidate cut
(Offloading Point).  ``calibrate_linear`` / ``calibrate_device`` fit the
device and server speeds to the paper's measured per-OP tables
(``core/testbed.py``).  The LM FLOP helpers wait for the LM families.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

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

    def device_fraction(self, op: int) -> float:
        """mu: fraction of compute kept on the device for cut at ``op``."""
        return float(self.layer_flops[:op].sum() / self.layer_flops.sum())


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
