"""The arithmetic of the roofline and utilisation metrics: a call's least
time on the card from its written count, a kernel family's share of the
least time of the model's work, the model's FLOPs of a round and their
share of the peak over the device's busy time."""
from __future__ import annotations

from typing import Dict, Optional

from portbench import feed


def bound_s(w: Dict[str, float], peaks: Dict[str, float]) -> float:
    """The least time of one call: the larger of its products in 3xTF32
    (three TF32 products each, the fewest that hold fp32 accuracy) over
    the TF32 peak, its other operations over the fp32 peak and its bytes
    over the HBM bandwidth."""
    prod = w["matmul_flops"]
    return max(peaks["tf32_products_per_fp32_product"] * prod
               / peaks["tf32_flops_per_s"],
               (w["flops"] - prod) / peaks["fp32_flops_per_s"],
               w["bytes_accessed"] / peaks["hbm_bytes_per_s"])


def kernel_share(reading, kind: str) -> Optional[float]:
    """Percent: the least time of the model's work of kernel family
    ``kind`` in the traced rounds over the device time of the family's
    kernels there.  The model's work is one forward and one backward a
    layer a local step and one forward a layer an eval; the remat
    recompute is the implementation's.  None where the family's
    kernels do not run in this cell or nothing was traced."""
    from portbench import registry
    fam, tr = reading.family, reading.trace
    if tr is None or getattr(fam, "KERNELS", None) != kind:
        return None
    device_s = tr.device_seconds(registry.kernel_names(kind,
                                                       reading.cell.root))
    if device_s <= 0:
        return None
    cfg, traffic = reading.cell.config["port"], reading.cell.traffic
    L, seq = cfg["num_layers"], int(traffic["seq"])
    steps = int(traffic["clients"]) * int(traffic["local_steps"])

    def layer_s(rows, train):
        return sum(bound_s(w, reading.peaks)
                   for _, w in fam.mixer_work(cfg, rows, seq, train))
    least = tr.rounds * L * (
        steps * layer_s(int(traffic["rows_per_step"]), True)
        + layer_s(int(traffic["test_rows"]), False))
    return 100.0 * least / device_s


def round_model_flops(fam, cfg: dict, traffic: dict) -> float:
    """The model's FLOPs of one round: 6 a matmul parameter a trained
    token and the mixer's products forward and backward, then 2 a matmul
    parameter a test token and the mixer's forward products."""
    seq, L = int(traffic["seq"]), cfg["num_layers"]
    rows, test = int(traffic["rows_per_step"]), int(traffic["test_rows"])
    n = fam.matmul_params(cfg)

    def mixer(r, train):
        return L * sum(w["matmul_flops"]
                       for _, w in fam.mixer_work(cfg, r, seq, train))
    steps = int(traffic["clients"]) * int(traffic["local_steps"])
    return steps * (6 * n * rows * seq + mixer(rows, True)) \
        + 2 * n * test * seq + mixer(test, False)


def step_mfu(reading) -> Optional[float]:
    """Percent of the card's fp32-equivalent peak (the TF32 peak over
    the three products 3xTF32 takes) that the model FLOPs of the traced
    rounds reach over the device's busy time there: the whole step's
    utilisation of the device while it works, its idle share apart.
    None where nothing was traced or nothing ran on the device."""
    tr = reading.trace
    if tr is None or tr.busy_s <= 0:
        return None
    p = reading.peaks
    peak = p["tf32_flops_per_s"] / p["tf32_products_per_fp32_product"]
    flops = tr.rounds * round_model_flops(
        reading.family, reading.cell.config["port"], reading.cell.traffic)
    return 100.0 * flops / (tr.busy_s * peak)


def tokens_per_s(reading) -> float:
    return reading.rounds * feed.tokens_per_round(reading.cell.traffic) \
        / reading.window_s
