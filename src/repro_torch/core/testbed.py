"""The paper's 5-device testbed (§V-A), reconstructed from its own
measurements.

The physical testbed is 1 Jetson Xavier + 2 Raspberry Pi 4 + 2 Raspberry
Pi 3 against a desktop edge server, on a 75 Mbps link throttled with ``tc``.
This module rebuilds it as Eq. 1 device/server speeds (``C_dev``/``C_srv``
in FLOP/s, plus a constant per-iteration overhead in seconds) fitted to the
paper's own tables:

* ``TABLE_V`` / ``TABLE_VI`` — VGG-5 / VGG-8 single-device round times in
  **seconds** per OP (columns OP1..OP4), keyed by bandwidth in **bits/s**
  (the paper's 75/50/25/10 Mbps rows);
* ``TABLE_VIII`` — per-device VGG-5 round times in seconds at 75 Mbps
  (`pi4_15`/`pi4_07` are the paper's 1.5 GHz and throttled 0.7 GHz Pi 4s);
* ``TABLE_VII_TIMES`` — the §V-B deployment's measured per-device times.

Calibration: (C_srv, overhead) are fitted once from Table V (VGG-5 per-OP
times at 75 Mbps — the single-device study against the edge server); each
device's C_dev is then fitted from its Table VIII row *holding the server
fixed* (all rows share that server).  Everything else — other bandwidths,
VGG-8, the 5-device deployment — is out-of-sample prediction, validated
against Tables V-IX in benchmarks/paper_validation.py.

A numpy copy of ``repro/core/testbed.py``, so the port's results are
identical; the tests, benchmarks and modules named above are the JAX
package's.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.configs.vgg import VGG5, VGG8, VGGConfig
from repro_torch.core import costmodel as cm

TABLE_V = {
    75e6: [2.38, 3.61, 5.24, 4.36],
    50e6: [2.70, 3.90, 5.26, 4.36],
    25e6: [3.52, 4.36, 5.42, 4.36],
    10e6: [6.07, 5.31, 6.73, 4.36],
}
TABLE_VI = {
    75e6: [4.75, 7.52, 10.74, 10.61],
    50e6: [5.29, 8.37, 11.98, 10.61],
    25e6: [6.08, 8.32, 12.00, 10.61],
    10e6: [8.84, 9.95, 15.93, 10.61],
}
TABLE_VIII = {
    "jetson": [0.51, 0.28, 0.27, 0.17],
    "pi4_15": [2.38, 3.61, 5.24, 4.36],
    "pi3":    [2.99, 3.97, 4.93, 4.47],
    "pi4_07": [2.63, 4.68, 5.88, 5.15],
}
TABLE_VII_TIMES = {"jetson": 0.07, "pi4_1": 3.58, "pi3_1": 3.75,
                   "pi3_2": 3.77, "pi4_2": 5.14}


def server_calibration(cfg: VGGConfig = VGG5) -> Tuple[float, float]:
    """(C_srv, overhead) from the Table V/VI 75 Mbps column."""
    w = cm.vgg_workload(cfg, batch_size=100)
    table = TABLE_V if cfg.name == "vgg5" else TABLE_VI
    _, c_srv, ovh = cm.calibrate_linear(w, cfg.ops, table[75e6], 75e6)
    return c_srv, ovh


def paper_testbed(cfg: VGGConfig = VGG5
                  ) -> Tuple[cm.Workload, List[cm.DeviceProfile], float, float]:
    """(workload, devices, c_srv, overhead) — the §V-B five-device setup."""
    w = cm.vgg_workload(cfg, batch_size=100)
    w5 = cm.vgg_workload(VGG5, batch_size=100)
    c_srv, ovh = server_calibration(VGG5)
    speeds: Dict[str, float] = {
        name: cm.calibrate_device(w5, VGG5.ops, meas, c_srv, ovh, 75e6)
        for name, meas in TABLE_VIII.items()
    }
    devices = [
        cm.DeviceProfile("jetson", speeds["jetson"], 75e6),
        cm.DeviceProfile("pi4_1", speeds["pi4_15"], 75e6),
        cm.DeviceProfile("pi3_1", speeds["pi3"], 75e6),
        cm.DeviceProfile("pi3_2", speeds["pi3"], 75e6),
        cm.DeviceProfile("pi4_2", speeds["pi4_07"], 75e6),
    ]
    return w, devices, c_srv, ovh
