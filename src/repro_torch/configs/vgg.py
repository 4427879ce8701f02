"""The paper's own models: VGG-5 and VGG-8 (Table IV) with the 4 OPs.

VGG-5: C32-MP(OP1)-C64-MP(OP2)-C64(OP3)-FC128-FC10(OP4)
VGG-8: C32-C32-MP(OP1)-C64-C64-MP(OP2)-C128-C128(OP3)-FC128-FC10(OP4)

All convolutions are 3x3; batch-norm + ReLU after each conv (not shown in the
paper table).  CIFAR-10 inputs (32x32x3).  ``ops`` marks the layer indices
that are Offloading Points; OP4 == device-native execution (classic FL).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class VGGConfig:
    name: str
    # Layer spec strings: "C<filters>" conv3x3+BN+ReLU, "MP" maxpool2x2,
    # "FC<units>" fully connected.
    layers: Tuple[str, ...]
    # Offloading points as "number of layers kept on the device": OP value v
    # means the device runs layers [0, v) and the cut is after layer v-1.
    ops: Tuple[int, ...]
    # The paper's own per-OP device FLOPs fractions (§V-B gives VGG-5's as
    # 0.1/0.66/0.94/1.0 from their profiler); None -> analytic fractions.
    paper_fractions: Tuple[float, ...] = ()
    input_hw: int = 32
    input_ch: int = 3
    num_classes: int = 10


VGG5 = VGGConfig(
    name="vgg5",
    layers=("C32", "MP", "C64", "MP", "C64", "FC128", "FC10"),
    #         0     1      2     3     4       5        6
    # OP1 cut after MP@1, OP2 after MP@3, OP3 after C64@4, OP4 = native
    ops=(2, 4, 5, 7),
    paper_fractions=(0.1, 0.66, 0.94, 1.0),
)

VGG8 = VGGConfig(
    name="vgg8",
    layers=("C32", "C32", "MP", "C64", "C64", "MP", "C128", "C128", "FC128", "FC10"),
    #          0      1     2     3      4     5      6       7       8        9
    # OP1 cut after MP@2, OP2 after MP@5, OP3 after C128@7, OP4 = native
    ops=(3, 6, 8, 10),
)
