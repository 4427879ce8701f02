"""The port's kernels: hand-written CUDA for ``sm_90a`` (``csrc/``), each
beside its plain PyTorch version in the same module.

Dispatch follows the tensor: a CUDA tensor launches the kernel (or raises),
a CPU tensor takes the plain version.  There is no fallback and no switch.
``LAUNCHES`` counts kernel launches, one per launch and nowhere else, so a
run can show that its main path went through the kernels."""
from typing import Dict

LAUNCHES: Dict[str, int] = {"quantize": 0, "dequantize": 0,
                            "topk_compress": 0, "flash_attention": 0,
                            "flash_attention_bwd_dq": 0,
                            "flash_attention_bwd_dkdv": 0, "ssd_scan": 0,
                            "ssd_scan_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
