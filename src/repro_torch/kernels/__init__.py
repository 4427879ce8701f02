"""The port's kernels: hand-written CUDA for ``sm_90a`` (``csrc/``), each
beside its plain PyTorch version in the same module.

Dispatch follows the tensor: a CUDA tensor launches the kernel (or raises),
a CPU tensor takes the plain version.  There is no fallback and no switch.
``LAUNCHES`` counts kernel launches, one per launch and nowhere else, so a
run can show that its main path went through the kernels.

Under ``torch.func.vmap`` (the batched fleet engine's clients) a kernel
never sees a batched tensor, which has no data pointer: each Function that
launches one has a ``vmap`` rule that calls the Function again on plain
tensors, the vmapped axis folded into the kernel's own batch axis (flash
attention) or one call per vmapped example (the SSD scan).

Each kernel has one written count of its work (``*_work``: FLOPs, the
products' share of them, bytes, transcendentals, from its operands'
shapes), recorded through ``counted`` where its wrapper launches it or
takes the plain version, so a step analysis (``launch.hlo_analysis``)
reads the same on ``meta``, on the CPU and on the card."""
from typing import Callable, Dict, Sequence

from repro_torch.parallel.sharding import active_analysis

LAUNCHES: Dict[str, int] = {"quantize": 0, "dequantize": 0,
                            "topk_compress": 0, "flash_attention": 0,
                            "flash_attention_bwd_dq": 0,
                            "flash_attention_bwd_dkdv": 0, "ssd_scan": 0,
                            "ssd_scan_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def counted(name: str, work: Callable, inputs: Sequence, run: Callable):
    """``run()``, the kernel ``name``'s launch or its plain version.  Under
    an active step analysis the call counts as ``work(*shapes)`` (the
    kernel's written count at its operands' local shapes, None for a
    missing operand), in place of the aten ops ``run`` dispatches."""
    an = active_analysis()
    return run() if an is None else an.kernel(name, work, inputs, run)


def work(flops: float, matmul_flops: float, nbytes: float,
         transcendentals: float) -> Dict[str, float]:
    """A written count: ``flops`` all of them, ``matmul_flops`` the
    products' share."""
    return {"flops": float(flops), "matmul_flops": float(matmul_flops),
            "bytes_accessed": float(nbytes),
            "transcendentals": float(transcendentals)}
