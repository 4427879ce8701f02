"""Ablations of the flash-attention kernel on the card: where its time goes.

    python3 scripts/flash_ablation.py      # from the repository root, one GPU

A development script, outside the port's package: nothing the port runs
calls it.  Each variant is ``src/repro_torch/kernels/csrc/flash_attention.cu``
with one textual change, built by ``scripts/variants.py`` and
timed by ``chip_smoke.time_ms`` (CUDA events over CUDA-graph replays) at
gemma2-2b's prefill shape (S = 4608, H = 8, KV = 4, D = 256, causal; global
softcap 50, local window 4096 softcap 50, global softcap 0) on seeded
inputs, in turns, beside ``scaled_dot_product_attention``.  A variant that
changes the arithmetic prints its error against ``attention_plain``: it is
a measurement of the kernel's parts, never a kernel the port calls.

- ``kernel``: the source as it is.
- ``cvt.rna``: hi and lo rounded by the ``cvt.rna.tf32.f32`` instruction
  instead of the kernel's two integer operations (the same values).
- ``1xTF32``: only the hi.hi products (a third of the mma instructions,
  the split unchanged): ~1e-3 off.
- ``no split``: the three products on the raw fp32 bits, without the
  rounding work (the mma instructions unchanged): wrong results.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from chip_smoke import time_ms  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as tf  # noqa: E402
from variants import build_variants  # noqa: E402

_TO_TF32 = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
_SPLIT = ("  hi = to_tf32(x);\n"
          "  lo = to_tf32(x - __uint_as_float(hi));")
_LO_MMAS = ("        mma_tf32(sl[jj], a[0].lo, b0.hi);\n"
            "        mma_tf32(sl[jj], a[1].lo, b1.hi);\n"
            "        mma_tf32(sl[jj], a[0].hi, b0.lo);\n"
            "        mma_tf32(sl[jj], a[1].hi, b1.lo);\n",
            "              mma_tf32(tacc[i][c + w], a[i].lo, bf[w].hi);",
            "              mma_tf32(tacc[i][c + w], a[i].hi, bf[w].lo);")
VARIANTS = {
    "kernel": [],
    "cvt.rna": [(_TO_TF32, '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" '
                           ': "=r"(r) : "f"(x));\n  return r;')],
    "1xTF32": [(_LO_MMAS[0], ""), (_LO_MMAS[1], "{}"), (_LO_MMAS[2], "{}")],
    "no split": [(_SPLIT, "  hi = __float_as_uint(x);\n"
                          "  lo = __float_as_uint(x) ^ 1u;")],
}
SHAPES = [(0, 50.0), (4096, 50.0), (0, 0.0)]   # (window, softcap)


def _call(lib, q, k, v, window, cap):
    out = torch.empty_like(q)
    B, S, H, D = q.shape
    _build.check_launch(lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
        k.shape[1], H, k.shape[2], D, 1, window, float(cap),
        tf._DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream),
        "flash_ablation")
    return out


def main(rounds: int = 2) -> None:
    if not torch.cuda.is_available():
        sys.exit("flash_ablation: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    libs = build_variants("flash_attention", VARIANTS, tf._SIGNATURES)
    gen = torch.Generator().manual_seed(0)
    S, H, KV, D = 4608, 8, 4, 256
    q, k, v = (torch.randn(shape, generator=gen).cuda()
               for shape in ((1, S, H, D), (1, S, KV, D), (1, S, KV, D)))
    wants = {wc: tf.attention_plain(q, k, v, True, *wc) for wc in SHAPES}
    for _ in range(rounds):
        for name, lib in libs.items():
            parts = []
            for (window, cap), want in wants.items():
                err = float((_call(lib, q, k, v, window, cap) - want)
                            .abs().max())
                ms = time_ms(lambda: _call(lib, q, k, v, window, cap),
                             reps=5, inner=5)
                parts.append(f"window {window} softcap {cap}: {ms:.4f} ms "
                             f"(max abs err {err:.3g})")
            print(f"{name:8s} | " + " | ".join(parts), flush=True)
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(H // KV, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(H // KV, dim=1)
    sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True), reps=5, inner=5)
    print(f"scaled_dot_product_attention, softcap 0: {sdpa:.4f} ms")


if __name__ == "__main__":
    main()
