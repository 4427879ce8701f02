"""Ablations of the flash-attention backward kernels on the card: where
their time goes.

    python3 scripts/flash_bwd_ablation.py      # from the repository root
    python3 scripts/flash_bwd_ablation.py --source OTHER.cu --tag parent

A development script, outside the port's package: nothing the port runs
calls it.  Each variant is ``src/repro_torch/kernels/csrc/flash_attention.cu``
with textual changes, built by ``scripts/variants.py`` and timed by
``chip_smoke.time_ms`` (CUDA events over CUDA-graph replays) at
qwen3-0.6b's layer shape (S = 4096, H = 16, KV = 8, D = 128, causal) on
seeded inputs, in turns, beside the backward of
``scaled_dot_product_attention`` (k and v repeated to H heads).  Each
variant prints the dq kernel's, the dk/dv kernel's and the pair's times
and the pair's max abs error against ``attention_bwd_plain``: a variant
that changes the arithmetic is a measurement of the kernels' parts, never
a kernel the port calls.  ``--source`` adds another tree's
``flash_attention.cu`` (same C interface) as one more variant.

- ``kernel``: the source as it is.
- ``1xTF32``: only the hi.hi products (a third of the mma instructions,
  every split unchanged): the cost of the two extra products; ~1e-3 off.
- ``no overlap``: each kernel waits for the next streamed tile's copies
  right after it issues them, before the current tile's products: what
  the cp.async double buffering buys.
- ``no split``: every split replaced by the raw bits (hi = x, lo = x
  with its last bit flipped), the mma instructions unchanged: the cost of
  the splits (nearly all of it where the streamed and score operands are
  read; the resident planes are split once); wrong results.
- ``2x1 tiles``: score warp tiles of 32 resident x 8 streamed rows instead
  of 16 x 16 (half the streamed operand's splits, twice the resident
  planes' shared-memory reads).
- ``no exp``: ``expf(x - lse)`` replaced by ``x - lse``: what the accurate
  exponential still costs; wrong results.
- ``copies by all warps``: every thread issues the streamed tiles'
  ``cp.async`` copies, not half of them (``kCopyThreads``).
- ``no copies``: the streamed tiles are never copied after the first
  (the kernels compute on stale tiles): what issuing the copies costs
  beside their latency; wrong results.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from chip_smoke import time_ms  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as tf  # noqa: E402
from variants import build_sources, build_variants  # noqa: E402

_SMALL_SCORES = ("        mma_tf32(sl[i][j], l1, b1[j].hi);\n"
                 "        mma_tf32(pl[i][j], l2, b2[j].hi);\n"
                 "        mma_tf32(sl[i][j], h1, b1[j].lo);\n"
                 "        mma_tf32(pl[i][j], h2, b2[j].lo);\n")
_SMALL_GRAD = ("mma_tf32(tacc[i][c + w], a[i].lo, b[w].hi);",
               "mma_tf32(tacc[i][c + w], a[i].hi, b[w].lo);")
_DQ_NEXT = "    if (t + 1 < t_end) load(t + 1, buf ^ 1);\n"
_DKDV_NEXT = "    if (it + 1 < items) load_item(it + 1, buf ^ 1);\n"
_TILES = "static constexpr int SMT = 1, SNT = DP == 256 ? 1 : 2;"
# every split goes through split(): the resident planes', and the
# streamed and score operands' where they are read
_SPLIT = ("  hi = to_tf32(x);\n"
          "  lo = to_tf32(x - __uint_as_float(hi));")
VARIANTS = {
    "kernel": [],
    "1xTF32": [(_SMALL_SCORES, ""), (_SMALL_GRAD[0], "{}"),
               (_SMALL_GRAD[1], "{}")],
    "no overlap": [(_DQ_NEXT, "    if (t + 1 < t_end) {\n"
                              "      load(t + 1, buf ^ 1);\n"
                              "      cp_async_wait_all();\n"
                              "    }\n"),
                   (_DKDV_NEXT, "    if (it + 1 < items) {\n"
                                "      load_item(it + 1, buf ^ 1);\n"
                                "      cp_async_wait_all();\n"
                                "    }\n")],
    "no split": [(_SPLIT, "  hi = __float_as_uint(x);\n"
                          "  lo = __float_as_uint(x) ^ 1u;")],
    "2x1 tiles": [(_TILES, "static constexpr int SMT = DP == 256 ? 1 : 2, "
                           "SNT = 1;")],
    "no exp": [("const float e = expf(x - l);", "const float e = x - l;")],
    "copies by all warps": [("constexpr int kCopyThreads = kThreads / 2;",
                             "constexpr int kCopyThreads = kThreads;")],
    "no copies": [(_DQ_NEXT, ""), (_DKDV_NEXT, "")],
}
SHAPE = (1, 4096, 16, 8, 128)   # B, S, H, KV, D: qwen3-0.6b's layer


def _pair(lib, q, k, v, o, lse, do):
    """dq, dk, dv from one library's two kernels; returns the outputs and
    the two launch closures (for timing each kernel alone)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    dq, delta = torch.empty_like(q), torch.empty_like(lse)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    shape = (B, S, S, H, KV, D, 1, 0, 0.0)

    # the stream is read at each call: a CUDA graph captures on its own
    def run_dq():
        _build.check_launch(lib.repro_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), delta.data_ptr(),
            *shape, torch.cuda.current_stream().cuda_stream),
            "flash_bwd_ablation dq")

    def run_dkdv():
        _build.check_launch(lib.repro_flash_attention_bwd_dkdv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), do.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *shape, torch.cuda.current_stream().cuda_stream),
            "flash_bwd_ablation dkdv")

    run_dq()
    run_dkdv()
    return (dq, dk, dv), run_dq, run_dkdv


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", type=Path, default=None,
                    help="another flash_attention.cu to time beside")
    ap.add_argument("--tag", default="other")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("flash_bwd_ablation: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    libs = build_variants("flash_attention", VARIANTS, tf._SIGNATURES)
    if args.source is not None:
        libs.update(build_sources({args.tag: (args.source.resolve(),
                                              tf._SIGNATURES)}))
    gen = torch.Generator().manual_seed(0)
    B, S, H, KV, D = SHAPE
    q, do = (torch.randn((B, S, H, D), generator=gen).cuda()
             for _ in range(2))
    k, v = (torch.randn((B, S, KV, D), generator=gen).cuda()
            for _ in range(2))
    o, lse = tf.flash_attention_lse(q, k, v, True)
    want = tf.attention_bwd_plain(q, k, v, o, lse, do, True)
    kw = dict(reps=5, inner=3)
    for _ in range(args.rounds):
        for name, lib in libs.items():
            got, run_dq, run_dkdv = _pair(lib, q, k, v, o, lse, do)
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            t_dq, t_dkdv = time_ms(run_dq, **kw), time_ms(run_dkdv, **kw)
            t_pair = time_ms(lambda: (run_dq(), run_dkdv()), **kw)
            print(f"{name:10s} | dq {t_dq:.4f} ms | dk/dv {t_dkdv:.4f} ms | "
                  f"pair {t_pair:.4f} ms | max abs err {err:.3g}",
                  flush=True)
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd():
        return torch.nn.functional.scaled_dot_product_attention(
            qq.transpose(1, 2),
            kk.transpose(1, 2).repeat_interleave(H // KV, dim=1),
            vv.transpose(1, 2).repeat_interleave(H // KV, dim=1),
            is_causal=True)

    def grads():
        return torch.autograd.grad(fwd().transpose(1, 2), (qq, kk, vv), do)

    sdpa = (time_ms(grads, graph=False, **kw)
            - time_ms(fwd, graph=False, **kw))
    print(f"scaled_dot_product_attention backward (forward and backward "
          f"less the forward): {sdpa:.4f} ms")


if __name__ == "__main__":
    main()
