#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card

Phases, in order; any failure exits non-zero and prints no result line:

1. print the card's name and power limit (``nvidia-smi``); no GPU -> exit 1.
2. build the CUDA kernels (``src/repro_torch/kernels/csrc``, one ``nvcc``
   per source for sm_90a, all at once) and print the build time.
3. hold every kernel against its plain PyTorch version on the card.  The
   int8 and top-k kernels at the VGG-5 path's shapes plus the tie and
   masked-tail drills, bit for bit; flash attention over the reference's
   sweep (``FLASH_CASES`` of tests/test_kernels.py) plus small head dims,
   within 1e-5 (fp32) and 2e-2 (bf16), the reference's own tolerances.
4. the federated main path: ``run_federated`` on VGG-5 at full width
   (582,346 params, random weights from a seed), K=5 clients on the
   paper's 5-device testbed, 1000 samples each, batch 100, 10 local
   iterations, 3 rounds; once in ``sfl`` at OP1 with the int8 cut, top-k
   deltas at density 0.1 and int8 deltas, once in ``fedadapt`` (the agent
   deployed, no exploration).  The kernels' launch counts are zeroed just
   before each of the two runs and read just after it; each kernel must
   have launched in each run, as often as the run's history (its OPs and
   kept clients) says, and flash attention never.  Then one more sfl-op1
   round under ``torch.profiler`` gives the card's busy share (the round
   must succeed; a profiler without device time gives "not measured").
5. the serving main path: ``ServeEngine`` on gemma2-2b at full width
   (26 layers, d_model 2304, 8 query heads over 4 KV heads of dim 256,
   vocab 256000; fp32 weights drawn on the card from a seed).  First the
   flash kernel is held against its plain version on q, k, v of the first
   local and the first global layer of a real prefill at S=4608.  Then
   ``serve`` takes 8 seeded Poisson requests (prompts of 600, 2100 or
   4500 tokens, 8-32 generated) through 4 slots, prefilled at 4608, and
   each request's tokens must equal the sequential oracle's
   (``reference_decode``, on the card) up to the first token chosen under
   a top-2 logit margin below 1e-3.  Launch counts are zeroed just before
   the run and read after the oracle: flash attention must have launched
   26 times per prefill (engine and oracle), the other kernels never.  One
   more prefill at 4608 and one decode step run under ``torch.profiler``.
6. the small configurations on the CPU and on the card from the same
   weights: the VGG-5 runs of ``tests/test_torch_loop.py`` (ops and times
   exact, accuracy within one test sample, final params within the tests'
   tolerances) and gemma2-2b's smoke config through ``serve`` (tokens
   equal, logits within 1e-4).
7. time each kernel with CUDA events (median of CUDA-graph replays) beside
   its bound, its plain version and a library call computing the same
   function where PyTorch has one (``torch.mul`` for dequantize,
   ``torch.topk`` for top-k, ``scaled_dot_product_attention`` for flash
   attention without the softcap: yardsticks the port never calls), then
   print the kernels' JSON line and the result line.

TF32 is switched off for convolutions and matrix products throughout, so
every comparison is in full fp32.  The full record goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))

# NVIDIA H100 SXM data sheet: HBM3 rate and fp32 rate outside the tensor
# cores (the kernels do fp32 arithmetic and comparisons)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

SMALL = dict(rounds=2, local_iters=2, batch_size=10, augment=True, seed=0)
SMALL_MODES = {
    "fl": (dict(mode="fl"), 1e-4),
    "sfl-op2-int8": (dict(mode="sfl", static_op=2, quantize_transfer=True),
                     1e-3),
    "fedadapt-topk-int8": (dict(mode="fedadapt", delta_density=0.5,
                                quantize_deltas=True), 1e-3),
}
# final-params atol, CPU vs card.  fl: 1e-4, looser than the CPU tests'
# 1e-5 against JAX because cuDNN may pick a Winograd or FFT convolution whose
# fp32 rounding error is larger than a direct sum's.  int8/top-k modes: 1e-3,
# the tests' bound for an int8 code or a top-k near-tie going the other way.

VGG_KERNELS = ("quantize", "dequantize", "topk_compress")
# the reference's flash-attention sweep (tests/test_kernels.py FLASH_CASES,
# copied: this script imports nothing of JAX) plus the smoke head dims of
# gemma2/qwen3 (16) and lm16m (40) and a row range that sees no key:
# B, Sq, Sk, H, KV, D, causal, window, softcap, dtype
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0, 0.0, "float32"),
    (1, 256, 256, 8, 8, 64, True, 64, 0.0, "float32"),
    (2, 100, 100, 8, 2, 32, True, 0, 50.0, "float32"),
    (1, 128, 384, 4, 1, 64, False, 0, 0.0, "float32"),
    (1, 64, 64, 2, 2, 128, True, 32, 30.0, "float32"),
    (2, 128, 128, 4, 4, 64, True, 0, 0.0, "bfloat16"),
    (2, 70, 70, 4, 2, 16, True, 32, 50.0, "float32"),
    (1, 77, 77, 8, 4, 40, True, 0, 0.0, "float32"),
    (1, 200, 72, 4, 2, 64, True, 16, 0.0, "float32"),
]
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# gemma2-2b's real-layer drill.  1e-5 as in the sweep: the kernel and the
# plain version both sum in fp32 (over D=256 and up to 4608 keys), the
# layers' v are O(1) (unit-variance h times N(0, 1/d) weights) and the
# output is a convex mix of them, so fp32 reordering moves it by a few
# 1e-6 (PERF.md records the measured errors).
REAL_LAYER_TOL = 1e-5

SERVE_SLOTS, SERVE_PROMPT, SERVE_SEQ = 4, 4608, 4640
SERVE_TRAFFIC = dict(rate=0.5, n_requests=8, vocab_size=256000,
                     prompt_lens=(600, 2100, 4500), gen_lens=(8, 16, 32),
                     seed=0)
MARGIN = 1e-3   # oracle top-2 logit gap under which a token may flip
# gemma2 smoke served on the CPU and on the card: logits within 1e-4 (fp32
# matmuls on either device and the kernel vs the plain attention move them
# by ~1e-6 at this size)
SMALL_SERVE_ATOL = 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str):
    print(f"\n== {name}", flush=True)


def time_ms(fn, graph: bool = True, reps: int = 15, inner: int = 20):
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, from CUDA events.  With ``graph`` the calls are captured once in
    a CUDA graph and replayed, so the time is the device's alone (a call
    that cannot be captured fails the run); with ``graph=False``, eager
    calls also pay the host's launch overhead, which is what the main path
    pays.  The inputs stay in L2: the main path calls these kernels on data
    it has just written."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(inner):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(inner):
                fn()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / inner)
    return statistics.median(samples)


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(torch, tq, tt, dev):
    """Phase 3: each kernel equals its plain version bit for bit."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    worst = {"quantize": 0.0, "dequantize": 0.0, "topk_compress": 0.0}

    def same(a, b, what):
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"{what}: {a.dtype}{tuple(a.shape)} vs "
                 f"{b.dtype}{tuple(b.shape)}")
        if a.dtype == torch.float32:
            equal = torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            equal = torch.equal(a, b)
        if not equal:
            fail(f"{what}: kernel differs from its plain version")
        if a.numel() == 0:
            return 0.0
        return float((a.double() - b.double()).abs().max())

    # quantize / dequantize: the VGG-5 cut at B=100 and the delta wire
    for R, C in [(25600, 32), (6400, 64), (580, 1024), (300, 32)]:
        x = (torch.randn((R, C), generator=gen) * 3.0)
        for i, scale in enumerate((1.0, 2.0, 3.0)):   # exact .5 ties
            x[i] = (torch.arange(C) % 9 - 4.5) * scale
            x[i, 0] = 127.0 * scale
        x[3] = 0.0                                     # all-zero row
        x = x.to(dev)
        q, s = tq.quantize_rows(x)
        qp, sp = tq.quantize_rows_plain(x)
        worst["quantize"] = max(worst["quantize"],
                                same(q, qp, f"quantize codes ({R}, {C})"),
                                same(s, sp, f"quantize scales ({R}, {C})"))
        worst["dequantize"] = max(worst["dequantize"], same(
            tq.dequantize_rows(q, s), tq.dequantize_rows_plain(q, s),
            f"dequantize ({R}, {C})"))
        print(f"quantize/dequantize ({R}, {C}): equal")

    # top-k: one VGG-5 client row at density 0.1, three rows at once, and
    # the drills (ties, masked tail, density from the true size, density 1)
    from repro_torch.configs.vgg import VGG5
    from repro_torch.fl.flatbuf import FlatLayout
    from repro_torch.models.vgg import init
    layout = FlatLayout(init(VGG5, gen))
    cases = []
    for rows, density in [(1, 0.1), (3, 0.1), (1, 0.5), (1, 1.0)]:
        cases.append((f"VGG-5 layout x{rows} at density {density}",
                      torch.randn((rows, layout.padded), generator=gen),
                      torch.from_numpy(layout.block_meta(density)), 1024))
    ties = torch.tensor([5.0, -3.0, 3.0, 3.0, -5.0, 1.0, 0.5, 0.25] * 16)
    cases.append(("ties", ties[None], torch.tensor([[128, 3]]), 128))
    heavy = torch.randint(-3, 4, (1, 4096), generator=gen).float()
    heavy[heavy == 0] = 1.0
    cases.append(("heavy ties", heavy, torch.tensor(
        [[512, k] for k in (1, 7, 100, 300, 511, 512, 64, 2)]), 512))
    tail = torch.randn((1, 2048), generator=gen)
    tail[:, 1500:] = 100.0
    cases.append(("masked tail", tail,
                  torch.from_numpy(tt.density_block_meta(1500, 1024, 0.02)),
                  1024))
    small = torch.zeros((1, 1024))
    small[0, :100] = torch.randn(100, generator=gen)
    cases.append(("density from true size", small,
                  torch.from_numpy(tt.density_block_meta(100, 1024, 0.05)),
                  1024))
    for name, buf, meta, block in cases:
        buf, meta = buf.to(dev), meta.to(torch.int32).to(dev)
        out = tt.topk_compress_flat(buf, meta, block)
        ref = tt.topk_blocks_plain(buf.view(-1, block),
                                   meta.repeat(buf.shape[0], 1)).view_as(buf)
        worst["topk_compress"] = max(worst["topk_compress"],
                                     same(out, ref, f"topk {name}"))
        kept = (out.view(-1, block) != 0).sum(1)
        if not torch.equal(kept, meta[:, 1].repeat(buf.shape[0]).long()):
            fail(f"topk {name}: survivors per block != k")
        print(f"topk_compress {name}: equal")
    return worst


def expected_launches(h, fl, native_op):
    """Each kernel's launches in one ``run_federated`` run without failures
    or deadline, from its history: a fake-quantized cut (one quantize, one
    dequantize) per local iteration of a client below the native OP, and
    per client row of the server step one top-k (density < 1) and one int8
    round trip."""
    assert fl.fail_prob == 0 and fl.deadline_factor == 0, \
        "every client trains and is kept"
    cut = fl.local_iters * int(sum(op < native_op for row in h["ops"]
                                   for op in row)) \
        if fl.quantize_transfer else 0
    rows = len(h["ops"]) * len(h["ops"][0])
    quant = cut + (rows if fl.quantize_deltas else 0)
    return {"quantize": quant, "dequantize": quant,
            "topk_compress": rows if fl.delta_density < 1 else 0,
            "flash_attention": 0}


def vgg5_main_path(torch, dev, launches, reset_launches):
    """Phase 4: the port's entry point at full width on the paper testbed.
    Each path's launch counts are zeroed just before its run and read just
    after; every VGG-path kernel must have launched exactly as often as
    the run's history says it should, flash attention never.  Then one
    more sfl-op1 round, from the same set-up, runs under
    ``torch.profiler``."""
    from repro_torch.configs.vgg import VGG5
    from repro_torch.core.controller import FedAdaptController
    from repro_torch.core.env import SimulatedCluster
    from repro_torch.core.testbed import paper_testbed
    from repro_torch.data import make_cifar_like, split_clients
    from repro_torch.fl.comm import Transport, device_bandwidths
    from repro_torch.fl.loop import FLConfig, run_federated
    from repro_torch.models.split_program import get_split_program

    clients = split_clients(make_cifar_like(5000, seed=1), 5)
    test = make_cifar_like(1000, seed=2)
    w, devices, c_srv, ovh = paper_testbed(VGG5)
    native_op = get_split_program(VGG5).native_op
    paths = {"sfl-op1": dict(mode="sfl", static_op=VGG5.ops[0]),
             "fedadapt": dict(mode="fedadapt")}

    def run(name, rounds):
        fl = FLConfig(rounds=rounds, local_iters=10, batch_size=100, seed=0,
                      quantize_transfer=True, delta_density=0.1,
                      quantize_deltas=True, **paths[name])
        sim = SimulatedCluster(w, devices, c_srv, VGG5.ops,
                               iterations=fl.local_iters, overhead_s=ovh)
        ctl = (FedAdaptController(w, VGG5.ops, num_groups=3, seed=0)
               if fl.mode == "fedadapt" else None)
        h = run_federated(VGG5, clients, test, fl, sim=sim, controller=ctl,
                          transport=Transport(device_bandwidths(devices)))
        torch.cuda.synchronize()
        return h, fl

    runs = {}
    for name in paths:
        reset_launches()
        t0 = time.perf_counter()
        h, fl = run(name, rounds=3)
        total = time.perf_counter() - t0
        counts = dict(launches)
        want = expected_launches(h, fl, native_op)
        print(f"{name}: launches {counts} (expected from its history "
              f"{want})")
        for kernel, n in counts.items():
            if n != want[kernel] or (kernel in VGG_KERNELS and n <= 0):
                fail(f"{name}: kernel {kernel} launched {n} times, its "
                     f"history needs {want[kernel]}")
        flat = torch.cat([v.reshape(-1) for layer in h["params"]
                          for v in layer.values()])
        if flat.numel() != 582_346 or not bool(torch.isfinite(flat).all()):
            fail(f"{name}: params not finite or not VGG-5's 582,346")
        acc = h["accuracy"]
        if len(acc) != 3 or not all(0.0 <= a <= 1.0 for a in acc):
            fail(f"{name}: accuracy history {acc}")
        ops = h["ops"].tolist()
        if any(op not in VGG5.ops for row in ops for op in row):
            fail(f"{name}: OPs {ops} outside {VGG5.ops}")
        runs[name] = {"wall_s": [float(t) for t in h["wall_s"]],
                      "total_s": total,
                      "accuracy": [float(a) for a in acc],
                      "round_time_model_s": h["round_time"].tolist(),
                      "comm_time_model_s": h["comm_time"].tolist(),
                      "ops": ops, "launches": counts}
        print(f"{name}: wall per round (s) "
              f"{[round(t, 4) for t in runs[name]['wall_s']]}, "
              f"accuracy {acc.tolist()}, modelled round time (s) "
              f"{[round(t, 3) for t in h['round_time'].tolist()]}, "
              f"ops {ops}", flush=True)
    return runs, profile_device(
        torch, "one sfl-op1 round", lambda: run("sfl-op1", rounds=1)[0],
        lambda h: float(h["wall_s"][0]) * 1e3)


def profile_device(torch, what, run, wall_of=None):
    """A measurement, not a check: ``run()`` under ``torch.profiler``, for
    the card's busy share (profiler on), its top kernels and the flash
    kernel's part.  ``run`` fails the run like any other call; only a
    profiler that records no device time gives "not measured".  The wall
    time is the host clock around ``run`` and a sync, or ``wall_of`` of
    its result."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if wall_of is not None:
        wall_ms = wall_of(res)
    try:
        # kernels and copies only: a CPU op's device time repeats theirs
        stats = [(e.key, e.self_device_time_total, e.count)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and e.self_device_time_total > 0]
    except (AttributeError, RuntimeError) as e:
        print(f"profile ({what}): not measured ({e})")
        return None
    busy_ms = sum(t for _, t, _ in stats) / 1e3
    if busy_ms <= 0:
        print(f"profile ({what}): not measured (no device time recorded)")
        return None
    stats.sort(key=lambda r: -r[1])
    flash_ms = sum(t for k, t, _ in stats if "flash_fwd" in k) / 1e3
    top = [{"kernel": k[:80], "ms": t / 1e3, "count": c}
           for k, t, c in stats[:10]]
    print(f"profile ({what}, profiler on): wall {wall_ms:.1f} ms, device "
          f"busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), flash "
          f"attention {flash_ms:.1f} ms")
    for row in top:
        print(f"  {row['ms']:9.3f} ms  x{row['count']:<5} {row['kernel']}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "flash_ms": flash_ms, "top": top}


def small_cpu_vs_card(torch, dev):
    """Phase 6, federated: the small configuration on the CPU and on the
    card."""
    import numpy as np
    from repro_torch.configs.vgg import VGG5
    from repro_torch.convert import vgg_params_to_numpy
    from repro_torch.core.controller import FedAdaptController
    from repro_torch.core.env import SimulatedCluster
    from repro_torch.core.testbed import paper_testbed
    from repro_torch.data import make_cifar_like, split_clients
    from repro_torch.fl.comm import Transport, device_bandwidths
    from repro_torch.fl.loop import FLConfig, run_federated
    from repro_torch.models.vgg import init

    clients = split_clients(make_cifar_like(60, seed=1), 3)
    test = make_cifar_like(20, seed=2)
    w, devices, c_srv, ovh = paper_testbed(VGG5)
    init_np = vgg_params_to_numpy(init(VGG5, torch.Generator().manual_seed(0)))
    out = {}
    for mode, (kw, atol) in SMALL_MODES.items():
        hists = {}
        for d in ("cpu", dev):
            sim = SimulatedCluster(w, devices[:3], c_srv, VGG5.ops,
                                   iterations=2, jitter=0.05, seed=3,
                                   overhead_s=ovh)
            ctl = (FedAdaptController(w, VGG5.ops, 3, seed=4)
                   if kw["mode"] == "fedadapt" else None)
            hists[str(d)] = run_federated(
                VGG5, clients, test, FLConfig(**SMALL, **kw), sim=sim,
                controller=ctl,
                transport=Transport(device_bandwidths(devices[:3])),
                init_params=init_np, device=d)
        a, b = hists["cpu"], hists[str(dev)]
        for key in ("ops", "round_time", "comm_time", "dropped"):
            if not np.array_equal(a[key], b[key]):
                fail(f"small {mode}: {key} differs cpu {a[key]} vs card "
                     f"{b[key]}")
        if np.max(np.abs(a["accuracy"] - b["accuracy"])) > 1 / 20 + 1e-9:
            fail(f"small {mode}: accuracy {a['accuracy']} vs {b['accuracy']}")
        diff = max(float(np.max(np.abs(x[k] - y[k])))
                   for x, y in zip(vgg_params_to_numpy(a["params"]),
                                   vgg_params_to_numpy(b["params"]))
                   for k in x)
        if diff > atol:
            fail(f"small {mode}: final params differ by {diff} > {atol}")
        out[mode] = {"max_param_diff": diff, "atol": atol,
                     "accuracy": b["accuracy"].tolist()}
        print(f"small {mode}: cpu == card (ops, times), max param diff "
              f"{diff:.3g} <= {atol}", flush=True)
    return out


def flash_drill(torch, tf, q, k, v, causal, window, cap, tol, what):
    """One flash-attention launch against the plain version on the same
    inputs; returns the max abs error."""
    out = tf.flash_attention(q, k, v, causal=causal, window=window,
                             softcap=cap)
    torch.cuda.synchronize()
    want = tf.attention_plain(q, k, v, causal, window, cap)
    if out.shape != want.shape or out.dtype != want.dtype:
        fail(f"flash {what}: {out.dtype}{tuple(out.shape)} vs "
             f"{want.dtype}{tuple(want.shape)}")
    if not bool(torch.isfinite(out).all()):
        fail(f"flash {what}: non-finite output")
    err = float((out.float() - want.float()).abs().max())
    if not torch.allclose(out.float(), want.float(), atol=tol, rtol=tol):
        fail(f"flash {what}: max abs err {err} beyond {tol}")
    print(f"flash_attention {what}: max_abs_err {err:.3g} (tol {tol})",
          flush=True)
    return err


def check_flash(torch, tf, dev):
    """Phase 3, flash attention: the reference's sweep and the drills."""
    gen = torch.Generator(device="cpu").manual_seed(3)
    worst = 0.0
    for B, Sq, Sk, H, KV, D, causal, window, cap, dt in FLASH_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=gen).to(dtype).to(dev)
                   for shape in ((B, Sq, H, D), (B, Sk, KV, D),
                                 (B, Sk, KV, D)))
        worst = max(worst, flash_drill(
            torch, tf, q, k, v, causal, window, cap, FLASH_TOL[dt],
            f"({B}, {Sq}, {Sk}, {H}, {KV}, {D}) causal={causal} "
            f"window={window} softcap={cap} {dt}"))
    return worst


def capture_prefill_attention(torch, L, T, cfg, params, tokens, layers):
    """q, k, v, window and softcap of each flash-attention call in the
    first ``layers`` layers of a real prefill of ``tokens``."""
    import dataclasses
    calls = []
    kernel = L.flash_attention

    def capture(q, k, v, causal=True, window=0, softcap=0.0):
        calls.append((q, k, v, causal, window, softcap))
        return kernel(q, k, v, causal=causal, window=window, softcap=softcap)

    L.flash_attention = capture
    try:
        T.forward(dataclasses.replace(cfg, num_layers=layers), params,
                  tokens)
    finally:
        L.flash_attention = kernel
    torch.cuda.synchronize()
    return calls


def gemma2_main_path(torch, tf, dev, launches, reset_launches):
    """Phase 5: ``ServeEngine`` on gemma2-2b at full width: the real-layer
    flash drills, the served traffic against the sequential oracle with the
    launch count the path needs, and one profiled prefill."""
    import numpy as np
    from repro_torch.configs.gemma2_2b import CONFIG as cfg
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serving import (ServeCosts, ServeEngine,
                                     TrafficGenerator, latency_stats,
                                     reference_decode, serve)
    out = {"config": cfg.name}
    t0 = time.perf_counter()
    params = T.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    leaves = []

    def walk(t):
        for v in t.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)
    walk(params)
    n_params = sum(t.numel() for t in leaves)
    norms = cfg.num_layers * 4 * cfg.d_model + cfg.d_model
    if n_params != cfg.param_count() + norms:
        fail(f"gemma2-2b: {n_params} params, the config counts "
             f"{cfg.param_count()} + {norms} norm weights")
    print(f"gemma2-2b: {n_params:,} fp32 params drawn on the card in "
          f"{out['init_s']:.2f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    requests = TrafficGenerator(**SERVE_TRAFFIC).generate()

    # real-layer drills: layer 0 is local (window 4096), layer 1 global
    longest = max(requests, key=lambda r: len(r.prompt))
    padded = np.zeros(SERVE_PROMPT, np.int64)
    padded[:len(longest.prompt)] = longest.prompt
    calls = capture_prefill_attention(
        torch, L, T, cfg, params, torch.from_numpy(padded[None]).to(dev), 2)
    worst, real = 0.0, {}
    for (q, k, v, causal, window, cap), kind in zip(calls, ("local",
                                                            "global")):
        worst = max(worst, flash_drill(
            torch, tf, q, k, v, causal, window, cap, REAL_LAYER_TOL,
            f"gemma2-2b {kind} layer, S={q.shape[1]} window={window} "
            f"softcap={cap}"))
        real[kind] = (q, k, v, window, cap)
    out["real_layer_max_abs_err"] = worst

    # the main path: engine and oracle, counts zeroed just before
    engine = ServeEngine(cfg, params, slots=SERVE_SLOTS,
                         max_prompt=SERVE_PROMPT, max_seq=SERVE_SEQ)
    prefill_s, decode_s = [], []

    def timed(fn, log):
        def run(*a, **kw):
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            log.append(time.perf_counter() - t)
            return r
        return run
    engine.submit = timed(engine.submit, prefill_s)
    engine.step = timed(engine.step, decode_s)
    reset_launches()
    t0 = time.perf_counter()
    res = serve(engine, requests, ServeCosts(prefill=1.0, decode=0.1))
    serve_wall = time.perf_counter() - t0
    if engine.last_logits is None or engine.last_logits.shape != (
            SERVE_SLOTS, cfg.vocab_size) or not np.isfinite(
            engine.last_logits).all():
        fail("gemma2-2b serve: last logits missing, misshapen or not "
             "finite")
    t0 = time.perf_counter()
    compared = 0
    for r in res["requests"]:
        if r.tokens is None or len(r.tokens) != r.gen:
            fail(f"gemma2-2b serve: request {r.rid} gave {r.tokens}, "
                 f"needs {r.gen} tokens")
        ref, margins = reference_decode(cfg, params, r.prompt, r.gen,
                                        return_margins=True)
        n = 0
        for i in range(r.gen):
            if margins[i] < MARGIN:
                break
            if r.tokens[i] != ref[i]:
                fail(f"gemma2-2b serve: request {r.rid} token {i} is "
                     f"{r.tokens[i]}, the oracle's {ref[i]} (margin "
                     f"{margins[i]:.4g})")
            n += 1
        compared += n
        print(f"request {r.rid}: prompt {len(r.prompt)}, gen {r.gen}, "
              f"{n} tokens equal the oracle's (min margin "
              f"{min(margins):.3g})", flush=True)
    oracle_wall = time.perf_counter() - t0
    counts = dict(launches)
    prefills = 2 * len(requests)
    want = {k: 0 for k in counts}
    want["flash_attention"] = cfg.num_layers * prefills
    print(f"serve-gemma2-2b: launches {counts} (expected {want}: "
          f"{cfg.num_layers} layers x {prefills} prefills)")
    if counts != want:
        fail(f"serve-gemma2-2b: launches {counts}, the path needs {want}")
    total = sum(r.gen for r in requests)
    if compared < total // 2:
        fail(f"gemma2-2b serve: only {compared} of {total} tokens compared")
    stats = latency_stats(res)
    busy = sum(prefill_s) + sum(decode_s)
    out.update({
        "requests": [{"rid": r.rid, "prompt": len(r.prompt), "gen": r.gen,
                      "tokens": r.tokens} for r in res["requests"]],
        "tokens_compared": compared, "tokens_total": total,
        "prefill_s": prefill_s, "decode_step_s": decode_s,
        "serve_wall_s": serve_wall, "oracle_wall_s": oracle_wall,
        "tokens_per_s": total / busy, "launches": counts,
        "virtual_clock_stats": stats,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
    print(f"serve-gemma2-2b: {compared} of {total} tokens compared, all "
          f"equal; prefill at {SERVE_PROMPT}: median "
          f"{statistics.median(prefill_s):.3f} s ({len(prefill_s)}); "
          f"decode step ({SERVE_SLOTS} slots): median "
          f"{statistics.median(decode_s) * 1e3:.1f} ms "
          f"({len(decode_s)} steps); {out['tokens_per_s']:.1f} tokens/s "
          f"over engine time {busy:.2f} s (wall {serve_wall:.2f} s); "
          f"oracle {oracle_wall:.2f} s", flush=True)
    # one engine-shaped prefill and one decode step over the pooled cache
    tokens = torch.from_numpy(padded[None]).to(dev)
    out["profile_prefill"] = profile_device(
        torch, f"one prefill, {SERVE_PROMPT} tokens",
        lambda: T.forward(cfg, params, tokens, return_cache=True,
                          cache_seq=SERVE_SEQ))
    step_tok = torch.zeros((SERVE_SLOTS, 1), dtype=torch.long, device=dev)
    step_pos = torch.full((SERVE_SLOTS,), SERVE_PROMPT, device=dev)
    out["profile_decode"] = profile_device(
        torch, f"one decode step, {SERVE_SLOTS} slots",
        lambda: T.decode_step(cfg, params, engine.cache, step_tok, step_pos))
    return out, real


def small_serve_cpu_vs_card(torch, dev):
    """Phase 6, serving: gemma2-2b's smoke config through ``serve`` on the
    CPU (plain attention) and on the card (the kernel), same weights and
    traffic: tokens equal, every decode step's logits within 1e-4."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.configs.gemma2_2b import smoke_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import transformer as T
    from repro_torch.serving import (ServeCosts, ServeEngine,
                                     TrafficGenerator, serve)
    cfg = smoke_config()
    host = T.init(cfg, seed=0, device="cpu")
    card = convert.transformer_params_from_numpy(
        convert.transformer_params_to_numpy(host), dev)
    traffic = TrafficGenerator(rate=1.5, n_requests=10,
                               vocab_size=cfg.vocab_size,
                               prompt_lens=(3, 12, 40), gen_lens=(1, 3, 6),
                               seed=3)
    runs = {}
    for name, params in (("cpu", host), ("card", card)):
        engine = ServeEngine(cfg, params, slots=3, max_prompt=40,
                             max_seq=52)
        logits, step = [], engine.step

        def logged(step=step, engine=engine, logits=logits):
            done = step()
            logits.append(engine.last_logits)
            return done
        engine.step = logged
        before = LAUNCHES["flash_attention"]
        res = serve(engine, traffic.generate(), ServeCosts(0.4, 0.2))
        runs[name] = ([r.tokens for r in res["requests"]], logits,
                      LAUNCHES["flash_attention"] - before)
    (tok_a, log_a, n_a), (tok_b, log_b, n_b) = runs["cpu"], runs["card"]
    if n_a != 0 or n_b <= 0:
        fail(f"small serve: flash launches cpu {n_a} (needs 0), card {n_b}")
    if tok_a != tok_b:
        fail(f"small serve: tokens differ cpu {tok_a} vs card {tok_b}")
    if len(log_a) != len(log_b):
        fail("small serve: decode step counts differ")
    diff = max(float(np.max(np.abs(a - b))) for a, b in zip(log_a, log_b))
    if diff > SMALL_SERVE_ATOL:
        fail(f"small serve: logits differ by {diff} > {SMALL_SERVE_ATOL}")
    print(f"small serve gemma2-2b smoke: cpu == card tokens "
          f"({sum(map(len, tok_a))}), max logit diff {diff:.3g} <= "
          f"{SMALL_SERVE_ATOL} over {len(log_a)} decode steps; {n_b} "
          f"kernel launches on the card", flush=True)
    return {"tokens": sum(map(len, tok_a)), "max_logit_diff": diff,
            "atol": SMALL_SERVE_ATOL, "card_launches": n_b}


def time_flash(torch, tf, real):
    """Phase 7, flash attention at gemma2-2b's two prefill shapes, on the
    real layers' q, k, v: S=4608, H=8, KV=4, D=256, causal, softcap 50,
    global (window 0) and local (window 4096); plus the global shape
    without the softcap, where ``scaled_dot_product_attention`` computes
    the same function (k and v repeated to 8 heads outside the timed
    call).  The bound counts 4 * D * H operations per visible (q, k) pair
    over the fp32 rate (TF32 would break the 1e-5 tolerance) and each
    input and output byte once over the memory rate."""
    F = torch.nn.functional
    rows = []
    for kind, cap in (("global", 50.0), ("local", 50.0), ("global", 0.0)):
        q, k, v, window, _ = real[kind]
        B, S, H, D = q.shape
        KV = k.shape[2]
        pairs = int(tf.visible_mask(S, k.shape[1], True, window,
                                    q.device).sum())
        nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
        library = None
        if cap == 0.0:
            qh = q.transpose(1, 2)
            kh = k.transpose(1, 2).repeat_interleave(H // KV, dim=1)
            vh = v.transpose(1, 2).repeat_interleave(H // KV, dim=1)
            sdpa = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
            mine = tf.flash_attention(q, k, v, True, window, cap)
            err = float((sdpa.transpose(1, 2) - mine).abs().max())
            print(f"flash vs scaled_dot_product_attention (softcap 0): max "
                  f"abs diff {err:.3g}")

            def library():
                return F.scaled_dot_product_attention(qh, kh, vh,
                                                      is_causal=True)
        row = _timing_row(
            "flash_attention", [B, S, H, KV, D],
            lambda: tf.flash_attention(q, k, v, True, window, cap),
            lambda: tf.attention_plain(q, k, v, True, window, cap), library,
            nbytes, 4 * D * H * pairs, reps=7, inner=5)
        row.update({"window": window, "softcap": cap, "pairs": pairs})
        rows.append(row)
    return rows


def _timing_row(name, shape, fn, plain, library, nbytes, ops, reps=15,
                inner=20):
    b_ms, b_by = bound_ms(nbytes, ops)
    kw = dict(reps=reps, inner=inner)
    return {"name": name, "shape": shape, "ms": time_ms(fn, **kw),
            "call_ms": time_ms(fn, graph=False, **kw),
            "plain_ms": time_ms(plain, **kw), "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None if library is None else time_ms(library, **kw)}


def time_kernels(torch, tq, tt, dev, launches, worst, flash_rows):
    """Phase 7: each kernel's time beside its bound, its plain version and
    a library call where one computes the same function: ``torch.mul`` of
    the int8 codes by the scales (one kernel that promotes to fp32) for
    dequantize, ``torch.topk`` over the blocks' magnitudes for top-k,
    ``scaled_dot_product_attention`` for flash attention without the
    softcap (``time_flash``).  No single PyTorch call computes the rowwise
    absmax int8 quantizer, nor attention with gemma2's logit softcap."""
    from repro_torch.configs.vgg import VGG5
    from repro_torch.fl.flatbuf import FlatLayout
    from repro_torch.models.vgg import init
    gen = torch.Generator().manual_seed(1)
    rows = []
    # quantize / dequantize at the cut (OP1, B=100: 150 calls per run) and
    # on the delta wire (one VGG-5 client row)
    for R, C in [(25600, 32), (580, 1024)]:
        x = torch.randn((R, C), generator=gen).to(dev)
        q, s = tq.quantize_rows(x)
        n = R * C
        for name, fn, plain, library, nbytes, ops in [
                ("quantize", lambda: tq.quantize_rows(x),
                 lambda: tq.quantize_rows_plain(x), None,
                 n * 4 + n + R * 4, 5 * n),
                ("dequantize", lambda: tq.dequantize_rows(q, s),
                 lambda: tq.dequantize_rows_plain(q, s),
                 lambda: torch.mul(q, s[:, None]), n + R * 4 + n * 4, n)]:
            rows.append(_timing_row(name, [R, C], fn, plain, library,
                                    nbytes, ops))
    # top-k over one VGG-5 client row at the main path's density 0.1
    layout = FlatLayout(init(VGG5, gen))
    meta = torch.from_numpy(layout.block_meta(0.1)).to(torch.int32).to(dev)
    buf = torch.randn((1, layout.padded), generator=gen).to(dev)
    nb = meta.shape[0]
    kmax = int(meta[:, 1].max())
    lane = torch.arange(1024, device=dev)[None]
    mag = torch.where(lane < meta[:, :1], buf.view(nb, 1024).abs(),
                      torch.tensor(float("-inf"), device=dev))
    n = layout.padded
    rows.append(_timing_row(
        "topk_compress", [1, n], lambda: tt.topk_compress_flat(buf, meta),
        lambda: tt.topk_blocks_plain(buf.view(nb, 1024), meta),
        lambda: torch.topk(mag, kmax, dim=1), 2 * 4 * n + 8 * nb, 4 * n))
    rows += flash_rows
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        extra = (f" window {r['window']} softcap {r['softcap']}"
                 if "window" in r else "")
        print(f"kernel {r['name']} {tuple(r['shape'])}{extra}: launches "
              f"{launches[r['name']]}, kernel_ms {r['ms']:.4f} "
              f"(graph; eager call {r['call_ms']:.4f}), bound_ms "
              f"{r['bound_ms']:.5f} ({r['bound_by']}), plain_ms "
              f"{r['plain_ms']:.4f}, library_ms {lib}")
    port, ref = "src/repro_torch/kernels/csrc/", "src/repro/kernels/"
    src = {"quantize": (port + "quant_transfer.cu",
                        ref + "quant_transfer/quant_transfer.py:31"),
           "dequantize": (port + "quant_transfer.cu",
                          ref + "quant_transfer/quant_transfer.py:52"),
           "topk_compress": (port + "topk_compress.cu",
                             ref + "topk_compress/topk_compress.py:64"),
           "flash_attention": (port + "flash_attention.cu",
                               ref + "flash_attention/flash_attention.py:84")}
    kernels = []
    for r in rows:
        if r["name"] in [k["name"] for k in kernels]:
            continue                    # the JSON line holds the main shape
        kernels.append({"name": r["name"], "route": "cuda",
                        "source": src[r["name"]][0],
                        "replaces": src[r["name"]][1],
                        "launches": sum(launches[r["name"]].values()),
                        "launches_by_path": launches[r["name"]],
                        "max_abs_err": worst[r["name"]],
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    return kernels, rows


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    phase("1. card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not card:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN: every comparison is full fp32")
    try:
        from repro_torch.kernels import LAUNCHES, _build, reset_launches
        from repro_torch.kernels import flash_attention as tf
        from repro_torch.kernels import quant_transfer as tq
        from repro_torch.kernels import topk_compress as tt
    except ImportError as e:
        fail(f"the port is not beside chip_smoke.py ({e})")
    dev = torch.device("cuda", 0)
    record = {"card": card}
    try:
        phase("2. build")
        t0 = time.perf_counter()
        logs = _build.build_all(verbose=True)
        record["build_s"] = time.perf_counter() - t0
        print(f"built {sorted(logs) or 'nothing (cached)'} in "
              f"{record['build_s']:.2f} s")
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

        phase("3. kernels vs plain versions")
        worst = check_kernels(torch, tq, tt, dev)
        worst["flash_attention"] = check_flash(torch, tf, dev)
        torch.cuda.synchronize()

        phase("4. federated main path: run_federated on VGG-5, full width")
        record["main_path"], record["profile"] = vgg5_main_path(
            torch, dev, LAUNCHES, reset_launches)

        phase("5. serving main path: ServeEngine on gemma2-2b, full width")
        serving, real = gemma2_main_path(torch, tf, dev, LAUNCHES,
                                         reset_launches)
        record["main_path"]["serve-gemma2-2b"] = serving
        worst["flash_attention"] = max(worst["flash_attention"],
                                       serving["real_layer_max_abs_err"])
        launches = {k: {path: run["launches"][k]
                        for path, run in record["main_path"].items()}
                    for k in LAUNCHES}

        phase("6. small configurations: CPU vs card")
        record["small"] = small_cpu_vs_card(torch, dev)
        record["small_serve"] = small_serve_cpu_vs_card(torch, dev)

        phase("7. kernel times")
        kernels, rows = time_kernels(torch, tq, tt, dev, launches, worst,
                                     time_flash(torch, tf, real))
        record["kernels"], record["timings"] = kernels, rows
        torch.cuda.synchronize()
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        fail("a phase raised")
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
