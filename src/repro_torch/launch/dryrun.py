"""Multi-pod dry run: one abstract evaluation of every (arch x shape x mesh)
cell (counterpart of ``repro/launch/dryrun.py``).

Proves the distribution config is coherent without a card: params,
optimizer state, batch and KV/SSM cache are ``meta`` stand-ins with specs
from ``make_axis_rules`` over the 16 x 16 (or 2 x 16 x 16) mesh of
``meta`` places, and the cell's step runs once on them under
``use_rules`` and a step analysis (``launch.hlo_analysis.analyse``, the
reference's ``hlo_analysis``: there is no HLO, the analysis reads the
eager step's aten ops).  Nothing is allocated and no kernel is launched
(the kernels' wrappers take their plain versions on ``meta`` and record
their written counts).

What a cell reports, per place, as the reference's do:
  * ``cost``: ``flops``, ``bytes_accessed``, ``transcendentals`` (and
    ``matmul_flops``, the products' share) of one place's program: a
    matmul 2 M N K of its local shapes, an elementwise op one a local
    output element, each kernel its written count (attention's full (Sq,
    Sk) products, causal or not, as XLA counts the reference's);
    a train step's rematerialised layers and CE chunks count their
    recompute in the backward, as XLA counts a ``jax.checkpoint``'s;
  * ``memory``: ``argument_size_in_bytes`` / ``output_size_in_bytes``
    (each stand-in's bytes over its spec's shards; the output's tuple
    table of 8 bytes a leaf, as XLA counts it), ``alias_size_in_bytes``
    (the donated params and optimizer state of a train step, the cache of
    a decode step), ``temp_size_in_bytes`` (the high-water mark of the
    step's live storages a place) and ``peak_memory_in_bytes``
    (arguments plus temp);
  * ``collectives``: bytes and count per op (``all-gather``,
    ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``, ``total``) of the redistributions the specs
    imply, the activation pins (``parallel.sharding.shard``) included,
    once per place with its output's bytes; the expert-parallel MoE's
    gathers and sums as one place's program performs them;
  * ``unrolled``: the reference's entry (``status``, ``method``,
    ``cost``, ``collectives_total``, ``collectives``), so that
    ``benchmarks/roofline.py``'s reading of a cell reads these: eager
    code runs every layer, so the count is direct where the reference
    extrapolates from two reduced-depth unrolled lowerings;
  * ``model_flops``: global, as the reference's; ``kernels``, the
    written counts recorded, and ``collective_groups``, the collectives
    by op, mesh axes and where they arise (an op, a pin ``shard``, the
    MoE body ``moe``).
What has none: ``compile_s`` and ``hlo_bytes_len`` (nothing is
compiled).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--jobs 4]
Artifacts: artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__<variant>].json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch
from repro_torch.configs import ARCH_NAMES, SHAPES, cell_is_runnable, get_config
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import inputs as I
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel.sharding import make_axis_rules, use_rules
from repro_torch.tree import tree_map

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
META = torch.device("meta")


def meta_places(multi_pod: bool):
    return [META] * (512 if multi_pod else 256)


def _logits_spec(rules, batch_size, vocab):
    return (rules.resolve("batch", batch_size),
            rules.resolve("vocab", vocab))


def _build_cell(cfg, shape, rules):
    """(step, args, their specs, the outputs' specs from the outputs,
    model_flops, the donated args' indices) for one cell."""
    dtype = torch.bfloat16
    params = S.abstract_params(cfg, dtype)
    p_specs = S.model_param_pspecs(cfg, params, rules)
    B = shape.global_batch
    if shape.kind == "train":
        opt = S.make_opt(cfg)
        opt_state = S.abstract_opt_state(opt, params)
        o_specs = S.opt_pspecs(opt_state, params, p_specs, rules)
        batch = I.train_batch_specs(cfg, shape, dtype)
        step = S.make_train_step(cfg, opt)
        args = (params, opt_state, batch)
        arg_specs = (p_specs, o_specs, I.batch_pspecs(cfg, batch, rules))

        def out_specs(outs):
            return ((), p_specs, o_specs)
        model_flops = 6.0 * cfg.active_param_count() * shape.tokens
        donated = (0, 1)
    elif shape.kind == "prefill":
        batch = I.prefill_batch_specs(cfg, shape, dtype)
        step = S.make_prefill_step(cfg, shape)
        args = (params, batch)
        arg_specs = (p_specs, I.batch_pspecs(cfg, batch, rules))

        def out_specs(outs):
            return (_logits_spec(rules, B, cfg.vocab_size),
                    I.cache_pspecs(cfg, outs[1], rules))
        model_flops = 2.0 * cfg.active_param_count() * shape.tokens
        donated = ()
    else:  # decode
        cache, token, pos = I.decode_inputs(cfg, shape)
        cache = tree_map(lambda l: l if l.dtype == torch.int32 else
                         torch.empty(l.shape, dtype=dtype, device=META),
                         cache)
        c_specs = I.cache_pspecs(cfg, cache, rules)
        step = S.make_decode_step(cfg)
        args = (params, cache, token, pos)
        arg_specs = (p_specs, c_specs, (rules.resolve("batch", B), None),
                     ())

        def out_specs(outs):
            return (_logits_spec(rules, B, cfg.vocab_size), c_specs)
        model_flops = 2.0 * cfg.active_param_count() * B
        donated = (1,)
    return step, args, arg_specs, out_specs, model_flops, donated


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             variant: str = "baseline", opt_flags=None) -> dict:
    t0 = time.time()
    cfg = get_config(arch)
    if opt_flags:
        cfg = dataclasses.replace(cfg, **opt_flags)
    shape = SHAPES[shape_name]
    ok, why = cell_is_runnable(cfg, shape)
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "variant": variant, "kind": shape.kind,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    if not ok:
        result.update(status="skipped", reason=why)
        return result

    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=meta_places(multi_pod))
    rules = make_axis_rules(mesh)
    with use_rules(rules):
        step, args, arg_specs, out_specs, model_flops, donated = \
            _build_cell(cfg, shape, rules)
        r = H.analyse(step, args, arg_specs, out_specs, mesh.shape, donated)
    cost, coll = H.cost_stats(r), H.collective_stats(r)
    result.update(
        status="ok",
        chips=mesh.size,
        total_s=round(time.time() - t0, 2),
        cost=cost,
        memory=H.memory_stats(r),
        collectives=coll,
        unrolled={"status": "ok",
                  "method": "eager: every layer runs, nothing is "
                            "extrapolated",
                  "cost": cost, "collectives_total": coll["total"],
                  "collectives": coll},
        model_flops=model_flops,
        kernels=r["kernels"],
        collective_groups=H.group_stats(r),
    )
    return result


def cell_path(out_dir, arch, shape_name, mesh_name, variant="baseline"):
    v = "" if variant == "baseline" else f"__{variant}"
    return os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}{v}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--opt-flags", default="",
                    help="json dict of ModelConfig overrides")
    ap.add_argument("--out", default=str(ARTIFACTS))
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if args.all:
        # one subprocess per cell (isolation + parallelism)
        jobs = []
        meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
        for arch in ARCH_NAMES:
            for shape_name in SHAPES:
                for mesh_name in meshes:
                    path = cell_path(args.out, arch, shape_name, mesh_name,
                                     args.variant)
                    if os.path.exists(path) and not args.force:
                        continue
                    jobs.append((arch, shape_name, mesh_name))
        print(f"{len(jobs)} cells to run, {args.jobs} at a time", flush=True)
        running = []
        while jobs or running:
            while jobs and len(running) < args.jobs:
                arch, shape_name, mesh_name = jobs.pop(0)
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape_name,
                       "--mesh", mesh_name, "--out", args.out,
                       "--variant", args.variant]
                if args.opt_flags:
                    cmd += ["--opt-flags", args.opt_flags]
                if args.force:
                    cmd += ["--force"]
                p = subprocess.Popen(cmd)
                running.append((p, arch, shape_name, mesh_name))
                print(f"LAUNCH {arch} {shape_name} {mesh_name}", flush=True)
            time.sleep(2)
            still = []
            for p, a, s, m in running:
                if p.poll() is None:
                    still.append((p, a, s, m))
                else:
                    print(f"DONE({p.returncode}) {a} {s} {m}", flush=True)
            running = still
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape are needed without --all")
    mesh_name = args.mesh if args.mesh != "both" else "single"
    path = cell_path(args.out, args.arch, args.shape, mesh_name, args.variant)
    if os.path.exists(path) and not args.force:
        print(f"exists: {path}")
        return
    opt_flags = json.loads(args.opt_flags) if args.opt_flags else None
    try:
        result = run_cell(args.arch, args.shape, mesh_name == "multi",
                          args.variant, opt_flags)
    except Exception as e:
        result = {
            "arch": args.arch, "shape": args.shape,
            "mesh": "2x16x16" if mesh_name == "multi" else "16x16",
            "variant": args.variant,
            "status": "error",
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        }
    with open(path, "w") as f:
        json.dump(result, f, indent=1, default=str)
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ("traceback", "collectives")},
                     indent=1, default=str))
    if result["status"] == "ok":
        print("memory (per place):", result.get("memory"))
        print("collectives:", result.get("collectives"))
    sys.exit(0 if result["status"] in ("ok", "skipped") else 1)


if __name__ == "__main__":
    main()
