"""FedAdapt-at-pod-scale dry run: per-pod local steps + cross-pod FedAvg
(counterpart of ``repro/launch/fedavg_dryrun.py``).

Runs the two halves of the paper's FL structure mapped onto the 2 x 16 x
16 multi-pod mesh of ``meta`` places, once each, on ``meta`` stand-ins
(nothing is allocated, no kernel is launched):

  * local_step: every param/opt leaf carries a leading (pods,) dim over
    ``pod``; ``torch.func.vmap`` makes the pods independent replicas, each
    with the within-pod rules (batch over ``data`` alone);
  * sync_step: the only cross-pod communication, the FedAvg mean over the
    pod dim, counted as one ``all-reduce`` over ``pod`` of the fp32 mean.

Reports each step's collectives as the port's program performs them
(``parallel.sharding.count_collectives``: the local step's are the MoE's
within-pod ones, none for a dense model) and the model's bf16 bytes.

    PYTHONPATH=src python -m repro_torch.launch.fedavg_dryrun --arch qwen3-0.6b
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import inputs as I
from repro_torch.launch import steps as S
from repro_torch.launch.dryrun import ARTIFACTS, meta_places
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel.sharding import (
    count_collectives,
    make_axis_rules,
    use_rules,
)
from repro_torch.tree import tree_leaves, tree_map


def run(arch: str, shape_name: str = "train_4k", out_dir: str = ""):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=True, devices=meta_places(True))
    pods = mesh.shape["pod"]
    # within-pod rules: batch over 'data' only (each pod trains locally)
    rules = dataclasses.replace(make_axis_rules(mesh), batch=("data",))

    with use_rules(rules):
        dtype = torch.bfloat16
        params_shapes = S.abstract_params(cfg, dtype)
        opt = S.make_opt(cfg)
        opt_shapes = S.abstract_opt_state(opt, params_shapes)
        # leading (pods,) dim on every leaf, over 'pod'
        pp = S.stack_for_pods(params_shapes, pods)
        oo = S.stack_for_pods(opt_shapes, pods)
        batch = I.train_batch_specs(cfg, shape, dtype)
        batch_pods = tree_map(
            lambda l: torch.empty((pods, l.shape[0] // pods)
                                  + tuple(l.shape[1:]), dtype=l.dtype,
                                  device=l.device), batch)
        local_step, sync_step = S.make_local_sync_steps(cfg, opt, pods)

        t0 = time.time()
        with count_collectives() as local_coll:
            local_step(pp, oo, batch_pods)
        t_local = time.time() - t0
        t1 = time.time()
        with count_collectives() as sync_coll:
            sync_step(pp)
        t_sync = time.time() - t1

    param_bytes = sum(leaf.numel() * 2 for leaf in tree_leaves(params_shapes))
    result = {
        "arch": arch, "shape": shape_name, "pods": pods,
        "status": "ok",
        "local_step": {"seconds": round(t_local, 2),
                       "collectives": local_coll},
        "sync_step": {"seconds": round(t_sync, 2),
                      "collectives": sync_coll},
        "model_bytes": param_bytes,
        "note": ("local_step collectives are the within-pod ones the "
                 "port's program performs (the sharded MoE's; none for a "
                 "dense model); sync_step's all-reduce over 'pod' is the "
                 "only cross-pod traffic"),
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(
                out_dir, f"{arch}__{shape_name}__fedavg_sync.json"),
                "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--out", default=str(ARTIFACTS))
    a = ap.parse_args(argv)
    return run(a.arch, a.shape, os.path.abspath(a.out))


if __name__ == "__main__":
    main()
