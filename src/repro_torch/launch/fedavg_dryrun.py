"""FedAdapt-at-pod-scale dry run: per-pod local steps + cross-pod FedAvg
(counterpart of ``repro/launch/fedavg_dryrun.py``).

Runs the two halves of the paper's FL structure mapped onto the 2 x 16 x
16 multi-pod mesh of ``meta`` places, once each, on ``meta`` stand-ins
under a step analysis (``launch.hlo_analysis``; nothing is allocated, no
kernel is launched):

  * local_step: every param/opt leaf carries a leading (pods,) dim over
    ``pod``; ``torch.func.vmap`` makes the pods independent replicas, each
    with the within-pod rules (batch over ``data`` alone);
  * sync_step: the only cross-pod communication, the FedAvg mean over the
    pod dim, one ``all-reduce`` over ``pod`` of a place's fp32 share.

Reports each step's collectives per place, as the reference's
``collective_stats`` reads a device's program: the local step's are the
within-pod FSDP and TP ones (``pod_spanning`` counts those whose group
spans ``pod``: none), the sync's the one all-reduce; and the model's bf16
bytes.

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
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import inputs as I
from repro_torch.launch import steps as S
from repro_torch.launch.dryrun import ARTIFACTS, meta_places
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel.sharding import make_axis_rules, use_rules
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
        p_specs = S.model_param_pspecs(cfg, params_shapes, rules)
        o_specs = S.opt_pspecs(opt_shapes, params_shapes, p_specs, rules)
        # leading (pods,) dim on every leaf, over 'pod'
        pp = S.stack_for_pods(params_shapes, pods)
        oo = S.stack_for_pods(opt_shapes, pods)
        pp_specs = S.pod_pspecs(p_specs, pods)
        oo_specs = S.pod_pspecs(o_specs, pods)
        batch = I.train_batch_specs(cfg, shape, dtype)
        batch_pods = tree_map(
            lambda l: torch.empty((pods, l.shape[0] // pods)
                                  + tuple(l.shape[1:]), dtype=l.dtype,
                                  device=l.device), batch)
        b_specs = tree_map(lambda l: ("pod", "data") + (None,) * (l.dim()
                                                                  - 2),
                           batch_pods)
        local_step, sync_step = S.make_local_sync_steps(cfg, opt, pods)

        t0 = time.time()
        local = H.analyse(local_step, (pp, oo, batch_pods),
                          (pp_specs, oo_specs, b_specs),
                          lambda outs: (("pod",), pp_specs, oo_specs),
                          mesh.shape, donated=(0, 1))
        t_local = time.time() - t0
        t1 = time.time()
        sync = H.analyse(sync_step, (pp,), (pp_specs,),
                         lambda outs: pp_specs, mesh.shape, donated=(0,))
        t_sync = time.time() - t1

    param_bytes = sum(leaf.numel() * 2 for leaf in tree_leaves(params_shapes))
    result = {
        "arch": arch, "shape": shape_name, "pods": pods,
        "status": "ok",
        "local_step": {"seconds": round(t_local, 2),
                       "collectives": H.collective_stats(local),
                       "pod_spanning": sum("pod" in g[1]
                                           for g in local["groups"])},
        "sync_step": {"seconds": round(t_sync, 2),
                      "collectives": H.collective_stats(sync)},
        "model_bytes": param_bytes,
        "note": ("local_step collectives are the within-pod FSDP and TP "
                 "ones a place performs; sync_step's all-reduce over 'pod' "
                 "is the only cross-pod traffic"),
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
