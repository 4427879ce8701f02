"""Serving driver: continuous-batching inference through ``ServeEngine``
(counterpart of ``repro/launch/serve.py``, same flags).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch lm16m \\
        --batch 4 --prompt-len 64 --gen 32

Runs on the card; ``main(argv, device="cpu")`` runs on the CPU.  The
weights are drawn from ``--seed`` by the port's own generator, so they
differ from the reference's for the same seed; ``main(argv, params=...)``
serves given weights instead (the tests pass the reference's, carried
across by ``convert``).  Timings are host clock (``time.perf_counter``)
around work that ends in a device sync.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.lm_small import SMALL_CONFIGS
from repro_torch.data.synthetic import make_token_stream
from repro_torch.models import api
from repro_torch.serving import ServeEngine


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, device=None, params=None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lm16m", choices=list(SMALL_CONFIGS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = SMALL_CONFIGS[args.arch]
    device = resolve_device(device)
    if params is None:
        params = api.init(cfg, args.seed, device=device)
    stream = make_token_stream(args.batch * (args.prompt_len + 1) * 4,
                               cfg.vocab_size, seed=args.seed)
    prompts = stream[: args.batch * args.prompt_len].reshape(
        args.batch, args.prompt_len).astype(np.int32)

    engine = ServeEngine(cfg, params, slots=args.batch,
                         max_prompt=args.prompt_len,
                         max_seq=args.prompt_len + args.gen)

    out = {}
    t0 = time.perf_counter()
    for rid in range(args.batch):
        fin = engine.submit(rid, prompts[rid], args.gen)
        if fin is not None:                      # gen == 1 finishes at prefill
            out[fin.rid] = fin.tokens
    _sync(engine.device)
    t_prefill = time.perf_counter() - t0

    t1 = time.perf_counter()
    while engine.num_active:
        for fin in engine.step():
            out[fin.rid] = fin.tokens
    _sync(engine.device)
    t_decode = time.perf_counter() - t1

    gen = np.asarray([out[rid] for rid in range(args.batch)], np.int32)
    n_decoded = args.batch * (args.gen - 1)      # first token from prefill
    tok_s = n_decoded / max(t_decode, 1e-9)
    print(f"# {cfg.name} on {engine.device}: prefill {args.batch}x"
          f"{args.prompt_len} in {t_prefill:.2f}s; decode {args.gen - 1} "
          f"steps at {tok_s:.1f} tok/s ({engine.slots} slots)")
    print("# first sequence:", gen[0][:16].tolist())
    return gen


if __name__ == "__main__":
    main()
