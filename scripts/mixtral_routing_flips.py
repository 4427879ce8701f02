"""Where chip_smoke phase 5c's served mixtral-8x22b and its sequential
oracle part: each decode step's logits gap beside the MoE routing of that
step's token on both sides.

    python3 scripts/mixtral_routing_flips.py            # on the card
    python3 scripts/mixtral_routing_flips.py --device cpu  # smoke config

A development script, outside the port's package: nothing the port runs
calls it.  It builds phase 5c's model (6 layers at full width, capacity
factor 4.0, weights from seed 0) and traffic, serves it through
``ServeEngine`` while recording each live request's logits row and, in
every layer, the routing choices of its row, then runs chip_smoke's
``oracle_steps`` over each request with the same recording.  Printed per
request: the prefill's routing choices that differ between the engine's
padded prefill and the oracle's (per layer) and each layer's smallest gap
between a token's k-th and (k+1)-th router probability; per decode step:
the max |engine - oracle| logit, the layers whose choice for that token
differs, the oracle's smallest router gap, whether the tokens agree and
the oracle's top-2 logit margin.  On the CPU it runs the smoke config at
phase 5c's rehearsal sizes.  The lines go to
``chiprun_out/mixtral_routing_flips.log`` too.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import mixtral_8x22b  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.serving import (ServeCosts, ServeEngine,  # noqa: E402
                                 TrafficGenerator, serve)


def recording_route(log):
    """Wrap ``L.moe_route``: each call appends (the chosen experts, each
    token's gap between its k-th and (k+1)-th router probability) to
    ``log`` as host arrays."""
    route = L.moe_route

    def recorded(cfg, p, xf):
        topw, topi = route(cfg, p, xf)
        top = torch.topk(L._router_probs(p, xf), cfg.moe.top_k + 1,
                         -1).values
        log.append((topi.cpu().numpy(),
                    (top[:, -2] - top[:, -1]).float().cpu().numpy()))
        return topw, topi
    L.moe_route = recorded


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = mixtral_8x22b.CONFIG
    layers, cf = cs.MIXTRAL_LAYERS, cs.MIXTRAL_CF
    slots, prompt, seq = cs.MIXTRAL_SLOTS, cs.MIXTRAL_PROMPT, cs.MIXTRAL_SEQ
    traffic = cs.MIXTRAL_TRAFFIC
    if dev.type == "cpu":
        base = mixtral_8x22b.smoke_config()
        layers, cf, slots, prompt, seq = 2, 8.0, 3, 30, 52
        traffic = dict(traffic, n_requests=5, vocab_size=base.vocab_size,
                       prompt_lens=(6, 20, 30), gen_lens=(4, 8, 16))
    cfg = dataclasses.replace(base, num_layers=layers, moe=dataclasses.replace(
        base.moe, capacity_factor=cf))
    params = api.init(cfg, seed=0, device=dev)
    requests = TrafficGenerator(**traffic).generate()
    log = []
    recording_route(log)
    engine = ServeEngine(cfg, params, slots=slots, max_prompt=prompt,
                         max_seq=seq)
    rows, routes, live = {}, {}, {}
    submit, step = engine.submit, engine.step

    def claim(rid, tokens, gen):
        idle = ~engine.active
        log.clear()
        r = submit(rid, tokens, gen)
        routes[rid, 0] = [(t[:len(tokens)], g[:len(tokens)]) for t, g in log]
        for s in np.nonzero(idle & engine.active)[0]:
            live[int(s)] = [rid, 1]
        return r

    def decode():
        before = [(s, *live[s])
                  for s in map(int, np.nonzero(engine.active)[0])]
        log.clear()
        r = step()
        for s, rid, i in before:
            rows[rid, i] = engine.last_logits[s].copy()
            routes[rid, i] = [(t[s], g[s]) for t, g in log]
            live[s][1] += 1
        return r
    engine.submit, engine.step = claim, decode
    res = serve(engine, requests, ServeCosts(prefill=1.0, decode=0.1))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    lines = [f"{cfg.name}, {layers} layers, cf {cf}, {slots} slots, on "
             f"{torch.cuda.get_device_name(0) if dev.type == 'cuda' else dev}"]
    for r in res["requests"]:
        log.clear()
        for i, (tok, margin, logits) in enumerate(
                cs.oracle_steps(torch, cfg, params, r.prompt, r.gen)):
            calls, theirs = list(log), routes[r.rid, i]
            log.clear()
            if not i:
                flips = [int((t != e).any(-1).sum())
                         for (t, _), (e, _) in zip(calls, theirs)]
                lines.append(
                    f"request {r.rid} (prompt {len(r.prompt)}, gen {r.gen}):"
                    f" prefill routing flips per layer {flips}, smallest "
                    f"router gap per layer "
                    f"{[float(f'{g.min():.2g}') for _, g in calls]}")
                continue
            diff = float(np.abs(rows[r.rid, i]
                                - logits[0].float().cpu().numpy()).max())
            flips = sum(int((t[0] != e).any())
                        for (t, _), (e, _) in zip(calls, theirs))
            gap = min(float(g[0]) for _, g in calls)
            lines.append(f"  step {i}: logits {diff:.3g} apart, routing "
                         f"flipped in {flips} layers, router gap {gap:.2g}, "
                         f"tokens equal {tok == r.tokens[i]}, margin "
                         f"{margin:.3g}")
    text = "\n".join(lines)
    print(text, flush=True)
    (out_dir / "mixtral_routing_flips.log").write_text(text + "\n")


if __name__ == "__main__":
    main()
