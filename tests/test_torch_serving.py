"""The port's serving path against the JAX reference: twins of
tests/test_serving.py over the port's ``ServeEngine``, plus cross-checks
with the reference's engine, traffic, event queue and serve driver.

Params come from the reference's ``api.init`` through ``convert``.  The
equivalences:

* a slot pool decoding staggered requests (mid-decode admissions, slot
  reuse) gives each request the tokens of the port's sequential oracle;
* the port's engine gives the reference engine's tokens, and its
  ``last_logits`` within 2e-5 (fp32 sums in another order; see
  tests/test_torch_transformer.py), for the same params and requests;
* ``TrafficGenerator`` and ``EventQueue`` are exact copies;
* ``launch.serve.main`` on lm16m gives the reference driver's tokens.

mixtral-8x22b (MoE) serves at capacity factor 8.0, as in the reference's
tests/test_serving.py: the engine prefills prompts padded to
``max_prompt`` and the oracle prefills them unpadded, so at the configs'
1.25 the two would drop different tokens.  Its smoke window is 32, so
prompts stay within 30 tokens and requests that run past 32 positions
wrap the rolling cache.  The hot-swap twins are in
tests/test_torch_hotswap.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import registry as R
from repro.launch import serve as j_launch
from repro.models import api as japi
from repro.runtime.scheduler import EventQueue as JEventQueue
from repro.serving import ServeEngine as JServeEngine
from repro.serving import TrafficGenerator as JTraffic
from repro_torch import convert
from repro_torch.configs import gemma2_2b, mixtral_8x22b, qwen3_0_6b
from repro_torch.launch import serve as t_launch
from repro_torch.runtime.scheduler import EventQueue
from repro_torch.serving import (
    ServeCosts,
    ServeEngine,
    TrafficGenerator,
    latency_stats,
    reference_decode,
    serve,
)

_CONFIGS = {"qwen3-0.6b": qwen3_0_6b.smoke_config,
            "gemma2-2b": gemma2_2b.smoke_config,
            "mixtral-8x22b": mixtral_8x22b.smoke_config}
# prompt lengths and max_prompt a test's engine takes per arch (mixtral's
# rolling cache is its window, 32 slots)
_PROMPTS = {"qwen3-0.6b": (3, 12, 40), "gemma2-2b": (3, 12, 40),
            "mixtral-8x22b": (3, 12, 30)}
_SETUPS = {}


def _no_drops(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def _setup(arch="qwen3-0.6b", seed=0):
    """(port cfg, port params, reference cfg, reference params)."""
    if (arch, seed) not in _SETUPS:
        jcfg = _no_drops(R.get_smoke_config(arch))
        jp = japi.init(jcfg, jax.random.PRNGKey(seed), jnp.float32)
        tp = convert.lm_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        _SETUPS[arch, seed] = (_no_drops(_CONFIGS[arch]()), tp, jcfg, jp)
    return _SETUPS[arch, seed]


def _requests(cfg, n=8, seed=1, lens=(3, 7, 12), gens=(1, 2, 5, 8)):
    rng = np.random.RandomState(seed)
    return [(rid, rng.randint(0, cfg.vocab_size, int(rng.choice(lens)))
             .astype(np.int32), int(rng.choice(gens))) for rid in range(n)]


def _run_staggered(engine, reqs, on_step=None):
    """Admit at most one request per decode step, so arrivals stagger
    mid-decode and slots are reused."""
    out, pending = {}, list(reqs)
    while pending or engine.num_active:
        if pending and engine.free_slots > 0:
            rid, prompt, gen = pending.pop(0)
            fin = engine.submit(rid, prompt, gen)
            if fin is not None:
                out[fin.rid] = fin.tokens
        for fin in engine.step():
            out[fin.rid] = fin.tokens
        if on_step is not None:
            on_step(engine)
    return out


# =============================================================================
# continuous batching == sequential single-request decoding
# =============================================================================
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-2b",
                                  "mixtral-8x22b"])
def test_continuous_batching_matches_sequential(arch):
    """Prompts up to 40 tokens: gemma2's local layers (smoke window 32)
    mask in the prefill and in the decode; mixtral's 30-token prompts with
    8 generated wrap its 32-slot rolling cache."""
    cfg, params, _, _ = _setup(arch)
    lens = _PROMPTS[arch]
    engine = ServeEngine(cfg, params, slots=3, max_prompt=lens[-1],
                         max_seq=52)
    reqs = _requests(cfg, lens=lens)
    if cfg.moe is not None:
        assert engine.CL == 32 and any(
            len(p) + g > engine.CL + 1 for _, p, g in reqs)
    out = _run_staggered(engine, reqs)
    assert len(out) == len(reqs)
    for rid, prompt, gen in reqs:
        ref = reference_decode(cfg, params, prompt, gen)
        assert out[rid] == ref, f"{arch} rid={rid}: {out[rid]} != {ref}"
        assert len(out[rid]) == gen


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-2b",
                                  "mixtral-8x22b"])
def test_engine_matches_reference_engine(arch):
    """The same params and requests through both packages' engines: the
    same tokens, and the same logits at every decode step within 2e-5."""
    cfg, params, jcfg, jp = _setup(arch)
    lens = _PROMPTS[arch]
    reqs = _requests(cfg, n=6, seed=2, lens=lens, gens=(2, 5, 8))
    logits = []
    out = _run_staggered(
        ServeEngine(cfg, params, slots=3, max_prompt=lens[-1], max_seq=52),
        reqs, lambda e: logits.append(e.last_logits))
    j_logits = []
    j_out = _run_staggered(
        JServeEngine(jcfg, jp, slots=3, max_prompt=lens[-1], max_seq=52),
        reqs, lambda e: j_logits.append(e.last_logits))
    assert out == j_out
    assert len(logits) == len(j_logits)
    for a, b in zip(logits, j_logits):
        if b is None:
            assert a is None
        else:
            np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-5)


def test_serve_loop_matches_sequential_and_is_deterministic():
    """The virtual-clock serve loop (Poisson traffic, admission queue) is
    token-for-token sequential-equivalent, and bitwise repeatable."""
    cfg, params, _, _ = _setup()
    traffic = TrafficGenerator(rate=1.5, n_requests=10,
                               vocab_size=cfg.vocab_size,
                               prompt_lens=(3, 6, 12), gen_lens=(1, 3, 6),
                               seed=3)
    costs = ServeCosts(prefill=0.4, decode=0.2, swap=0.0)

    def one_run():
        engine = ServeEngine(cfg, params, slots=2, max_prompt=12, max_seq=24)
        return serve(engine, traffic.generate(), costs)

    res = one_run()
    for r in res["requests"]:
        assert r.tokens == reference_decode(cfg, params, r.prompt, r.gen)
        assert r.t_admit >= r.arrival and r.t_done >= r.t_first > r.t_admit
    stats = latency_stats(res)
    res2 = one_run()
    assert latency_stats(res2) == stats
    assert [r.tokens for r in res2["requests"]] == \
        [r.tokens for r in res["requests"]]
    assert stats["tokens"] == sum(r.gen for r in res["requests"])


def test_gen_one_finishes_at_prefill():
    cfg, params, _, _ = _setup()
    engine = ServeEngine(cfg, params, slots=2, max_prompt=8, max_seq=16)
    fin = engine.submit(5, np.arange(4, dtype=np.int32), 1)
    assert fin is not None and fin.rid == 5 and len(fin.tokens) == 1
    assert engine.num_active == 0                  # no slot consumed
    assert fin.tokens == reference_decode(cfg, params, np.arange(4), 1)


def test_engine_validation():
    cfg, params, _, _ = _setup()
    engine = ServeEngine(cfg, params, slots=1, max_prompt=8, max_seq=16)
    with pytest.raises(ValueError, match="prompt length"):
        engine.submit(0, np.zeros(9, np.int32), 2)
    with pytest.raises(ValueError, match="max_seq"):
        engine.submit(0, np.zeros(8, np.int32), 9)
    engine.submit(0, np.zeros(4, np.int32), 4)
    with pytest.raises(RuntimeError, match="free slot"):
        engine.submit(1, np.zeros(4, np.int32), 4)
    with pytest.raises(ValueError, match="max_prompt"):
        ServeEngine(cfg, params, slots=1, max_prompt=32, max_seq=16)
    ssm = dataclasses.replace(cfg, family="ssm")
    with pytest.raises(NotImplementedError, match="families"):
        ServeEngine(ssm, None)


def test_reference_decode_margins():
    """The oracle's top-2 margins (what chip_smoke's comparison rule reads)
    are the logits' own top-2 gaps, one per generated token."""
    cfg, params, _, _ = _setup()
    prompt = np.arange(5, dtype=np.int32)
    toks, margins = reference_decode(cfg, params, prompt, 4,
                                     return_margins=True)
    assert toks == reference_decode(cfg, params, prompt, 4)
    assert len(margins) == 4 and all(m >= 0 for m in margins)


def _chip_smoke():
    import importlib
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-2b",
                                  "mixtral-8x22b"])
def test_chip_smoke_stepwise_oracle(arch, monkeypatch):
    """chip_smoke's per-step serving check on the CPU: ``oracle_steps``
    gives ``reference_decode``'s tokens and margins; the rows that
    ``capture_engine_rows`` keeps from a ``serve`` run are each request's
    decode logits (every step but the prefill's), and
    ``check_against_oracle`` holds them within STEPWISE_TOL of the
    oracle's and refuses a row moved by 1e-3.  For mixtral the oracle's
    router gaps (``router_gaps``) end the logits' prefix at the first one
    below ROUTER_MARGIN: none at 1e-9, the first decode step at 10."""
    import torch

    from repro_torch.models import layers as L
    cs = _chip_smoke()
    cfg, params, _, _ = _setup(arch)
    lens = _PROMPTS[arch]
    engine = ServeEngine(cfg, params, slots=3, max_prompt=lens[-1],
                         max_seq=52)
    rows = {}
    cs.capture_engine_rows(engine, rows)
    traffic = TrafficGenerator(rate=1.5, n_requests=6,
                               vocab_size=cfg.vocab_size, prompt_lens=lens,
                               gen_lens=(1, 5, 8), seed=4)
    res = serve(engine, traffic.generate(), ServeCosts(prefill=0.4,
                                                       decode=0.2))
    assert sorted(rows) == sorted((r.rid, i) for r in res["requests"]
                                  for i in range(1, r.gen))
    gaps = None
    if cfg.moe is not None:
        gaps = []
        monkeypatch.setattr(L, "moe_route", L.moe_route)
        cs.router_gaps(torch, L, gaps)
    first = next(r for r in res["requests"] if r.gen > 1)
    for r in res["requests"]:
        toks, margins = reference_decode(cfg, params, r.prompt, r.gen,
                                         return_margins=True)
        steps = list(cs.oracle_steps(torch, cfg, params, r.prompt, r.gen))
        assert [t for t, _, _ in steps] == toks
        assert [m for _, m, _ in steps] == margins
        if r is first:
            moved = {k: v.copy() for k, v in rows.items() if k[0] == r.rid}
            moved[r.rid, 1][0] += 1e-3
            with pytest.raises(SystemExit):
                cs.check_against_oracle(torch, cfg, params, r, moved, arch,
                                        gaps)
            if gaps is not None:
                monkeypatch.setattr(cs, "ROUTER_MARGIN", 10.0)
                n, m, diff, _, _ = cs.check_against_oracle(
                    torch, cfg, params, r, dict(moved), arch, gaps)
                assert n >= 1 and (m, diff) == (0, 0.0)
                monkeypatch.setattr(cs, "ROUTER_MARGIN", 1e-9)
        n, m, diff, ref, _ = cs.check_against_oracle(torch, cfg, params, r,
                                                     rows, arch, gaps)
        assert ref == toks and n >= 1 and diff < cs.STEPWISE_TOL
        assert m == n - 1
    assert not rows


# =============================================================================
# exact copies: traffic, event queue, serve driver
# =============================================================================
@pytest.mark.parametrize("seed,rate,plens,glens", [
    (7, 2.0, (4, 8, 16), (2, 4, 8)),
    (0, 0.5, (600, 2100, 4500), (8, 16, 32)),
])
def test_traffic_generator_equals_reference(seed, rate, plens, glens):
    kw = dict(rate=rate, n_requests=12, vocab_size=256000, prompt_lens=plens,
              gen_lens=glens, seed=seed)
    mine, ref = TrafficGenerator(**kw).generate(), JTraffic(**kw).generate()
    assert [(r.rid, r.arrival, r.gen) for r in mine] == \
        [(r.rid, r.arrival, r.gen) for r in ref]
    for a, b in zip(mine, ref):
        assert a.prompt.dtype == b.prompt.dtype
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_event_queue_equals_reference():
    """Ties pop in push order; advance, peek, unreachable events."""
    script = [("push", 1.0, "a"), ("push", 0.5, "b"), ("push", 1.0, "c"),
              ("push", float("inf"), "dead"), ("advance", 0.25),
              ("pop",), ("push", 1.0, "d"), ("peek",), ("pop",), ("pop",),
              ("drop",), ("advance", 2.0), ("pop",), ("peek",)]
    logs = []
    for q in (EventQueue(), JEventQueue()):
        log = []
        for op in script:
            if op[0] == "push":
                q.push(op[1], op[2])
            elif op[0] == "advance":
                log.append(q.advance(op[1]))
            elif op[0] == "pop":
                log.append(q.pop())
            elif op[0] == "peek":
                log.append(q.peek_time())
            else:
                log.append(q.drop_unreachable())
            log.append((q.now, len(q)))
        logs.append(log)
    assert logs[0] == logs[1]
    for q in (EventQueue(), JEventQueue()):
        with pytest.raises(ValueError, match="finite"):
            q.advance(-0.1)
        with pytest.raises(IndexError):
            q.pop()


def test_launch_serve_matches_reference_driver():
    """``main`` on lm16m with the reference driver's weights (the reference
    draws them from ``--seed`` with threefry; they are passed across)."""
    argv = ["--arch", "lm16m", "--batch", "2", "--prompt-len", "12",
            "--gen", "4", "--seed", "3"]
    from repro.configs.lm_small import LM16M
    jp = japi.init(LM16M, jax.random.PRNGKey(3))
    tp = convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    want = j_launch.main(argv)
    got = t_launch.main(argv, device="cpu", params=tp)
    assert got.dtype == np.int32 and got.shape == (2, 4)
    np.testing.assert_array_equal(got, np.asarray(want))
