"""Hot param swap in the port (``serving.ParamStore``,
``ServeEngine.maybe_swap``, ``serve(..., store=)``) against the JAX
package: twins of the hot-swap tests of tests/test_serving.py, with
params from the reference through ``convert``.

* After a swap the engine is a fresh engine on the swapped params, bit
  for bit (``last_logits`` at every decode step); its tokens equal the
  reference engine's after the same swap, its logits within 2e-5 (fp32
  sums in another order, as tests/test_torch_serving.py).
* Four swaps under varied traffic leave every param's shape, dtype and
  device as they were (the reference counts jit executables instead; the
  port compiles nothing per shape), and the tokens equal the reference's
  under the same swap schedule.
* Versions count one a publication; a ``publish_flat`` snapshot is a copy
  (mutating the source in place leaves it as it was); ``on_aggregate``
  takes the flat path when the loop gives one; readers on other threads
  only ever see whole publications.
* ``run_federated_async`` over lm16m on the batched engine publishes into
  a live engine: versions ``[1, 2, 3]``, the engine's final params bitwise
  ``hist["params"]``, the served tokens equal to the reference's e2e run,
  and the history within the plain fp32 bounds of tests/torch_fl_cases.py
  (metric 1e-5 relative, every lane within 1e-5 of its leaf's max).
* ``serve(..., store=)`` with publications mid-run (``on_tick``) gives
  the reference's swap times and every request's record and tokens.
"""
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as R
from repro.configs.lm_small import LM16M as J_LM16M
from repro.data.synthetic import split_clients, token_dataset
from repro.fl.async_loop import run_federated_async as j_run_async
from repro.fl.loop import FLConfig as JFLConfig
from repro.models import api as japi
from repro.models.split_program import get_split_program as j_program
from repro.serving import ParamStore as JParamStore
from repro.serving import ServeCosts as JServeCosts
from repro.serving import ServeEngine as JServeEngine
from repro.serving import TrafficGenerator as JTraffic
from repro.serving import serve as j_serve
from repro_torch import convert
from repro_torch.configs import qwen3_0_6b
from repro_torch.configs.lm_small import LM16M
from repro_torch.fl.async_loop import run_federated_async
from repro_torch.fl.flatbuf import FlatLayout
from repro_torch.fl.loop import FLConfig
from repro_torch.models.split_program import get_split_program
from repro_torch.serving import (
    ParamStore,
    ServeCosts,
    ServeEngine,
    TrafficGenerator,
    serve,
)
from repro_torch.tree import tree_leaves, tree_map
from torch_fl_cases import assert_same_run, one_intra_op_thread

_ = one_intra_op_thread
LOGITS_ATOL = 2e-5


def _to_port(jp):
    return convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _setup(seed=0):
    """qwen3-0.6b's smoke config in both packages; the reference's params
    of ``seed`` and the port's copy."""
    jcfg = R.get_smoke_config("qwen3-0.6b")
    jp = japi.init(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    return qwen3_0_6b.smoke_config(), _to_port(jp), jcfg, jp


def _stores(cfg, jcfg):
    """A port store and a reference store over each program's layout."""
    prog, jprog = get_split_program(cfg), j_program(jcfg)
    return (ParamStore(prog.flat_layout(prog.init(0, "cpu"))),
            JParamStore(jprog.flat_layout(jprog.init(
                jax.random.PRNGKey(0)))))


def _drain(engine, out, logits=None):
    while engine.num_active:
        for fin in engine.step():
            out[fin.rid] = fin.tokens
        if logits is not None:
            logits.append(np.asarray(engine.last_logits))


def test_post_swap_decode_bitwise_matches_fresh_engine():
    cfg, params, jcfg, jp = _setup()
    store, jstore = _stores(cfg, jcfg)
    jswapped = japi.init(jcfg, jax.random.PRNGKey(9), jnp.float32)
    swapped = _to_port(jswapped)
    layout = store.layout
    assert store.publish(swapped) == 1
    engine = ServeEngine(cfg, params, slots=2, max_prompt=8, max_seq=16)
    assert engine.maybe_swap(store) is True
    assert engine.maybe_swap(store) is False       # same version: no-op
    assert engine.params_version == 1
    fresh = ServeEngine(cfg, layout.unflatten(layout.flatten(swapped)),
                        slots=2, max_prompt=8, max_seq=16)
    jstore.publish(jswapped)
    jengine = JServeEngine(jcfg, jp, slots=2, max_prompt=8, max_seq=16)
    assert jengine.maybe_swap(jstore) is True
    prompt = (np.arange(6) % cfg.vocab_size).astype(np.int32)
    outs, logits = [{}, {}, {}], [[], [], []]
    for e, out, lg in zip((engine, fresh, jengine), outs, logits):
        assert e.submit(0, prompt, 5) is None
        _drain(e, out, lg)
    assert len(logits[0]) == 4
    for a, b in zip(logits[0], logits[1]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(logits[0], logits[2]):
        np.testing.assert_allclose(a, b, atol=LOGITS_ATOL, rtol=0)
    assert outs[0] == outs[1] == outs[2]


def _leaf_specs(params):
    return [(tuple(p.shape), p.dtype, p.device) for p in tree_leaves(params)]


def test_swaps_under_traffic_keep_shapes_and_match_reference():
    """Four swaps (params scaled by 1.01 .. 1.04), each followed by a burst
    of requests (prompts of 2, 5 or 12 tokens, 2 or 4 generated)."""
    cfg, params, jcfg, jp = _setup()
    store, jstore = _stores(cfg, jcfg)
    engine = ServeEngine(cfg, params, slots=3, max_prompt=12, max_seq=24)
    jengine = JServeEngine(jcfg, jp, slots=3, max_prompt=12, max_seq=24)
    specs = _leaf_specs(engine.params)
    rng = np.random.RandomState(0)

    def burst(rid0):
        reqs = [(rid0 + i, rng.randint(0, cfg.vocab_size,
                                       int(rng.choice([2, 5, 12])))
                 .astype(np.int32), int(rng.choice([2, 4])))
                for i in range(3)]
        outs = []
        for e in (engine, jengine):
            out = {}
            for rid, prompt, gen in reqs:
                if e.free_slots:
                    e.submit(rid, prompt, gen)
            _drain(e, out)
            outs.append(out)
        assert outs[0] == outs[1]
        return outs[0]

    served = [burst(0)]
    for i in range(4):
        scale = 1.0 + 0.01 * (i + 1)
        jscaled = jax.tree_util.tree_map(lambda p: p * scale, jp)
        store.publish(_to_port(jscaled))
        jstore.publish(jscaled)
        assert engine.maybe_swap(store) is True
        assert jengine.maybe_swap(jstore) is True
        assert _leaf_specs(engine.params) == specs
        served.append(burst(3 * (i + 1)))
    assert engine.params_version == jengine.params_version == 4
    assert sum(len(s) for s in served) == 15


def test_param_store_versions_and_flat_publish():
    cfg, params, _, _ = _setup()
    layout = get_split_program(cfg).flat_layout(params)
    store = ParamStore(layout)
    v0, flat0, _ = store.snapshot()
    assert v0 == 0 and flat0 is None
    assert store.publish(params) == 1
    g_flat = layout.flatten(tree_map(lambda p: p + 1.0, params))
    want = g_flat.clone()
    assert store.publish_flat(g_flat) == 2
    g_flat.add_(1)                                 # the loop reuses it
    v, flat, lay = store.snapshot()
    assert v == 2 and lay is layout
    assert flat is not g_flat and torch.equal(flat, want)
    # the adapter takes the flat path when the loop gives one
    store.on_aggregate(7, params, g_flat=g_flat)
    assert store.version == 3 and torch.equal(store.snapshot()[1], g_flat)
    store.on_aggregate(8, params, g_flat=None)
    assert store.version == 4
    assert torch.equal(store.snapshot()[1], layout.flatten(params))
    # an engine refuses a buffer on another device
    meta = ParamStore(layout)
    meta.publish_flat(torch.empty(layout.padded, device="meta"))
    engine = ServeEngine(cfg, params, slots=1, max_prompt=8, max_seq=16)
    with pytest.raises(ValueError, match="lies on meta"):
        engine.maybe_swap(meta)


def test_param_store_readers_see_whole_publications():
    """A publisher thread publishes buffers filled with their version while
    four reader threads snapshot: each snapshot's buffer holds its
    version's value in every lane, and the versions a reader sees never
    go back (the interpreter switches threads every 10 us)."""
    n, lanes = 200, 4096
    store = ParamStore(FlatLayout({"w": torch.zeros(lanes)}))
    errors, done = [], threading.Event()

    def publish():
        for v in range(1, n + 1):
            store.publish_flat(torch.full((lanes,), float(v)))
        done.set()

    def read():
        last = 0
        while not done.is_set() or last < n:
            v, flat, _ = store.snapshot()
            if flat is None:
                continue
            if v < last or not bool((flat == float(v)).all()):
                errors.append((v, last))
                return
            last = v

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=publish)] + [
            threading.Thread(target=read) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors and store.version == n


def test_async_training_publishes_into_live_engine():
    """The reference's e2e test in both packages, from the reference's
    initial params: each aggregation is published, adopted by a live
    engine and served one request."""
    clients = split_clients(token_dataset(16, 32, LM16M.vocab_size, seed=0),
                            2)
    test = token_dataset(4, 32, LM16M.vocab_size, seed=9)
    kw = dict(rounds=3, local_iters=1, batch_size=4, mode="sfl",
              static_op=3, engine="batched", seed=0)
    jprog = j_program(J_LM16M)
    jinit = jprog.init(jax.random.PRNGKey(0))
    init = _to_port(jinit)
    prompt = (np.arange(5) * 13 % LM16M.vocab_size).astype(np.int32)

    def live(store, engine):
        served = []

        def hook(version, params, g_flat=None):
            store.on_aggregate(version, params, g_flat=g_flat)
            assert engine.maybe_swap(store)
            out = {}
            assert engine.submit(version, prompt, 3) is None
            _drain(engine, out)
            served.append((engine.params_version, out[version]))
        return served, hook

    jstore = JParamStore(jprog.flat_layout(jinit))
    jengine = JServeEngine(J_LM16M, jinit, slots=2, max_prompt=8, max_seq=12)
    jserved, jhook = live(jstore, jengine)
    jh = j_run_async(J_LM16M, clients, test, JFLConfig(**kw),
                     on_aggregate=jhook)
    store = ParamStore(get_split_program(LM16M).flat_layout(init))
    engine = ServeEngine(LM16M, init, slots=2, max_prompt=8, max_seq=12)
    served, hook = live(store, engine)
    th = run_federated_async(LM16M, clients, test, FLConfig(**kw),
                             on_aggregate=hook,
                             init_params=jax.tree_util.tree_map(np.asarray,
                                                                jinit),
                             device="cpu")
    assert [v for v, _ in served] == [1, 2, 3]
    assert engine.params_version == 3
    for a, b in zip(tree_leaves(engine.params), tree_leaves(th["params"])):
        assert torch.equal(a, b)
    assert served == jserved
    print(assert_same_run(th, jh, False, "lm16m async e2e",
                          keys=("ops", "round_time", "comm_time", "dropped",
                                "virtual_time", "staleness")))


def test_serve_with_store_matches_reference():
    """Seeded Poisson traffic through two slots, a publication at every
    tick past virtual second 1.5 (each of scaled params), the costs of a
    prefill, a decode step and a swap pinned."""
    cfg, params, jcfg, jp = _setup()
    kw = dict(rate=1.5, n_requests=8, vocab_size=cfg.vocab_size,
              prompt_lens=(3, 6, 12), gen_lens=(1, 3, 6), seed=4)
    store, jstore = _stores(cfg, jcfg)
    scaled = [jax.tree_util.tree_map(lambda p, s=s: p * s, jp)
              for s in (1.02, 1.04, 1.06, 1.08, 1.1)]
    scaled_port = [_to_port(p) for p in scaled]

    def ticker(st, versions):
        def on_tick(now):
            if now > 1.5 and st.version < len(versions):
                st.publish(versions[st.version])
        return on_tick

    res = serve(ServeEngine(cfg, params, slots=2, max_prompt=12,
                            max_seq=24),
                TrafficGenerator(**kw).generate(),
                ServeCosts(prefill=0.4, decode=0.2, swap=0.1), store=store,
                on_tick=ticker(store, scaled_port))
    jres = j_serve(JServeEngine(jcfg, jp, slots=2, max_prompt=12,
                                max_seq=24),
                   JTraffic(**kw).generate(),
                   JServeCosts(prefill=0.4, decode=0.2, swap=0.1),
                   store=jstore, on_tick=ticker(jstore, scaled))
    assert len(res["swaps"]) == 5
    assert res["swaps"] == jres["swaps"]
    for key in ("makespan", "decode_steps"):
        assert res[key] == jres[key], key
    for key in ("occupancy", "queue_depth"):
        np.testing.assert_array_equal(res[key], jres[key])
    for r, j in zip(res["requests"], jres["requests"]):
        assert (r.rid, r.t_admit, r.t_first, r.t_done, r.tokens) == \
            (j.rid, j.t_admit, j.t_first, j.t_done, j.tokens)
