"""The two-tier server in the port against the JAX package's: twins of the
edge, root and edge-hop tests of tests/test_hierarchy.py on the same numpy
inputs, a toy parameter tree (three leaves over two layers, 1,632
entries).

* ``assign_edges``, ``RoundClock.edge_hop_times`` and the width-scaled
  ``RoundClock.times`` are exact (numpy arithmetic on identical inputs).
* One edge is the flat step bit for bit, in every mode, masked or not:
  ``hierarchical_apply`` runs the flat step itself and never the root.
* Two and three edges match the reference's per-client oracle
  (``reference_server_step``) within 1e-5 on the params and 1e-6 on the EF
  rows: every edge normalizes its weights by its own mass and the root
  re-weights the edges, so the sums run in another fp32 order (observed:
  2.4e-7 on the params, the EF rows equal).
* ``ServerStep.reduce`` and ``RootStep`` against the reference's: within
  1e-6.
* Whole runs against the reference's (K=4, sfl at OP2, 3 rounds of 2
  local iterations, widths (0.25, 0.5, 1.0, 1.0), two edges, an
  ``edge_transport`` of 50 and 10 Mbit/s): OPs, times, comm, drops and
  ``edge_time`` exact, accuracy within one test sample; params within
  1e-3 with the int8 cut, top-k 0.25 and int8 deltas (the discrete-step
  atol of tests/test_torch_loop.py; observed 6.9e-4), 1e-5 for the plain
  async runs (two edges on either engine, and the masked per-leaf
  reference step; observed 6.0e-8 in each).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.vgg import VGG5 as J_VGG5
from repro.core.env import SimulatedCluster as JSim
from repro.core.testbed import paper_testbed as j_testbed
from repro.fl.async_loop import run_federated_async as j_run_async
from repro.fl.comm import Transport as JTransport
from repro.fl.comm import device_bandwidths as j_bw
from repro.fl.comm import indexed_bandwidths as j_indexed_bandwidths
from repro.fl.flatbuf import RootStep as JRootStep
from repro.fl.flatbuf import ServerStep as JServerStep
from repro.fl.flatbuf import layout_of as j_layout_of
from repro.fl.flatbuf import reference_server_step as j_reference_step
from repro.fl.hierarchy import assign_edges as j_assign_edges
from repro.fl.loop import FLConfig as JFLConfig
from repro.fl.loop import RoundClock as JRoundClock
from repro.fl.loop import run_federated as j_run
from repro.models.split_program import get_split_program as j_program
from repro_torch.configs.vgg import VGG5
from repro_torch.convert import vgg_params_from_numpy, vgg_params_to_numpy
from repro_torch.core.env import SimulatedCluster
from repro_torch.core.testbed import paper_testbed
from repro_torch.data import make_cifar_like, split_clients
from repro_torch.fl.async_loop import run_federated_async
from repro_torch.fl.comm import (Transport, device_bandwidths,
                                 indexed_bandwidths)
from repro_torch.fl.fedavg import model_bytes
from repro_torch.fl.flatbuf import (FlatLayout, RootStep, ServerStep,
                                    get_root_step)
from repro_torch.fl.hierarchy import (EdgeAggregator, assign_edges,
                                      hierarchical_apply)
from repro_torch.fl.loop import FLConfig, RoundClock, run_federated
from repro_torch.models.split_program import get_split_program
from repro_torch.tree import tree_leaves

MODES = [(1.0, False), (1.0, True), (0.05, False), (0.05, True)]
WEIGHTS = [3.0, 1.0, 2.0, 1.0, 4.0, 2.0]
TOY_WIDTHS = [0.25, 1.0, 0.5, 0.5, 1.0, 0.25]
WIDTHS = (0.25, 0.5, 1.0, 1.0)
EDGE_BPS = [50e6, 10e6]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# =============================================================================
# the toy tree: six clients' deltas, EF rows and nested prefix masks
# =============================================================================
@pytest.fixture(scope="module")
def toy():
    rng = np.random.RandomState(1)
    g = [{"a": rng.randn(1500).astype(np.float32)},
         {"b": rng.randn(100).astype(np.float32),
          "c": rng.randn(4, 8).astype(np.float32)}]
    jl = j_layout_of(jax.tree_util.tree_map(jnp.asarray, g))
    tg = [{k: torch.from_numpy(v) for k, v in layer.items()} for layer in g]
    tl = FlatLayout(tg)
    assert (tl.padded, tl.offsets) == (jl.padded, jl.offsets)
    K = len(WEIGHTS)
    # each leaf keeps its first ceil(w * n) entries: nested, as width
    # masks are; padding lanes are 0
    masks = np.zeros((K, tl.padded), np.float32)
    for i, w in enumerate(TOY_WIDTHS):
        for off, sz in zip(tl.offsets, tl.sizes):
            masks[i, off:off + int(np.ceil(w * sz))] = 1.0
    live = (tl.flatten(tg).numpy() != 0).astype(np.float32)
    deltas = (rng.randn(K, tl.padded) * 0.1).astype(np.float32) * live
    errors = np.stack([0.01 * (i + 1) * live for i in range(K)]
                      ).astype(np.float32)
    return dict(g=g, tg=tg, jl=jl, tl=tl, deltas=deltas, errors=errors,
                masks=masks)


def _inputs(toy, density, masked):
    """Port operands: (g_flat, deltas, errors or None, masks or None); the
    deltas and EF rows carried masked, as the loops give them."""
    m = toy["masks"] if masked else np.ones_like(toy["masks"])
    d = toy["deltas"] * m
    e = toy["errors"] * m if density < 1 else None
    return (toy["tl"].flatten(toy["tg"]), torch.from_numpy(d),
            None if e is None else torch.from_numpy(e),
            torch.from_numpy(toy["masks"]) if masked else None)


@pytest.fixture(scope="module")
def oracle(toy):
    """The reference's per-client oracle on the toy, once per mode."""
    cache = {}

    def get(density, quantize, masked):
        key = (density, quantize, masked)
        if key not in cache:
            _, d, e, m = _inputs(toy, density, masked)
            jl = toy["jl"]
            p, err = j_reference_step(
                jl, jax.tree_util.tree_map(jnp.asarray, toy["g"]),
                [jl.unflatten(jnp.asarray(r.numpy())) for r in d], WEIGHTS,
                None if e is None else jnp.asarray(e.numpy()),
                density=density, quantize=quantize,
                masks=None if m is None else jnp.asarray(m.numpy()))
            cache[key] = (np.asarray(jl.flatten(p)),
                          None if err is None else np.asarray(err))
        return cache[key]
    return get


@pytest.mark.parametrize("count,edges", [(7, 3), (4, 4), (10, 1), (3, 8),
                                         (0, 3), (6, 2)])
def test_assign_edges_is_the_reference(count, edges):
    got, want = assign_edges(count, edges), j_assign_edges(count, edges)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="num_edges"):
        assign_edges(5, 0)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("density,quantize", MODES)
def test_single_edge_is_bitwise_the_flat_step(toy, density, quantize,
                                              masked):
    g, d, e, m = _inputs(toy, density, masked)
    step = ServerStep(toy["tl"], density, quantize)
    root = RootStep(toy["tl"].padded)
    want_g, want_e = step(g, d, WEIGHTS, e, masks=m)
    got_g, got_e, used = hierarchical_apply(step, root, g, d, WEIGHTS, e, m,
                                            num_edges=1)
    assert used == 1 and root.calls == 0
    assert torch.equal(got_g.view(torch.int32), want_g.view(torch.int32))
    if e is not None:
        assert torch.equal(got_e.view(torch.int32), want_e.view(torch.int32))
    else:
        assert got_e is None and want_e is None


@pytest.mark.parametrize("num_edges", [2, 3])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("density,quantize", MODES)
def test_tiered_matches_reference_oracle(toy, oracle, density, quantize,
                                         masked, num_edges):
    g, d, e, m = _inputs(toy, density, masked)
    want_g, want_e = oracle(density, quantize, masked)
    root = get_root_step(toy["tl"])
    calls = root.calls
    got_g, got_e, used = hierarchical_apply(
        ServerStep(toy["tl"], density, quantize), root, g, d, WEIGHTS, e, m,
        num_edges=num_edges)
    assert used == num_edges and root.calls == calls + 1
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0, atol=1e-5)
    if e is not None:
        # the EF rows in the caller's survivor order
        np.testing.assert_allclose(got_e.numpy(), want_e, rtol=0, atol=1e-6)
    else:
        assert got_e is None and want_e is None
    if masked:
        uncovered = (np.asarray(WEIGHTS, np.float32) @ toy["masks"]) == 0
        assert uncovered.any()
        np.testing.assert_array_equal(got_g.numpy()[uncovered],
                                      g.numpy()[uncovered])


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("density,quantize", MODES)
def test_reduce_and_root_match_reference(toy, density, quantize, masked):
    g, d, e, m = _inputs(toy, density, masked)
    parts = assign_edges(len(WEIGHTS), 2)
    jstep = JServerStep(toy["jl"], density, quantize)
    step = ServerStep(toy["tl"], density, quantize)
    nums, dens, jnums, jdens, masses = [], [], [], [], []
    for pos in parts:
        w = [WEIGHTS[i] for i in pos]
        idx = torch.as_tensor(pos)
        upd = EdgeAggregator(0, step).aggregate(
            d[idx], w, None if e is None else e[idx],
            None if m is None else m[idx])
        ja, jd, je = jstep.reduce(
            jnp.asarray(d[idx].numpy()), w,
            None if e is None else jnp.asarray(e[idx].numpy()),
            None if m is None else jnp.asarray(m[idx].numpy()))
        np.testing.assert_allclose(upd.num.numpy(), np.asarray(ja), rtol=0,
                                   atol=1e-6)
        assert (upd.den is None) == (jd is None) == (not masked)
        if masked:
            np.testing.assert_allclose(upd.den.numpy(), np.asarray(jd),
                                       rtol=0, atol=1e-6)
        if e is not None:
            np.testing.assert_allclose(upd.new_err.numpy(), np.asarray(je),
                                       rtol=0, atol=1e-6)
        assert upd.members == len(pos) and upd.weight == sum(w)
        nums.append(upd.num)
        dens.append(upd.den)
        jnums.append(ja)
        jdens.append(jd)
        masses.append(upd.weight)
    got = RootStep(toy["tl"].padded)(
        g, torch.stack(nums), masses,
        torch.stack(dens) if masked else None)
    want = JRootStep(toy["jl"])(
        jnp.asarray(g.numpy()), jnp.stack(jnums), masses,
        jnp.stack(jdens) if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


# =============================================================================
# the clock: edge hops and width-scaled compute
# =============================================================================
@pytest.fixture(scope="module")
def vgg5():
    jparams = jax.tree_util.tree_map(
        np.asarray, j_program(J_VGG5).init(jax.random.PRNGKey(0)))
    return jparams, vgg_params_from_numpy(jparams, device="cpu")


def _clocks(vgg5, transport, sim, scale, edge_bps, K=4):
    jparams, tparams = vgg5
    jw, jdev, jsrv, jovh = j_testbed(J_VGG5)
    tw, tdev, tsrv, tovh = paper_testbed(VGG5)
    jfl, tfl = JFLConfig(local_iters=2, batch_size=10), \
        FLConfig(local_iters=2, batch_size=10)
    jsim = tsim = None
    if sim:
        jsim = JSim(jw, jdev[:K], jsrv, J_VGG5.ops, iterations=2,
                    jitter=0.05, seed=3, overhead_s=jovh)
        tsim = SimulatedCluster(tw, tdev[:K], tsrv, VGG5.ops, iterations=2,
                                jitter=0.05, seed=3, overhead_s=tovh)
    jet = (JTransport(j_indexed_bandwidths(edge_bps), latency_s=0.01)
           if edge_bps else None)
    tet = (Transport(indexed_bandwidths(edge_bps), latency_s=0.01)
           if edge_bps else None)
    jc = JRoundClock(j_program(J_VGG5), jfl, K, None, jparams, sim=jsim,
                     transport=(JTransport(j_bw(jdev[:K])) if transport
                                else None),
                     compute_scale=scale, edge_transport=jet)
    tc = RoundClock(get_split_program(VGG5), tfl, K, tparams, sim=tsim,
                    transport=(Transport(device_bandwidths(tdev[:K]))
                               if transport else None),
                    compute_scale=scale, edge_transport=tet)
    return jc, tc


@pytest.mark.parametrize("edge_bps", [None, EDGE_BPS, [40e6, 0.0, 5e6]],
                         ids=["free", "two-edges", "dead-edge"])
def test_edge_hop_times_are_the_reference(vgg5, edge_bps):
    jc, tc = _clocks(vgg5, True, True, None, edge_bps)
    for edges in range(len(edge_bps or [0] * 3) + 1):
        for r in (0, 3):
            got = tc.edge_hop_times(edges, r)
            np.testing.assert_array_equal(got, jc.edge_hop_times(edges, r))
            assert len(got) == edges
    if edge_bps == EDGE_BPS:
        mb = model_bytes(vgg5[1])
        np.testing.assert_allclose(tc.edge_hop_times(2, 0),
                                   [0.02 + 2 * mb * 8 / b for b in EDGE_BPS],
                                   rtol=1e-12)


@pytest.mark.parametrize("transport,sim", [(True, True), (False, True),
                                           (False, False), (True, False)])
def test_width_scaled_times_are_the_reference(vgg5, transport, sim):
    scale = np.square(WIDTHS)
    jc, tc = _clocks(vgg5, transport, sim, scale, None)
    for ops in ([1, 2, 3, 4], [4, 4, 1, 2]):
        for r in (0, 2):
            got, comm = tc.times(ops, r)
            want, jcomm = jc.times(ops, r)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(comm, jcomm)


# =============================================================================
# whole runs
# =============================================================================
def _fl(**kw):
    base = dict(rounds=3, local_iters=2, batch_size=10, mode="sfl",
                static_op=2, augment=False, seed=0)
    base.update(kw)
    return base


def _mini():
    return (split_clients(make_cifar_like(120, seed=0), 4),
            make_cifar_like(40, seed=9))


def _sims():
    jw, jdev, jsrv, jovh = j_testbed(J_VGG5)
    tw, tdev, tsrv, tovh = paper_testbed(VGG5)
    return (dict(sim=JSim(jw, jdev[:4], jsrv, J_VGG5.ops, iterations=2,
                          jitter=0.05, seed=3, overhead_s=jovh),
                 transport=JTransport(j_bw(jdev[:4]))),
            dict(sim=SimulatedCluster(tw, tdev[:4], tsrv, VGG5.ops,
                                      iterations=2, jitter=0.05, seed=3,
                                      overhead_s=tovh),
                 transport=Transport(device_bandwidths(tdev[:4]))))


def _assert_params(th, jh, atol):
    for tl, jl in zip(vgg_params_to_numpy(th["params"]), jh["params"]):
        for k in tl:
            np.testing.assert_allclose(tl[k], np.asarray(jl[k]), rtol=0,
                                       atol=atol, err_msg=k)


def test_two_edge_hetero_run_matches_reference(vgg5):
    """Widths, two edges and an edge hop, with the int8 cut, top-k 0.25
    and int8 deltas."""
    kw = _fl(client_widths=WIDTHS, num_edges=2, delta_density=0.25,
             quantize_deltas=True, quantize_transfer=True)
    clients, test = _mini()
    jkw, tkw = _sims()
    jh = j_run(J_VGG5, clients, test, JFLConfig(**kw),
               edge_transport=JTransport(j_indexed_bandwidths(EDGE_BPS)),
               **jkw)
    th = run_federated(VGG5, clients, test, FLConfig(**kw),
                       edge_transport=Transport(indexed_bandwidths(EDGE_BPS)),
                       init_params=vgg5[0], device="cpu", **tkw)
    for key in ("ops", "times", "round_time", "comm_time", "dropped",
                "edge_time"):
        np.testing.assert_array_equal(th[key], jh[key], err_msg=key)
    assert (th["edge_time"] > 0).all()
    # one test sample of 40, and the fp32 rounding of the two means
    assert np.all(np.abs(th["accuracy"] - jh["accuracy"]) <= 1 / 40 + 1e-6)
    _assert_params(th, jh, 1e-3)


@pytest.mark.parametrize("over", [
    dict(num_edges=2), dict(num_edges=2, engine="batched"),
    dict(server_step="reference")],
    ids=["edges2", "edges2-batched", "reference-step"])
def test_async_hetero_edges_match_reference(vgg5, over):
    """The async runtime with widths (buffer 2, discount 0.5, 4
    aggregations, plain averaging): two edges and an edge hop on either
    engine, and the masked per-leaf reference step."""
    kw = _fl(client_widths=WIDTHS, buffer_size=2, staleness_discount=0.5,
             rounds=4, **over)
    clients, test = _mini()
    jkw, tkw = _sims()
    jh = j_run_async(J_VGG5, clients, test, JFLConfig(**kw),
                     edge_transport=JTransport(j_indexed_bandwidths(
                         EDGE_BPS)), **jkw)
    th = run_federated_async(
        VGG5, clients, test, FLConfig(**kw),
        edge_transport=Transport(indexed_bandwidths(EDGE_BPS)),
        init_params=vgg5[0], device="cpu", **tkw)
    for key in ("ops", "times", "comm_time", "virtual_time", "staleness",
                "dropped", "agg_weight_sum", "round_time", "edge_time"):
        np.testing.assert_array_equal(th[key], jh[key], err_msg=key)
    assert (th["edge_time"] > 0).all() == (over.get("num_edges", 0) > 0)
    assert np.all(np.abs(th["accuracy"] - jh["accuracy"]) <= 1 / 40 + 1e-6)
    _assert_params(th, jh, 1e-5)


@pytest.mark.parametrize("over", [dict(), dict(
    client_widths=WIDTHS, delta_density=0.25, quantize_deltas=True)],
    ids=["plain", "hetero-topk-int8"])
def test_single_edge_run_is_bitwise_the_flat_run(vgg5, over):
    clients, test = _mini()
    flat = run_federated(VGG5, clients, test, FLConfig(**_fl(**over)),
                         init_params=vgg5[0], device="cpu")
    tiered = run_federated(VGG5, clients, test,
                           FLConfig(**_fl(**over, num_edges=1)),
                           init_params=vgg5[0], device="cpu")
    for key in ("accuracy", "ops", "dropped", "round_time", "times"):
        np.testing.assert_array_equal(flat[key], tiered[key], err_msg=key)
    for a, b in zip(tree_leaves(flat["params"]),
                    tree_leaves(tiered["params"])):
        assert torch.equal(a, b)
    assert (tiered["edge_time"] == 0).all() and \
        (flat["edge_time"] == 0).all()


def test_edge_hop_charged_per_edge_hand_computed(vgg5):
    clients, test = _mini()
    fl = FLConfig(**_fl(cohort_size=4, num_edges=2))
    free = run_federated(VGG5, clients, test, fl, init_params=vgg5[0],
                         device="cpu")
    paid = run_federated(VGG5, clients, test, fl, init_params=vgg5[0],
                         device="cpu", edge_transport=Transport(
                             indexed_bandwidths(EDGE_BPS)))
    # the hop changes the accounting only
    np.testing.assert_array_equal(free["accuracy"], paid["accuracy"])
    mb = model_bytes(paid["params"])
    expected = max(2 * mb * 8.0 / bw for bw in EDGE_BPS)
    np.testing.assert_allclose(paid["edge_time"], [expected] * 3, rtol=1e-9)
    np.testing.assert_allclose(paid["round_time"],
                               free["round_time"] + expected, rtol=1e-9)
    assert (free["edge_time"] == 0).all()


def test_async_edge_hop_reported_not_clocked(vgg5):
    clients, test = _mini()
    fl = FLConfig(**_fl(num_edges=2, buffer_size=2))
    free = run_federated_async(VGG5, clients, test, fl, init_params=vgg5[0],
                               device="cpu")
    paid = run_federated_async(VGG5, clients, test, fl, init_params=vgg5[0],
                               device="cpu", edge_transport=Transport(
                                   indexed_bandwidths([40e6, 40e6])))
    np.testing.assert_array_equal(free["virtual_time"], paid["virtual_time"])
    mb = model_bytes(paid["params"])
    np.testing.assert_allclose(paid["edge_time"], [2 * mb * 8.0 / 40e6] * 3,
                               rtol=1e-9)
    assert (free["edge_time"] == 0).all()


def test_sampled_cohort_with_edges_is_deterministic(vgg5):
    clients, test = _mini()
    fl = FLConfig(**_fl(delta_density=0.25, cohort_size=2, num_edges=2,
                        client_widths=WIDTHS))
    h1, h2 = (run_federated(VGG5, clients, test, fl, init_params=vgg5[0],
                            device="cpu") for _ in range(2))
    np.testing.assert_array_equal(h1["accuracy"], h2["accuracy"])
    np.testing.assert_array_equal(h1["ops"], h2["ops"])
    np.testing.assert_array_equal(h1["dropped"], [2, 2, 2])
    for a, b in zip(tree_leaves(h1["params"]), tree_leaves(h2["params"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("run", [run_federated, run_federated_async],
                         ids=["sync", "async"])
@pytest.mark.parametrize("over,match", [
    (dict(server_step="reference", num_edges=2), "fused"),
    (dict(num_edges=-1), "num_edges")], ids=["reference-step", "negative"])
def test_bad_num_edges_raise(run, over, match):
    clients, test = _mini()
    with pytest.raises(ValueError, match=match):
        run(VGG5, clients, test, FLConfig(**_fl(**over)), device="cpu")
