"""HeteroFL widths in the port against the JAX package's: twins of
tests/test_hetero.py on the same numpy inputs.

Exact: the Dirichlet index sets (numpy draws on the same seeds, the
rebalance included); the VGG-5 and VGG-8 width masks and their flat rows
(pure functions of the shapes); ``compute_scale`` and the width-scaled
Eq. 1 times; the batched engine's ``(OP, width)`` groups.

The masked fused ``ServerStep`` and ``reference_server_step(masks=)``
against the reference's fused step: what each client sent has the same
nonzero pattern (keep masks and int8 codes do not depend on summation
order); the new global and the EF rows within 1e-6, as
tests/test_torch_flatbuf.py holds the unmasked step (both accumulate
``w_i * sent`` client by client; the plain average is a matvec either
side).  Coordinates no client covers keep their value bit for bit.

Whole runs (the reference's ``_fl()``: K=4, sfl at OP2, widths (0.25,
0.5, 1.0, 1.0), 3 rounds of 2 local iterations, plus the paper testbed's
Eq. 1 times and transport), on both engines and both server steps: OPs,
times, comm and drops exact, accuracy within one test sample, params
within 1e-5 (plain averaging, as tests/test_torch_loop.py; observed on the
CPU with one intra-op thread, as the file runs: 6.0e-8 in each of the
four).  The top-k and int8 run is in tests/test_torch_hierarchy.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.vgg import VGG5 as J_VGG5
from repro.configs.vgg import VGG8 as J_VGG8
from repro.core.env import SimulatedCluster as JSim
from repro.core.testbed import paper_testbed as j_testbed
from repro.data.loader import dirichlet_indices as j_dirichlet_indices
from repro.data.loader import dirichlet_partition as j_dirichlet_partition
from repro.fl.comm import Transport as JTransport
from repro.fl.comm import device_bandwidths as j_bw
from repro.fl.flatbuf import FlatLayout as JFlatLayout
from repro.fl.flatbuf import ServerStep as JServerStep
from repro.fl.fleet import BatchedEngine as JBatchedEngine
from repro.fl.hetero import HeteroSpec as JHeteroSpec
from repro.fl.loop import FLConfig as JFLConfig
from repro.fl.loop import run_federated as j_run
from repro.models.split_program import get_split_program as j_program
from repro_torch.configs.vgg import VGG5, VGG8
from repro_torch.convert import vgg_params_from_numpy, vgg_params_to_numpy
from repro_torch.core.env import SimulatedCluster
from repro_torch.core.testbed import paper_testbed
from repro_torch.data import make_cifar_like, split_clients
from repro_torch.data.loader import dirichlet_indices, dirichlet_partition
from repro_torch.fl.comm import Transport, device_bandwidths
from repro_torch.fl.flatbuf import (FlatLayout, ServerStep,
                                    reference_server_step)
from repro_torch.fl.fleet import BatchedEngine, SequentialEngine
from repro_torch.fl.hetero import HeteroSpec, resolve_hetero
from repro_torch.fl.loop import FLConfig, run_federated
from repro_torch.kernels.quant_transfer import dequantize_rows, quantize_rows
from repro_torch.kernels.topk_compress import topk_compress_flat
from repro_torch.models.split_program import SplitProgram, get_split_program
from repro_torch.runtime.chaos import ChaosScript, run_chaos_drill
from repro_torch.tree import tree_leaves

CPU = torch.device("cpu")
WIDTHS = (0.25, 0.5, 1.0, 1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inits():
    """The reference's init from PRNGKey(0) (numpy) and the port's copy on
    the CPU, once per config."""
    cache = {}

    def get(jcfg):
        if jcfg.name not in cache:
            jparams = jax.tree_util.tree_map(
                np.asarray, j_program(jcfg).init(jax.random.PRNGKey(0)))
            cache[jcfg.name] = (jparams, vgg_params_from_numpy(
                jparams, device="cpu"))
        return cache[jcfg.name]
    return get


@pytest.fixture(scope="module")
def vgg5(inits):
    return inits(J_VGG5)


# =============================================================================
# Dirichlet non-IID partitions: the reference's index sets, array for array
# =============================================================================
@pytest.mark.parametrize("alpha", [0.05, 0.5, 10.0])
@pytest.mark.parametrize("min_per_client", [1, 40])
def test_dirichlet_indices_are_the_reference(alpha, min_per_client):
    """At alpha 0.05 the skewed shards need the rebalance to reach 40."""
    labels = np.random.RandomState(0).randint(0, 10, 400)
    want = j_dirichlet_indices(labels, 6, alpha, seed=3,
                               min_per_client=min_per_client)
    got = dirichlet_indices(labels, 6, alpha, seed=3,
                            min_per_client=min_per_client)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(np.sort(np.concatenate(got)),
                                  np.arange(400))
    assert min(len(p) for p in got) >= min_per_client


def test_dirichlet_token_labels_and_partition_are_the_reference():
    tokens = np.random.RandomState(1).randint(0, 5, (90, 7))
    for a, b in zip(dirichlet_indices(tokens, 4, 0.3, seed=2),
                    j_dirichlet_indices(tokens, 4, 0.3, seed=2)):
        np.testing.assert_array_equal(a, b)
    data = make_cifar_like(200, seed=0)
    got = dirichlet_partition(data, 5, alpha=0.3, seed=7)
    want = j_dirichlet_partition(data, 5, alpha=0.3, seed=7)
    for g, w in zip(got, want):
        assert set(g) == set(w) == set(data)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("args", [(10, 0, 0.5), (10, 2, 0.0), (10, 20, 0.5)])
def test_dirichlet_rejects_bad_args(args):
    n, clients, alpha = args
    with pytest.raises(ValueError):
        dirichlet_indices(np.zeros(n, np.int64), clients, alpha)


# =============================================================================
# width masks and HeteroSpec
# =============================================================================
@pytest.mark.parametrize("cfgs", [(VGG5, J_VGG5), (VGG8, J_VGG8)],
                         ids=["vgg5", "vgg8"])
@pytest.mark.parametrize("width", [0.25, 0.5, 1.0])
def test_width_mask_and_rows_are_the_reference(inits, cfgs, width):
    cfg, jcfg = cfgs
    jprog = j_program(jcfg)
    jparams, tparams = inits(jcfg)
    tmask = get_split_program(cfg).width_mask(tparams, width)
    jmask = jprog.width_mask(jparams, width)
    jl = jax.tree_util.tree_leaves(jmask)
    tl = tree_leaves(tmask)
    assert len(tl) == len(jl) > 0
    for a, b in zip(tl, jl):
        assert a.dtype == torch.float32 and a.device == CPU
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    trow = HeteroSpec(get_split_program(cfg), tparams, [width]).mask_row(0)
    jrow = JHeteroSpec(jprog, jparams, [width]).mask_row(0)
    np.testing.assert_array_equal(trow.numpy(), np.asarray(jrow))


@pytest.mark.parametrize("cfg", [VGG5, VGG8], ids=["vgg5", "vgg8"])
def test_width_masks_are_nested(cfg):
    prog = get_split_program(cfg)
    params = prog.init(torch.Generator().manual_seed(0), "cpu")
    masks = [tree_leaves(prog.width_mask(params, w))
             for w in (0.25, 0.5, 0.75, 1.0)]
    for lo, hi in zip(masks, masks[1:]):
        for a, b in zip(lo, hi):
            assert float((a * (1 - b)).sum()) == 0.0     # lo within hi
    assert all(float(m.min()) == 1.0 for m in masks[-1])


def test_width_mask_rejects_bad_widths_and_lm_masks_are_not_ported(vgg5):
    prog = get_split_program(VGG5)
    for w in (0.0, 1.5):
        with pytest.raises(ValueError):
            prog.width_mask(vgg5[1], w)
    with pytest.raises(ValueError):
        HeteroSpec(prog, vgg5[1], [0.5, 1.5])
    # the LM families' masks are ported (tests/test_torch_width_masks.py);
    # the base class still has no width dims of its own
    with pytest.raises(NotImplementedError):
        SplitProgram(None).width_mask([], 0.5)


def test_hetero_spec_matches_reference(vgg5):
    jparams, tparams = vgg5
    prog = get_split_program(VGG5)
    widths = [0.5, 0.25, 1.0, 0.5]
    spec = HeteroSpec(prog, tparams, widths)
    jspec = JHeteroSpec(j_program(J_VGG5), jparams, widths)
    assert len(spec) == 4 and spec.width(1) == 0.25
    np.testing.assert_array_equal(spec.compute_scale, jspec.compute_scale)
    assert spec.compute_scale.dtype == np.float64
    # one mask per distinct width, shared by the clients of that width
    assert spec.mask_tree(0) is spec.mask_tree(3)
    np.testing.assert_array_equal(spec.rows([2, 0, 1]).numpy(),
                                  np.asarray(jspec.rows([2, 0, 1])))
    applied = spec.apply(tparams, 1)
    for a, m, p in zip(tree_leaves(applied), tree_leaves(spec.mask_tree(1)),
                       tree_leaves(tparams)):
        assert torch.equal(a, m * p)
    assert resolve_hetero(FLConfig(), prog, tparams) is None


# =============================================================================
# the engines
# =============================================================================
def test_batched_groups_key_op_and_width_in_the_reference_order(vgg5):
    ops = [2, 4, 2, 2, 4, 2]
    alive = [5, 0, 1, 2, 3, 4]
    widths = [0.5, 1.0, 0.25, 0.5, 1.0, 0.25]
    tspec = HeteroSpec(get_split_program(VGG5), vgg5[1], widths)
    jspec = JHeteroSpec(j_program(J_VGG5), vgg5[0], widths)
    teng = BatchedEngine(get_split_program(VGG5), 1, 0, False, False, CPU)
    jeng = JBatchedEngine(j_program(J_VGG5), 1, 0, False, False)
    got = teng._group(ops, alive, tspec)
    want = jeng._group(ops, alive, jspec)
    assert list(got.items()) == list(want.items())
    assert list(teng._group(ops, alive).items()) == \
        list(jeng._group(ops, alive).items())


@pytest.mark.parametrize("engine", [SequentialEngine, BatchedEngine])
def test_full_width_masks_leave_the_engines_bitwise(vgg5, engine):
    """All-ones masks: ``1 * p`` and ``1 * g`` are exact, so a width-1.0
    fleet trains bit for bit as ``hetero=None``."""
    clients = split_clients(make_cifar_like(40, seed=0), 2)
    prog = get_split_program(VGG5)
    spec = HeteroSpec(prog, vgg5[1], [1.0, 1.0])
    outs = []
    for hetero in (None, spec):
        eng = engine(prog, 2, 0, True, True, CPU)
        idx, rows = eng.run_round(vgg5[1], _loader(clients), [1, 2], [0, 1],
                                  0, 0.05, hetero=hetero)
        outs.append((idx, tree_leaves(rows if isinstance(rows, list)
                                      else rows.tree)))
    assert outs[0][0] == outs[1][0]
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


def _loader(clients):
    from repro_torch.data import FleetLoader
    return FleetLoader.for_clients(clients, 10, seed=0)


# =============================================================================
# the masked server step
# =============================================================================
def _parent_server_step(step, g_flat, deltas, weights, errors=None):
    """The unmasked ``ServerStep.__call__`` as it stood before the reduce /
    apply split, copied: the split must not move a bit."""
    w = np.asarray(weights, np.float64)
    w = torch.as_tensor(w / w.sum(), dtype=torch.float32,
                        device=g_flat.device)
    if not step.track_errors and not step.quantize:
        return g_flat + w @ deltas, None
    block = step.layout.block
    meta = torch.from_numpy(step.layout.block_meta(step.density)) \
        if step.track_errors else None
    acc = torch.zeros_like(g_flat)
    new_err = torch.empty_like(errors) if step.track_errors else None
    for i in range(deltas.shape[0]):
        carried = deltas[i] + errors[i] if step.track_errors else deltas[i]
        comp = (topk_compress_flat(carried[None], meta, block)[0]
                if step.track_errors else carried)
        if step.quantize:
            q, s = quantize_rows(comp.view(-1, block))
            sent = dequantize_rows(q, s).view(-1)
        else:
            sent = comp
        if step.track_errors:
            new_err[i] = carried - sent
        acc = acc + w[i] * sent
    return g_flat + acc, new_err


def _step_inputs(tparams, widths, seed):
    layout = FlatLayout(tparams)
    rng = np.random.RandomState(seed)
    K = len(widths)
    masks = HeteroSpec(get_split_program(VGG5), tparams, widths,
                       layout=layout).rows(range(K)).numpy()
    deltas = (rng.randn(K, layout.padded) * 1e-2).astype(np.float32) * masks
    errors = (rng.randn(K, layout.padded) * 1e-3).astype(np.float32) * masks
    g = layout.flatten(tparams).numpy()
    return layout, g, deltas, errors, masks


@pytest.mark.parametrize("density,quantize", [(1.0, False), (1.0, True),
                                              (0.25, False), (0.25, True)])
def test_unmasked_step_is_bitwise_the_parents(vgg5, density, quantize):
    layout, g, deltas, errors, _ = _step_inputs(vgg5[1], WIDTHS, 5)
    step = ServerStep(layout, density, quantize)
    track = density < 1
    e = torch.from_numpy(errors) if track else None
    got_g, got_e = step(torch.from_numpy(g), torch.from_numpy(deltas),
                        [3.0, 1.0, 2.0, 2.0], e)
    want_g, want_e = _parent_server_step(step, torch.from_numpy(g),
                                         torch.from_numpy(deltas),
                                         [3.0, 1.0, 2.0, 2.0], e)
    assert torch.equal(got_g.view(torch.int32), want_g.view(torch.int32))
    if track:
        assert torch.equal(got_e.view(torch.int32), want_e.view(torch.int32))
    else:
        assert got_e is None and want_e is None


@pytest.mark.parametrize("widths", [WIDTHS, (0.5, 0.25, 0.5, 0.25)],
                         ids=["with-full", "all-narrow"])
@pytest.mark.parametrize("density,quantize", [(1.0, False), (0.25, False),
                                              (0.25, True)])
def test_masked_server_step_matches_reference(vgg5, widths, density,
                                              quantize):
    jparams, tparams = vgg5
    layout, g, deltas, errors, masks = _step_inputs(tparams, widths, 0)
    K = len(widths)
    w = [120.0, 80.0, 200.0, 100.0]
    track = density < 1
    jg, jerr = JServerStep(JFlatLayout(jparams), density, quantize)(
        jnp.asarray(g), jnp.asarray(deltas), w,
        jnp.asarray(errors) if track else None, masks=jnp.asarray(masks))
    jg, jerr = np.asarray(jg), (np.asarray(jerr) if track else None)
    tg, terr = ServerStep(layout, density, quantize)(
        torch.from_numpy(g.copy()), torch.from_numpy(deltas), w,
        torch.from_numpy(errors) if track else None,
        masks=torch.from_numpy(masks))
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=1e-6)
    # the per-leaf oracle, masked, against the same reference
    rp, rerr = reference_server_step(
        layout, tparams, [layout.unflatten(torch.from_numpy(deltas[i]))
                          for i in range(K)], w,
        torch.from_numpy(errors) if track else None, density=density,
        quantize=quantize, masks=torch.from_numpy(masks))
    np.testing.assert_allclose(layout.flatten(rp).numpy(), jg, rtol=0,
                               atol=1e-6)
    if track:
        carried = masks * deltas + errors
        for got in (terr.numpy(), rerr.numpy()):
            # what each client sent: the same nonzero pattern
            np.testing.assert_array_equal(carried - got != 0,
                                          carried - jerr != 0)
            np.testing.assert_allclose(got, jerr, rtol=0, atol=1e-6)
    else:
        assert terr is None and rerr is None
    # coordinates no client covers keep the global bit for bit
    uncovered = (np.asarray(w, np.float32) @ masks) == 0
    assert uncovered.any()
    np.testing.assert_array_equal(tg.numpy()[uncovered], g[uncovered])
    np.testing.assert_array_equal(layout.flatten(rp).numpy()[uncovered],
                                  g[uncovered])


# =============================================================================
# whole runs against the reference
# =============================================================================
RUNS = {
    "seq-fused": dict(),
    "seq-reference": dict(server_step="reference"),
    "batched-fused": dict(engine="batched"),
    "batched-reference": dict(engine="batched", server_step="reference"),
}


def _fl(**kw):
    base = dict(rounds=3, local_iters=2, batch_size=10, mode="sfl",
                static_op=2, augment=False, seed=0, client_widths=WIDTHS)
    base.update(kw)
    return base


def _mini():
    return (split_clients(make_cifar_like(120, seed=0), 4),
            make_cifar_like(40, seed=9))


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's runs, each once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            clients, test = _mini()
            jw, jdev, jsrv, jovh = j_testbed(J_VGG5)
            jsim = JSim(jw, jdev[:4], jsrv, J_VGG5.ops, iterations=2,
                        jitter=0.05, seed=3, overhead_s=jovh)
            cache[name] = j_run(J_VGG5, clients, test,
                                JFLConfig(**_fl(**RUNS[name])), sim=jsim,
                                transport=JTransport(j_bw(jdev[:4])))
        return cache[name]
    return get


def _port_run(name, init, **kw):
    clients, test = _mini()
    tw, tdev, tsrv, tovh = paper_testbed(VGG5)
    tsim = SimulatedCluster(tw, tdev[:4], tsrv, VGG5.ops, iterations=2,
                            jitter=0.05, seed=3, overhead_s=tovh)
    return run_federated(VGG5, clients, test, FLConfig(**_fl(**RUNS[name])),
                         sim=tsim, transport=Transport(device_bandwidths(
                             tdev[:4])), init_params=init, device="cpu",
                         **kw)


@pytest.mark.parametrize("name", list(RUNS))
def test_hetero_run_matches_reference(vgg5, reference_runs, name):
    jh = reference_runs(name)
    th = _port_run(name, vgg5[0])
    for key in ("ops", "times", "round_time", "comm_time", "dropped",
                "edge_time"):
        np.testing.assert_array_equal(th[key], jh[key], err_msg=key)
    # one test sample of 40, and the fp32 rounding of the two means
    assert np.all(np.abs(th["accuracy"] - jh["accuracy"]) <= 1 / 40 + 1e-6)
    for tl, jl in zip(vgg_params_to_numpy(th["params"]), jh["params"]):
        for k in tl:
            np.testing.assert_allclose(tl[k], np.asarray(jl[k]), rtol=0,
                                       atol=1e-5, err_msg=k)


def test_width_scaled_times_are_comp_times_w2_plus_comm(vgg5,
                                                        reference_runs):
    """Against the homogeneous run: each device's modelled time is its
    compute times ``w**2`` plus its unchanged comm."""
    th = _port_run("seq-fused", vgg5[0])
    clients, test = _mini()
    tw, tdev, tsrv, tovh = paper_testbed(VGG5)
    tsim = SimulatedCluster(tw, tdev[:4], tsrv, VGG5.ops, iterations=2,
                            jitter=0.05, seed=3, overhead_s=tovh)
    flat = FLConfig(**_fl(client_widths=None, rounds=1))
    tsim_h = SimulatedCluster(tw, tdev[:4], tsrv, VGG5.ops, iterations=2,
                              jitter=0.05, seed=3, overhead_s=tovh)
    hp = run_federated(VGG5, clients, test, flat, sim=tsim,
                       transport=Transport(device_bandwidths(tdev[:4])),
                       init_params=vgg5[0], device="cpu")
    np.testing.assert_array_equal(th["comm_time"][0], hp["comm_time"][0])
    comp = tsim_h.round_compute_times(th["ops"][0], 0)
    np.testing.assert_allclose(
        th["times"][0], comp * np.square(WIDTHS) + hp["comm_time"][0],
        rtol=1e-12, atol=0)


def test_uncovered_coordinates_never_move(vgg5):
    clients, test = _mini()
    fl = FLConfig(**_fl(client_widths=(0.25, 0.25, 0.5, 0.5)))
    prog = get_split_program(VGG5)
    layout = FlatLayout(vgg5[1])
    covered = HeteroSpec(prog, vgg5[1], fl.client_widths).rows(
        range(4)).sum(0).numpy() > 0
    h = run_federated(VGG5, clients, test, fl, init_params=vgg5[0],
                      device="cpu")
    flat0 = layout.flatten(vgg5[1]).numpy()
    flat1 = layout.flatten(h["params"]).numpy()
    assert (~covered).any()
    np.testing.assert_array_equal(flat1[~covered], flat0[~covered])
    assert np.any(flat1[covered] != flat0[covered])


def test_full_width_masks_match_the_homogeneous_run(vgg5):
    """All-1.0 widths take the mask path: the coverage denominator is
    ``sum(w_i)``, 1.0 only up to fp32 rounding, so within tolerance."""
    clients, test = _mini()
    h_w = run_federated(VGG5, clients, test,
                        FLConfig(**_fl(client_widths=(1.0,) * 4)),
                        init_params=vgg5[0], device="cpu")
    h_plain = run_federated(VGG5, clients, test,
                            FLConfig(**_fl(client_widths=None)),
                            init_params=vgg5[0], device="cpu")
    np.testing.assert_allclose(h_w["accuracy"], h_plain["accuracy"],
                               atol=5e-3)
    for a, b in zip(tree_leaves(h_w["params"]),
                    tree_leaves(h_plain["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


def test_same_seed_is_bitwise_deterministic(vgg5):
    clients, test = _mini()
    h1, h2 = (run_federated(VGG5, clients, test, FLConfig(**_fl()),
                            init_params=vgg5[0], device="cpu")
              for _ in range(2))
    np.testing.assert_array_equal(h1["accuracy"], h2["accuracy"])
    for a, b in zip(tree_leaves(h1["params"]), tree_leaves(h2["params"])):
        assert torch.equal(a, b)


def test_chaos_drill_with_widths_keeps_its_invariants(vgg5):
    clients = split_clients(make_cifar_like(120, seed=0), 3)
    test = make_cifar_like(40, seed=9)
    fl = FLConfig(rounds=6, local_iters=1, batch_size=10, mode="sfl",
                  static_op=2, augment=False, seed=0, buffer_size=2,
                  staleness_discount=0.5, client_widths=(0.25, 1.0, 0.5))
    res = run_chaos_drill(VGG5, clients, test, fl,
                          ChaosScript.combined(3, 6, seed=7),
                          init_params=vgg5[0], device="cpu")
    assert res.ok(), res.violations
    assert len(res.history["accuracy"]) == 6


@pytest.mark.parametrize("widths", [(0.5, 1.0), (0.5,) * 5])
def test_client_widths_length_mismatch_raises(widths):
    clients, test = _mini()
    with pytest.raises(ValueError, match="client_widths"):
        run_federated(VGG5, clients, test,
                      FLConfig(**_fl(client_widths=widths)), device="cpu")
