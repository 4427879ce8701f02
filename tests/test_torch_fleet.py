"""The port's batched fleet engine and per-leaf reference server step
against the JAX reference (``repro/data/loader.py``, ``repro/fl/fedavg.py``,
``repro/fl/fleet.py``, ``repro/fl/flatbuf.py``,
``repro/kernels/topk_compress/ops.py``), on identical numpy inputs.

* Batch streams are numpy on both sides: bitwise.
* Top-k keep masks and int8 codes do not depend on summation order: exact,
  and so are the values they keep and the error-feedback rows.
* Weighted averages: within 1e-6 (fp32 rounding of the products; both
  sides add client by client in the given order).
* Trained client rows: within 1e-5 without the int8 cut (the frameworks'
  convolutions round differently at the ulp level, carried through two
  SGD steps) and 1e-3 with it, where such a difference can turn an int8
  code at the cut (tests/test_torch_loop.py states the same bounds).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.vgg import VGG5 as J_VGG5
from repro.data.loader import ClientLoader as JClientLoader
from repro.data.loader import FleetLoader as JFleetLoader
from repro.fl.flatbuf import FlatLayout as JFlatLayout
from repro.fl.flatbuf import quantize_delta_flat as j_quantize_delta_flat
from repro.fl.flatbuf import reference_server_step as j_reference_step
from repro.fl.fleet import BatchedEngine as JBatchedEngine
from repro.fl.fleet import StackedRows as JStackedRows
from repro.fl.fleet import rows_as_list as j_rows_as_list
from repro.fl.fleet import take_rows as j_take_rows
from repro.kernels.topk_compress.ops import compress_tree as j_compress_tree
from repro.kernels.topk_compress.ops import \
    topk_compress_density as j_topk_density
from repro.models import vgg as jvgg
from repro.models.split_program import get_split_program as j_program
from repro_torch.configs.vgg import VGG5
from repro_torch.convert import vgg_params_from_numpy
from repro_torch.data import ClientLoader, FleetLoader, make_cifar_like
from repro_torch.data import split_clients
from repro_torch.fl import fedavg as tfa
from repro_torch.fl.flatbuf import FlatLayout, quantize_delta_flat
from repro_torch.fl.flatbuf import reference_server_step
from repro_torch.fl.fleet import (BatchedEngine, SequentialEngine,
                                  StackedRows, get_engine, rows_as_list,
                                  take_rows)
from repro_torch.kernels.topk_compress import (compress_tree,
                                               topk_compress_density)
from repro_torch.models.split_program import get_split_program
from repro_torch.tree import tree_leaves, tree_map

CPU = torch.device("cpu")
# the module (``repro.fl`` re-exports its function ``fedavg`` under the
# module's name)
jfa = importlib.import_module("repro.fl.fedavg")


@pytest.fixture(scope="module")
def vgg():
    """The reference's VGG-5 init (numpy) and the port's copy of it."""
    jparams = jax.tree_util.tree_map(
        np.asarray, jvgg.init(J_VGG5, jax.random.PRNGKey(3)))
    return jparams, vgg_params_from_numpy(jparams, device="cpu")


def _like(params, rng, scale):
    return [{k: (rng.randn(*v.shape) * scale).astype(np.float32)
             for k, v in layer.items()} for layer in params]


def _t(tree):
    return [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
            for layer in tree]


def _assert_trees(t_tree, j_tree, atol=0.0):
    jl = jax.tree_util.tree_leaves(j_tree)
    tl = tree_leaves(t_tree)
    assert len(jl) == len(tl) > 0
    for a, b in zip(jl, tl):
        if atol == 0:
            np.testing.assert_array_equal(b.detach().numpy(), np.asarray(a))
        else:
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                       rtol=0, atol=atol)


# =============================================================================
# FleetLoader: the reference's streams, bitwise
# =============================================================================
def test_fleet_loader_streams_are_bitwise_the_reference():
    clients = split_clients(make_cifar_like(120, seed=0), 4)
    t, j = FleetLoader.for_clients(clients, 10, seed=7), \
        JFleetLoader.for_clients(clients, 10, seed=7)
    groupings = [[0, 1, 2, 3], [2, 0], [3], [1, 3, 0], [0, 1, 2, 3]]
    for step in range(8):                     # crosses epoch boundaries
        ks = groupings[step % len(groupings)]
        pad = len(ks) + (step % 2)            # pad_to repeats the first
        a, b = t.next_batches(ks, pad_to=pad), j.next_batches(ks, pad_to=pad)
        for key in b:
            assert a[key].shape == b[key].shape == (pad, 10) + \
                b[key].shape[2:]
            assert a[key].tobytes() == b[key].tobytes()
    assert t.state() == j.state()
    solo, jsolo = ClientLoader(clients[1], 10, 9), JClientLoader(clients[1],
                                                                 10, 9)
    solo.skip(7)
    jsolo.skip(7)
    assert solo.state() == jsolo.state()
    assert solo.next_batch()["labels"].tobytes() == \
        jsolo.next_batch()["labels"].tobytes()


def test_fleet_loader_skip_state_and_restore_are_the_reference():
    clients = split_clients(make_cifar_like(90, seed=1), 3)
    t, j = FleetLoader.for_clients(clients, 10, seed=0), \
        JFleetLoader.for_clients(clients, 10, seed=0)
    t.skip_client(2, 5)
    j.skip_client(2, 5)
    assert t.state() == j.state()
    t.skip(4)
    j.skip(4)
    assert t.state() == j.state()
    saved = t.state()
    want = [t.next_batches([0, 1, 2]) for _ in range(3)]
    fresh = FleetLoader.for_clients(clients, 10, seed=0)
    fresh.restore(saved)                      # bitwise resume
    for w in want:
        got = fresh.next_batches([0, 1, 2])
        for key in w:
            assert got[key].tobytes() == w[key].tobytes()
    with pytest.raises(ValueError, match="partial restore"):
        fresh.restore(saved[:2])
    assert FleetLoader.for_clients(clients, 10).state() == \
        JFleetLoader.for_clients(clients, 10).state() == [(0, 0)] * 3


# =============================================================================
# fedavg and the row adapters
# =============================================================================
def test_fedavg_family_matches_reference(vgg):
    jparams, tparams = vgg
    rng = np.random.RandomState(0)
    clients = [_like(jparams, rng, 1.0) for _ in range(3)]
    deltas = [_like(jparams, rng, 1e-2) for _ in range(3)]
    w = [20.0, 30.0, 50.0]
    _assert_trees(tfa.fedavg([_t(c) for c in clients], w),
                  jfa.fedavg(clients, w), 1e-6)
    _assert_trees(tfa.fedavg([_t(c) for c in clients]),
                  jfa.fedavg(clients), 1e-6)
    _assert_trees(tfa.fedavg_delta(tparams, [_t(c) for c in clients], w,
                                   compress_fn=lambda d: d * 0.5),
                  jfa.fedavg_delta(jparams, clients, w,
                                   compress_fn=lambda d: d * 0.5), 1e-6)
    _assert_trees(tfa.fedavg_apply_deltas(tparams, [_t(d) for d in deltas],
                                          w),
                  jfa.fedavg_apply_deltas(jparams, deltas, w), 1e-6)
    stacked = [{k: np.stack([c[i][k] for c in clients]) for k in layer}
               for i, layer in enumerate(jparams)]
    _assert_trees(tfa.fedavg_delta_stacked(tparams, _t(stacked), w),
                  jfa.fedavg_delta_stacked(jparams, stacked, w), 1e-6)
    assert tfa.model_bytes(tparams) == jfa.model_bytes(jparams) == \
        4 * 582_346


def test_take_rows_and_rows_as_list_match_reference(vgg):
    jparams, _ = vgg
    rng = np.random.RandomState(1)
    stacked = [{k: rng.randn(4, *v.shape).astype(np.float32)
                for k, v in layer.items()} for layer in jparams]
    trows, jrows = StackedRows(_t(stacked)), JStackedRows(stacked)
    assert len(trows) == len(jrows) == 4
    sub = take_rows(trows, [3, 1])
    assert isinstance(sub, StackedRows) and len(sub) == 2
    _assert_trees(sub.tree, j_take_rows(jrows, [3, 1]).tree)
    for a, b in zip(rows_as_list(trows, [2, 0]),
                    j_rows_as_list(jrows, [2, 0])):
        _assert_trees(a, b)
    lst = [_t(jparams), _t(stacked)]
    assert take_rows(lst, [1]) == [lst[1]]
    assert rows_as_list(lst, [0]) == [lst[0]]
    layout = FlatLayout(_t(jparams))
    # the fused step's rows from either engine's output agree
    g = layout.flatten(_t(jparams))
    np.testing.assert_array_equal(
        layout.rows_to_deltas(sub, g).numpy(),
        layout.rows_to_deltas(rows_as_list(trows, [3, 1]), g).numpy())
    with pytest.raises(ValueError, match="unknown fleet engine"):
        get_engine("warp", get_split_program(VGG5), 1, 0, False, False, CPU)


# =============================================================================
# the batched engine
# =============================================================================
def test_batched_engine_run_round_matches_reference(vgg):
    """Three OP groups (OP1 x 3, OP2, native) with max_group=2: the OP1
    group splits into a full chunk and a tail padded back up to 2; the cut
    crosses as int8 (so the rows take the int8 atol, 1e-3)."""
    quantize, atol = True, 1e-3
    jparams, tparams = vgg
    clients = split_clients(make_cifar_like(100, seed=0), 5)
    ops = [2, 4, 2, 7, 2]
    alive = [0, 1, 2, 3, 4]
    jeng = JBatchedEngine(j_program(J_VGG5), 2, 0, True, quantize,
                          max_group=2)
    teng = BatchedEngine(get_split_program(VGG5), 2, 0, True, quantize, CPU,
                         max_group=2)
    jidx, jrows = jeng.run_round(
        jax.tree_util.tree_map(jnp.asarray, jparams),
        JFleetLoader.for_clients(clients, 10, seed=0), ops, alive, 1, 0.05)
    tidx, trows = teng.run_round(
        tparams, FleetLoader.for_clients(clients, 10, seed=0), ops, alive,
        1, 0.05)
    assert tidx == jidx == [0, 2, 4, 1, 3]
    assert isinstance(trows, StackedRows) and len(trows) == 5
    _assert_trees(trows.tree, jrows.tree, atol)
    # each batched row is the sequential engine's client, up to fp32
    # summation order
    sidx, srows = SequentialEngine(get_split_program(VGG5), 2, 0, True,
                                   quantize, CPU).run_round(
        tparams, FleetLoader.for_clients(clients, 10, seed=0), ops, tidx,
        1, 0.05)
    for i, row in enumerate(rows_as_list(trows, range(5))):
        for a, b in zip(tree_leaves(row), tree_leaves(srows[i])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=atol)
    assert teng.run_round(tparams, FleetLoader.for_clients(clients, 10),
                          ops, [], 0, 0.05) == ([], StackedRows(None))


# =============================================================================
# per-leaf top-k, the int8 delta wire and the reference server step
# =============================================================================
@pytest.mark.parametrize("n,density", [(5, 0.5), (100, 0.01), (1500, 0.1),
                                       (2048, 0.3)])
def test_topk_compress_density_matches_reference(n, density):
    x = np.random.RandomState(n).randn(n).astype(np.float32)
    x[::7] = x[1]                               # ties at the threshold
    np.testing.assert_array_equal(
        topk_compress_density(torch.from_numpy(x), density).numpy(),
        np.asarray(j_topk_density(jnp.asarray(x), density)))


def test_compress_tree_and_quantize_delta_flat_match_reference(vgg):
    jparams, tparams = vgg
    rng = np.random.RandomState(2)
    delta, err = _like(jparams, rng, 1e-2), _like(jparams, rng, 1e-3)
    for e in (err, None):
        jc, je = j_compress_tree(delta, e, density=0.1)
        tc, te = compress_tree(_t(delta), None if e is None else _t(e),
                               density=0.1)
        _assert_trees(tc, jc)                   # keep masks and values
        _assert_trees(te, je)
    jl, tl = JFlatLayout(jparams), FlatLayout(tparams)
    _assert_trees(quantize_delta_flat(tl, _t(delta)),
                  j_quantize_delta_flat(jl, delta))


@pytest.mark.parametrize("density,quantize", [(1.0, False), (1.0, True),
                                              (0.1, False), (0.1, True)])
def test_reference_server_step_matches_reference(vgg, density, quantize):
    jparams, tparams = vgg
    rng = np.random.RandomState(int(density * 10) + quantize)
    deltas = [_like(jparams, rng, 1e-2) for _ in range(3)]
    jl, tl = JFlatLayout(jparams), FlatLayout(tparams)
    track = density < 1
    errors = np.stack([np.asarray(jl.flatten(_like(jparams, rng, 1e-3)))
                       for _ in range(3)]) if track else None
    weights = [20.0, 30.0, 50.0]
    jp, jerr = j_reference_step(
        jl, jax.tree_util.tree_map(jnp.asarray, jparams), deltas, weights,
        None if errors is None else jnp.asarray(errors), density=density,
        quantize=quantize)
    tp, terr = reference_server_step(
        tl, tparams, [_t(d) for d in deltas], weights,
        None if errors is None else torch.from_numpy(errors),
        density=density, quantize=quantize)
    _assert_trees(tp, jp, 1e-6)
    if track:
        # what each client sent (carried - new error) and the new error
        # rows: exact, with the same keep masks and int8 codes
        np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))
        assert (terr.numpy() != 0).any()
    else:
        assert terr is None and jerr is None


def test_vmapped_int8_cut_equals_per_client_calls():
    """The fake-quant's vmap rule folds the client axis into the rows: the
    same codes as one call per client, and a straight-through gradient."""
    from repro_torch.kernels.quant_transfer import fake_quant_int8
    x = torch.from_numpy(np.random.RandomState(4).randn(3, 5, 4, 4, 8)
                         .astype(np.float32))
    batched = torch.func.vmap(fake_quant_int8)(x)
    for i in range(3):
        torch.testing.assert_close(batched[i], fake_quant_int8(x[i]),
                                   rtol=0, atol=0)
    g = torch.func.vmap(torch.func.grad(
        lambda v: (fake_quant_int8(v) * 2.0).sum()))(x)
    torch.testing.assert_close(g, torch.full_like(x, 2.0), rtol=0, atol=0)
