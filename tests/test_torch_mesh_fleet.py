"""The port's mesh-parallel batched engine and the loops over a mesh
(``FLConfig.mesh_shape``, ``mesh_devices``) against its mesh-less runs and
the JAX reference's single-device runs (whose own tests hold them equal to
its mesh runs: bitwise at ``data = 1``, within 1e-6 above), on VGG-5 with
90 samples over 3 clients, 2 rounds, from the reference's initial weights.
The meshes' places are eight CPU places of one device.

* ``data = 1`` meshes ((1, 1), (1, 8)): bitwise the mesh-less run, params
  and history (the engine's one data shard is the mesh-less chunk; the
  server step is bitwise at ``data = 1``).
* ``data > 1`` ((8, 1), (2, 4), (2, 1)): each data shard's clients train
  in a batch of their own, so the vmapped gradients round apart at the
  fp32 ulp.  A plain fp32 run (no top-k, no int8) holds 1e-6; a run with
  top-k 0.5 and int8 deltas holds the discrete-step bound of
  ``tests/test_torch_loop.py`` (1e-3), where such a difference can move a
  top-k near-tie or an int8 code.  OPs, modelled times and drops are
  exact throughout.
* Against the reference's mesh-less runs: ``tests/test_torch_loop.py``'s
  contract (params within 1e-5 plain and 1e-3 with top-k or int8;
  accuracy within one test sample; OPs, times and drops exact).  The
  width and async runs are held against the port's mesh-less runs, which
  tests/test_torch_hetero.py and tests/test_torch_async.py hold against
  the reference's.
"""
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.configs.vgg import VGG5 as J_VGG5
from repro.fl.loop import FLConfig as JFLConfig
from repro.fl.loop import run_federated as j_run
from repro.models.split_program import get_split_program as j_program
from repro_torch.configs.vgg import VGG5
from repro_torch.data import FleetLoader, make_cifar_like, split_clients
from repro_torch.fl.async_loop import run_federated_async
from repro_torch.fl.fleet import BatchedEngine, get_engine
from repro_torch.fl.loop import FLConfig, run_federated
from repro_torch.models.split_program import get_split_program
from repro_torch.tree import tree_leaves

CPU8 = [torch.device("cpu")] * 8
PLAIN = dict(rounds=2, local_iters=1, batch_size=20, mode="sfl", static_op=2,
             seed=0, engine="batched")
TOPK = dict(PLAIN, delta_density=0.5, quantize_deltas=True)
EXACT = ("ops", "round_time", "times", "comm_time", "dropped")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: test workers running side by side then do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fleet():
    clients = split_clients(make_cifar_like(90, seed=0), 3)
    test = make_cifar_like(30, seed=9)
    init = jax.tree_util.tree_map(
        np.asarray, j_program(J_VGG5).init(jax.random.PRNGKey(0)))
    return clients, test, init


def _run(fleet, kw, mesh_shape=None, fn=run_federated, **extra):
    clients, test, init = fleet
    return fn(VGG5, clients, test, FLConfig(**kw, mesh_shape=mesh_shape),
              init_params=init, device="cpu", mesh_devices=CPU8, **extra)


def _close(a, b, atol, bitwise=False):
    la, lb = tree_leaves(a["params"]), tree_leaves(b["params"])
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        y = torch.from_numpy(np.array(y))
        if bitwise:
            assert torch.equal(x, y)
        else:
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                       atol=atol)
    for k in EXACT:
        if k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
    if bitwise:
        np.testing.assert_array_equal(a["accuracy"], b["accuracy"])
    else:
        assert np.abs(np.asarray(a["accuracy"])
                      - np.asarray(b["accuracy"])).max() <= 1 / 30 + 1e-9


@pytest.fixture(scope="module")
def none_runs(fleet):
    return {name: _run(fleet, kw) for name, kw in (("plain", PLAIN),
                                                   ("topk", TOPK))}


@pytest.fixture(scope="module")
def ref_runs(fleet):
    clients, test, _ = fleet
    return {name: j_run(J_VGG5, clients, test, JFLConfig(**kw))
            for name, kw in (("plain", PLAIN), ("topk", TOPK))}


# =============================================================================
# the engine's mesh knobs
# =============================================================================
def test_engine_chunks_over_the_data_axis(fleet):
    from repro_torch.parallel.sharding import make_flat_mesh
    program = get_split_program(VGG5)
    eng = get_engine("batched", program, 1, 0, False, False, "cpu")
    assert isinstance(eng, BatchedEngine) and eng.mesh is None
    assert eng.data_size == 1 and eng.chunk == eng.max_group == 8
    mesh = make_flat_mesh((3, 2), devices=CPU8)
    eng = get_engine("batched", program, 1, 0, False, False, "cpu",
                     mesh=mesh)
    assert eng.data_size == 3 and eng.chunk == 9
    seq = get_engine("sequential", program, 1, 0, False, False, "cpu",
                     mesh=mesh)
    assert not hasattr(seq, "mesh")
    # a chunk of 2 clients pads to 3 rows, the pad row repeating client
    # 0's draw without advancing a stream
    clients = fleet[0]
    a = FleetLoader.for_clients(clients, 20, seed=0)
    b = FleetLoader.for_clients(clients, 20, seed=0)
    shards = eng._stack_round(a, [1, 2], 0, 3)
    assert len(shards) == 3
    plain = b.next_batches([1, 2])
    for key in plain:
        got = torch.cat([s[key] for s in shards])[:, 0].numpy()
        np.testing.assert_array_equal(got[:2], plain[key])
        np.testing.assert_array_equal(got[2], got[0])
    nxt_a, nxt_b = a.next_batches([1, 2]), b.next_batches([1, 2])
    for key in nxt_a:
        np.testing.assert_array_equal(nxt_a[key], nxt_b[key])


# =============================================================================
# run_federated over meshes
# =============================================================================
@pytest.mark.parametrize("engine", ["batched", "sequential"])
def test_mesh_1x1_is_bitwise_the_meshless_run(fleet, none_runs, engine):
    kw = dict(TOPK, engine=engine)
    base = none_runs["topk"] if engine == "batched" else _run(fleet, kw)
    _close(_run(fleet, kw, (1, 1)), base, 0, bitwise=True)


@pytest.mark.parametrize("shape", [(8, 1), (1, 8), (2, 4)])
@pytest.mark.parametrize("mode", ["plain", "topk"])
def test_mesh_runs_match_meshless_and_reference(fleet, none_runs, ref_runs,
                                                shape, mode):
    h = _run(fleet, PLAIN if mode == "plain" else TOPK, shape)
    _close(h, none_runs[mode], 1e-6 if mode == "plain" else 1e-3,
           bitwise=shape[0] == 1)
    _close(h, ref_runs[mode], 1e-5 if mode == "plain" else 1e-3)


def test_hetero_mesh_2x1(fleet):
    """Width-masked OP groups through the masked sharded fleet step and
    the masked sharded server step, against the mesh-less run (which
    tests/test_torch_hetero.py holds against the reference's)."""
    kw = dict(TOPK, client_widths=[1.0, 0.5, 1.0])
    _close(_run(fleet, kw, (2, 1)), _run(fleet, kw), 1e-3)


def test_async_mesh_2x1(fleet):
    """The async runtime threads the mesh through its engine and step:
    against its mesh-less run (held against the reference's by
    tests/test_torch_async.py), the virtual clock exact."""
    kw = dict(PLAIN, rounds=3, buffer_size=2, staleness_discount=0.5)
    h = _run(fleet, kw, (2, 1), fn=run_federated_async)
    base = _run(fleet, kw, fn=run_federated_async)
    _close(h, base, 1e-6)
    np.testing.assert_array_equal(h["virtual_time"], base["virtual_time"])


def test_sync_resume_bitwise_with_k_not_divisible_by_data(fleet):
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        def kw(d, rounds):
            return dict(TOPK, rounds=rounds, checkpoint_dir=d,
                        checkpoint_every=2)
        full = _run(fleet, kw(d1, 4), (2, 1))
        _run(fleet, kw(d2, 2), (2, 1))
        res = _run(fleet, kw(d2, 4), (2, 1), resume=True)
    for a, b in zip(tree_leaves(full["params"]), tree_leaves(res["params"])):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(res["accuracy"], full["accuracy"][2:])


def test_mesh_requires_the_fused_step_and_its_places(fleet):
    with pytest.raises(ValueError, match="fused"):
        _run(fleet, dict(PLAIN, server_step="reference"), (1, 1))
    clients, test, init = fleet
    with pytest.raises(ValueError, match="devices="):
        run_federated(VGG5, clients, test, FLConfig(**PLAIN,
                                                    mesh_shape=(2, 1)),
                      init_params=init, device="cpu")
    with pytest.raises(ValueError, match="first place"):
        run_federated_async(VGG5, clients, test,
                            FLConfig(**PLAIN, mesh_shape=(1, 1)),
                            init_params=init, device="cpu",
                            mesh_devices=["meta"])
