"""Cohorts (``repro_torch.fl.cohort``) through both loops, against the JAX
package's and against the cohort-less loops.

``CohortSampler`` draws, ``EFStore`` contents and the sampled runs' OPs,
times, virtual clock, staleness, drops and weight mass are exact: they are
numpy arithmetic on identical inputs.  A sampled run against the
reference's (VGG-5, K=4, cohort 2, 20 samples a client, batch 10, one
local iteration, flip augmentation, top-k 0.25 error feedback kept in the
``EFStore``): accuracy within one test sample, final params within 1e-3,
``tests/test_torch_loop.py``'s atol for top-k (observed with one intra-op
thread, as the file runs: 5.8e-5 sync, 3 rounds; 6.0e-8 async, 4
aggregations).  Within the port, ``cohort_size=K``
is the cohort-less run and a resumed run's suffix is the uninterrupted
run's, bitwise.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.vgg import VGG5 as J_VGG5
from repro.fl.async_loop import run_federated_async as j_run_async
from repro.fl.cohort import CohortSampler as JCohortSampler
from repro.fl.cohort import EFStore as JEFStore
from repro.fl.loop import FLConfig as JFLConfig
from repro.fl.loop import run_federated as j_run
from repro.models.split_program import get_split_program as j_program
from repro_torch.configs.vgg import VGG5
from repro_torch.convert import vgg_params_to_numpy
from repro_torch.data import make_cifar_like, split_clients
from repro_torch.fl.async_loop import run_federated_async
from repro_torch.fl.cohort import CohortSampler, EFStore
from repro_torch.fl.loop import FLConfig, run_federated



@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for these small runs: test workers running side
    by side then do not oversubscribe the cores (eight threads a worker
    made the files ~20x slower in parallel than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: fetch copies onto the card")
    return torch.device(request.param)


# =============================================================================
# CohortSampler: the reference's draws
# =============================================================================
@pytest.mark.parametrize("K,size,seed", [(100, 16, 3), (8, 8, 0), (5, 2, 7)])
def test_cohort_sampler_equals_the_reference(K, size, seed):
    a, j = CohortSampler(K, size, seed=seed), JCohortSampler(K, size,
                                                             seed=seed)
    rng = np.random.RandomState(seed)
    for r in range(6):
        np.testing.assert_array_equal(a.members(r), j.members(r))
        np.testing.assert_array_equal(a.member_mask(r), j.member_mask(r))
        cand = np.flatnonzero(rng.rand(K) < 0.6)
        count = min(len(cand), size)
        np.testing.assert_array_equal(a.pick(r, cand, count),
                                      j.pick(r, cand, count))
    m = a.members(0)
    assert len(np.unique(m)) == size and (np.sort(m) == m).all()


def test_cohort_sampler_validates_and_degenerates():
    with pytest.raises(ValueError, match="cohort_size"):
        CohortSampler(10, 0)
    with pytest.raises(ValueError, match="cohort_size"):
        CohortSampler(10, 11)
    s = CohortSampler(8, 8, seed=0)
    cand = np.asarray([5, 1, 7, 3])
    np.testing.assert_array_equal(s.pick(2, cand, 4), [1, 3, 5, 7])
    with pytest.raises(ValueError, match="pick"):
        s.pick(0, cand, 5)


# =============================================================================
# EFStore: host rows, device fetch
# =============================================================================
def test_efstore_roundtrip_and_prefetch_bitwise(device):
    st = EFStore(1000, 64, device)
    rows = np.random.RandomState(0).randn(3, 64).astype(np.float32)
    st.store([7, 500, 999], torch.from_numpy(rows).to(device))
    assert st.touched == 3
    assert st.host_bytes == 3 * 64 * 4
    assert st.dense_bytes() == 1000 * 64 * 4
    out = st.fetch([999, 3, 7])
    assert out.device.type == device.type and out.dtype == torch.float32
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  np.stack([rows[2], np.zeros(64), rows[0]]))
    # a staged gather consumed on an exact match, on a reordered subset
    # (survivors of the prefetched cohort), and an uncovered fetch
    st.prefetch([7, 500])
    np.testing.assert_array_equal(st.fetch([7, 500]).cpu().numpy(), rows[:2])
    st.prefetch([7, 500, 999])
    np.testing.assert_array_equal(st.fetch([999, 7]).cpu().numpy(),
                                  rows[[2, 0]])
    st.prefetch([7])
    np.testing.assert_array_equal(st.fetch([500, 999]).cpu().numpy(),
                                  rows[1:])
    st.close()


def test_efstore_snapshot_restore_bitwise_and_the_references():
    r = np.random.RandomState(1).randn(2, 8).astype(np.float32)
    st, js = EFStore(50, 8, "cpu"), JEFStore(50, 8)
    st.store([30, 4], r)
    js.store([30, 4], r)
    ids, rows = st.snapshot()
    jids, jrows = js.snapshot()
    np.testing.assert_array_equal(ids, [4, 30])
    for a, b in ((ids, jids), (rows, jrows)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    st2 = EFStore(50, 8, "cpu")
    st2.restore(ids, rows)
    assert torch.equal(st2.fetch([30, 4]), st.fetch([30, 4]))
    ids0, rows0 = EFStore(5, 8, "cpu").snapshot()
    assert ids0.shape == (0,) and rows0.shape == (0, 8)


def test_efstore_rejects_bad_shape():
    st = EFStore(10, 16, "cpu")
    with pytest.raises(ValueError, match="shape"):
        st.store([1, 2], np.zeros((2, 8), np.float32))
    with pytest.raises(ValueError, match="shape"):
        st.store([1], torch.zeros((2, 16)))


# =============================================================================
# through the loops
# =============================================================================
K = 4


def _testbed():
    clients = split_clients(make_cifar_like(20 * K, seed=0), K)
    test = make_cifar_like(20, seed=9)
    base = dict(rounds=3, local_iters=1, batch_size=10, mode="sfl",
                static_op=2, augment=True, seed=0)
    return clients, test, base


def _assert_bitwise(a, b, keys):
    for key in keys:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for la, lb in zip(a["params"], b["params"]):
        for k in la:
            assert torch.equal(la[k], lb[k]), k


LOOPS = {"sync": (run_federated, j_run), "async": (run_federated_async,
                                                   j_run_async)}
KEYS = {"sync": ("accuracy", "ops", "dropped", "round_time", "times"),
        "async": ("accuracy", "ops", "dropped", "round_time", "times",
                  "virtual_time", "staleness", "agg_weight_sum")}


@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("over", [
    dict(), dict(delta_density=0.25, quantize_deltas=True)],
    ids=["plain", "topk-int8"])
def test_full_cohort_is_the_cohortless_run_bitwise(loop, over):
    clients, test, base = _testbed()
    if loop == "async":
        over = dict(over, staleness_discount=0.5, buffer_size=3)
    run = LOOPS[loop][0]
    legacy = run(VGG5, clients, test, FLConfig(**base, **over),
                 device="cpu")
    full = run(VGG5, clients, test, FLConfig(**base, **over, cohort_size=K),
               device="cpu")
    _assert_bitwise(legacy, full, KEYS[loop])


@pytest.mark.parametrize("loop", list(LOOPS))
def test_sampled_cohort_matches_the_reference(loop):
    clients, test, base = _testbed()
    kw = dict(base, delta_density=0.25, cohort_size=2)
    if loop == "async":
        kw.update(rounds=4, staleness_discount=0.5, buffer_size=1)
    run, j_loop = LOOPS[loop]
    init = jax.tree_util.tree_map(
        np.asarray, j_program(J_VGG5).init(jax.random.PRNGKey(0)))
    jh = j_loop(J_VGG5, clients, test, JFLConfig(**kw))
    th = run(VGG5, clients, test, FLConfig(**kw), init_params=init,
             device="cpu")
    for key in KEYS[loop][1:]:
        np.testing.assert_array_equal(th[key], jh[key], err_msg=key)
    if loop == "sync":
        np.testing.assert_array_equal(th["dropped"], [2, 2, 2])
    assert np.all(np.abs(th["accuracy"] - jh["accuracy"]) <= 1 / 20 + 1e-9)
    for tl, jl in zip(vgg_params_to_numpy(th["params"]), jh["params"]):
        for k in tl:
            np.testing.assert_allclose(tl[k], np.asarray(jl[k]), rtol=0,
                                       atol=1e-3, err_msg=k)


@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("bad", [-1, K + 1])
def test_cohort_size_outside_the_fleet_raises(loop, bad):
    clients, test, base = _testbed()
    with pytest.raises(ValueError, match="cohort_size"):
        LOOPS[loop][0](VGG5, clients, test,
                       FLConfig(**dict(base, rounds=1), cohort_size=bad),
                       device="cpu")


@pytest.mark.parametrize("loop", list(LOOPS))
def test_cohort_resume_bitwise(tmp_path, loop):
    """Checkpoint at 2 of 4, resume: the EFStore snapshot restores the
    touched rows and the keyed draws re-derive the cohorts (sync: for the
    loaders' fast-forward; async: the refills)."""
    clients, test, base = _testbed()
    over = dict(delta_density=0.25, quantize_deltas=True, cohort_size=2,
                checkpoint_every=2)
    run = LOOPS[loop][0]

    def cfg(sub, rounds=4):
        kw = dict(base, rounds=rounds, checkpoint_dir=str(tmp_path / sub),
                  **over)
        if loop == "async":
            kw.update(staleness_discount=0.5, buffer_size=1)
        return FLConfig(**kw)

    full = run(VGG5, clients, test, cfg("full"), device="cpu")
    if loop == "sync":
        run(VGG5, clients, test, cfg("resume", rounds=2), device="cpu")
        resumed = run(VGG5, clients, test, cfg("resume"), resume=True,
                      device="cpu")
    else:
        resumed = run(VGG5, clients, test, cfg("full"), resume=True,
                      device="cpu")
    tail = {k: (v[-2:] if k != "params" else v) for k, v in full.items()}
    _assert_bitwise(resumed, tail, KEYS[loop])
