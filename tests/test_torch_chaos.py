"""Chaos drills (``repro_torch.runtime.chaos``) and elastic membership
(``runtime/elastic.py``) against the JAX package's: twins of
tests/test_chaos.py, plus the scripts and a drill's history against the
reference's.

The scripts' ``up`` / ``slow`` tables and ``check_invariants`` are exact
copies (numpy draws on the same seeds).  A drill against the reference's
(VGG-5, K=3, 40 samples a client, batch 10, one local iteration, buffer 2,
discount 0.5, from the reference's ``PRNGKey(0)`` weights): OPs, times,
virtual clock, staleness, drops and weight mass exact, accuracy within one
test sample, final params within 1e-5 (plain averaging; observed with one
intra-op thread, as the file runs: 3.6e-7 combined, 1.7e-6 straggler
storm).  Within the port a drill replays
bitwise, from the seed and from a mid-drill checkpoint.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.vgg import VGG5 as J_VGG5
from repro.fl.loop import FLConfig as JFLConfig
from repro.models.split_program import get_split_program as j_program
from repro.runtime.chaos import ChaosScript as JChaosScript
from repro.runtime.chaos import check_invariants as j_check_invariants
from repro.runtime.chaos import run_chaos_drill as j_run_chaos_drill
from repro_torch.configs.vgg import VGG5
from repro_torch.convert import vgg_params_to_numpy
from repro_torch.core import costmodel as cm
from repro_torch.core.controller import FedAdaptController
from repro_torch.data import make_cifar_like, split_clients
from repro_torch.fl.loop import FLConfig
from repro_torch.runtime.chaos import (ChaosScript, ScriptedCluster,
                                       check_invariants, run_chaos_drill)
from repro_torch.runtime.elastic import admit_client, remove_client


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for these small runs: test workers running side
    by side then do not oversubscribe the cores (eight threads a worker
    made the files ~20x slower in parallel than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


K = 3
SCENARIOS = ["flapping", "mass_waves", "straggler_storm", "combined"]
KEYS = ("accuracy", "virtual_time", "staleness", "round_time", "dropped",
        "agg_weight_sum")


def _data(num_clients=K, n=120, seed=0):
    return (split_clients(make_cifar_like(n, seed=seed), num_clients),
            make_cifar_like(40, seed=9))


def _kw(**kw):
    base = dict(rounds=6, local_iters=1, batch_size=10, mode="sfl",
                static_op=2, augment=False, seed=0, buffer_size=2,
                staleness_discount=0.5)
    base.update(kw)
    return base


def _fl(**kw):
    return FLConfig(**_kw(**kw))


def _drill(clients, test, fl, script, **kw):
    return run_chaos_drill(VGG5, clients, test, fl, script, device="cpu",
                           **kw)


def _assert_bitwise(a, b, keys=KEYS):
    for key in keys:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for la, lb in zip(a["params"], b["params"]):
        for k in la:
            assert torch.equal(la[k], lb[k]), k


# =============================================================================
# scripts are the reference's data
# =============================================================================
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scripts_equal_the_references(scenario):
    for K_, rounds, seed in [(5, 20, 3), (3, 6, 7), (8, 12, 0)]:
        a = getattr(ChaosScript, scenario)(K_, rounds, seed=seed)
        j = getattr(JChaosScript, scenario)(K_, rounds, seed=seed)
        np.testing.assert_array_equal(a.up, j.up)
        np.testing.assert_array_equal(a.slow, j.slow)
        assert a.name == j.name and a.up.any(axis=1).all()
        for r in (0, 2, rounds + 5):
            np.testing.assert_array_equal(a.bandwidths(r), j.bandwidths(r))
            np.testing.assert_array_equal(a.slow_factors(r),
                                          j.slow_factors(r))


def test_script_lookups_validation_and_cluster():
    s = ChaosScript.flapping(4, 10, seed=0, p_down=0.5, base_bps=50e6)
    np.testing.assert_array_equal(s.bandwidths(2),
                                  np.where(s.up[2], 50e6, 0.0))
    np.testing.assert_array_equal(s.bandwidths(99), s.bandwidths(9))
    np.testing.assert_array_equal(s.slow_factors(-5), s.slow_factors(0))
    down = int(np.flatnonzero(~s.up[2])[0])
    assert s.transport().transfer_time(1e6, 2, down) == np.inf
    with pytest.raises(ValueError):
        ChaosScript(np.ones((3, 2), bool), np.ones((2, 2)))
    with pytest.raises(ValueError):
        ChaosScript(np.zeros((2, 3), bool), np.ones((2, 3)))
    with pytest.raises(ValueError):
        ChaosScript(np.ones((2, 3), bool), np.full((2, 3), 0.5))
    storm = ChaosScript.straggler_storm(3, 8, seed=0, slow_factor=4.0,
                                        storm_len=8, period=8)
    sim = ScriptedCluster([1.0, 2.0, 3.0], storm)
    np.testing.assert_allclose(sim.round_compute_times(None, 0),
                               np.array([1.0, 2.0, 3.0])
                               * storm.slow_factors(0))
    np.testing.assert_array_equal(sim.round_times(None, 0),
                                  sim.round_compute_times(None, 0))
    with pytest.raises(ValueError):
        ScriptedCluster([1.0], storm)


def test_check_invariants_flags_corruption():
    hist = {"accuracy": np.array([0.3, 0.4]),
            "virtual_time": np.array([1.0, 2.0]),
            "round_time": np.array([1.0, 1.0]),
            "staleness": np.array([0.0, 1.0]),
            "agg_weight_sum": np.array([1.0, 1.0]),
            "dropped": np.array([0, 1])}
    bad = [dict(hist, virtual_time=np.array([2.0, 1.0])),
           dict(hist, staleness=np.array([-1.0, 0.0])),
           dict(hist, agg_weight_sum=np.array([0.7, 1.0])),
           dict(hist, dropped=np.array([0, 5])),
           dict(hist, accuracy=np.array([0.3, np.nan])),
           dict(hist, round_time=np.array([1.0, -1.0])),
           {"accuracy": []}]
    assert check_invariants(hist, 3) == []
    for h, word in zip(bad, ["backwards", "staleness", "mass", "drop count",
                             "non-finite", "wall time", "no aggregations"]):
        got = check_invariants(h, 3)
        assert any(word in m for m in got), (word, got)
        assert got == j_check_invariants(h, 3)


# =============================================================================
# drills
# =============================================================================
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_drill_survives_and_replays_bitwise(scenario):
    clients, test = _data()
    script = getattr(ChaosScript, scenario)(K, 6, seed=1)
    res = _drill(clients, test, _fl(), script)
    assert res.ok(), res.violations
    assert len(res.history["accuracy"]) == 6
    _assert_bitwise(res.history,
                    _drill(clients, test, _fl(), script).history)


@pytest.mark.parametrize("scenario", ["combined", "straggler_storm"])
def test_drill_matches_the_reference(scenario):
    clients, test = _data()
    script = getattr(ChaosScript, scenario)(K, 6, seed=7)
    jres = j_run_chaos_drill(J_VGG5, clients, test, JFLConfig(**_kw()),
                             getattr(JChaosScript, scenario)(K, 6, seed=7))
    init = jax.tree_util.tree_map(
        np.asarray, j_program(J_VGG5).init(jax.random.PRNGKey(0)))
    res = _drill(clients, test, _fl(), script, init_params=init)
    assert res.ok() and jres.ok()
    th, jh = res.history, jres.history
    for key in ("ops", "times", "comm_time", "round_time", "virtual_time",
                "staleness", "dropped", "agg_weight_sum"):
        np.testing.assert_array_equal(th[key], jh[key], err_msg=key)
    assert np.all(np.abs(th["accuracy"] - jh["accuracy"]) <= 1 / 40 + 1e-9)
    for tl, jl in zip(vgg_params_to_numpy(th["params"]), jh["params"]):
        for k in tl:
            np.testing.assert_allclose(tl[k], np.asarray(jl[k]), rtol=0,
                                       atol=1e-5, err_msg=k)


def test_drill_per_engine_batched():
    clients, test = _data()
    res = _drill(clients, test, _fl(engine="batched"),
                 ChaosScript.combined(K, 6, seed=2))
    assert res.ok(), res.violations
    assert np.isfinite(res.history["accuracy"]).all()


def test_drill_with_permanently_dead_link():
    up = np.ones((6, K), bool)
    up[:, 0] = False
    clients, test = _data()
    res = _drill(clients, test, _fl(),
                 ChaosScript(up, np.ones_like(up, np.float64)))
    assert res.ok(), res.violations
    assert len(res.history["accuracy"]) == 6
    assert np.isinf(res.history["times"][:, 0]).all()


def test_drill_rejects_mismatched_fleet():
    clients, test = _data()
    with pytest.raises(ValueError, match="script is for"):
        _drill(clients, test, _fl(), ChaosScript.flapping(K + 2, 6, seed=0))


def test_drill_resumes_bitwise_from_mid_drill_checkpoint(tmp_path):
    """The coordinator dies at version 3 of 6 and resumes from its atomic
    checkpoint: the suffix is the uninterrupted drill's, bitwise."""
    clients, test = _data()
    script = ChaosScript.combined(K, 6, seed=7)
    fl = _fl(checkpoint_dir=str(tmp_path / "drill_ck"), checkpoint_every=3,
             delta_density=0.25)
    full = _drill(clients, test, fl, script)
    assert full.ok(), full.violations
    resumed = _drill(clients, test, fl, script, resume=True)
    assert resumed.ok(), resumed.violations
    assert len(resumed.history["accuracy"]) == 3
    tail = {k: (v[-3:] if k != "params" else v)
            for k, v in full.history.items()}
    _assert_bitwise(resumed.history, tail, KEYS + ("ops", "times"))


def test_elastic_membership_between_drill_segments():
    """A FedAdapt fleet grows and shrinks between drill segments: the
    controller's baselines track membership, every segment keeps the
    invariants."""
    w = cm.vgg_workload(VGG5, batch_size=10)
    ctl = FedAdaptController(w, VGG5.ops, num_groups=2,
                             low_bw_threshold=None, seed=0, device="cpu")
    ctl.begin([1.0, 1.5, 2.0])
    clients3, test = _data(num_clients=K)
    fl = _fl(mode="fedadapt", rounds=4)
    res = _drill(clients3, test, fl, ChaosScript.flapping(K, 4, seed=1),
                 controller=ctl)
    assert res.ok(), res.violations
    idx = admit_client(ctl, baseline_time=2.5)
    assert idx == 3 and len(ctl.baselines) == 4
    clients4, _ = _data(num_clients=4, n=160)
    res = _drill(clients4, test, fl, ChaosScript.flapping(4, 4, seed=2),
                 controller=ctl)
    assert res.ok(), res.violations
    remove_client(ctl, 1)
    np.testing.assert_array_equal(ctl.baselines, [1.0, 2.0, 2.5])
    res = _drill(clients3, test, fl, ChaosScript.flapping(K, 4, seed=3),
                 controller=ctl)
    assert res.ok(), res.violations
