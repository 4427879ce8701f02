"""The port's async runtime (``repro_torch.fl.async_loop``) and the sync
loop's checkpoint/resume, against the JAX package's and against
themselves.

Against the reference (VGG-5, K=3 or 4 devices of the paper testbed,
20 samples a client, batch 10, 2 local iterations, flip augmentation, from
the reference's ``PRNGKey(0)`` weights): ``ops``, ``times``,
``virtual_time``, ``staleness``, ``dropped`` and ``agg_weight_sum`` are
exact, being numpy arithmetic on identical inputs; ``accuracy`` is within
one test sample; final params within ``tests/test_torch_loop.py``'s atols,
1e-5 for the plain modes and 1e-3 where an int8 code or a top-k near-tie
can go the other way, or where a pre-activation near zero takes the
other side of a ReLU or max pool (the discrete step the loop tests' atol
of 1e-3 is for).  Observed (one intra-op thread, as the file runs):
sfl-OP1 (int8 cut, top-k 0.1, int8 deltas, buffer 2 of 3) 7.8e-4 after 2
aggregations; sfl-OP2 (K=4, buffer 2, discount 0.5, max_staleness 1, 5
aggregations, 1 drop) 5.4e-5: 1.2e-7 after the first aggregation, then a
jump to 1.9e-5 over 675 entries in the second.  With eight threads it
stays at 3.0e-7, and the port with one thread and with eight differ by
the same 1.9e-5 over 674 entries after two aggregations: convolution
rounding alone sends a value across a ReLU or max-pool boundary, a
discrete step, so the case takes the discrete-step atol 1e-3.

The int8/top-k drift compounds: that mode measured 2.9e-4, 7.8e-4, 9.5e-4
and 1.029e-3 after 1 to 4 aggregations (1.006e-3 with eight threads; the
int8 cut alone 3.5e-4 after 4, over 809 entries; top-k and int8 deltas
alone 3.2e-4): a
flipped cut code moves every gradient behind it a little, and top-k then
sends or keeps whole entries on either side of a near-tie.  So the whole
run is held for 2 aggregations, and aggregations 3 and 4 are each held
from the reference's checkpoint two aggregations before
(``test_later_aggregations_match_reference_from_its_checkpoints``: 9.0e-4
and 2.3e-4).
The runs resumed from a JAX-written checkpoint: 3.5e-4 (sync, 2 rounds of
the int8 cut and top-k 0.25) and 6.0e-8 (async).

Within the port, ``buffer_size=K`` with discount 0 is ``run_federated``
and a resumed run's suffix is the uninterrupted run's: both bitwise.
"""
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.vgg import VGG5 as J_VGG5
from repro.core.env import SimulatedCluster as JSim
from repro.core.testbed import paper_testbed as j_testbed
from repro.checkpoint import restore_tree as j_restore_tree
from repro.fl.async_loop import run_federated_async as j_run_async
from repro.fl.comm import Transport as JTransport
from repro.fl.comm import device_bandwidths as j_bw
from repro.fl.loop import FLConfig as JFLConfig
from repro.fl.loop import run_federated as j_run
from repro.models.split_program import get_split_program as j_program
from repro_torch.configs.vgg import VGG5
from repro_torch.convert import vgg_params_to_numpy
from repro_torch.core import costmodel as cm
from repro_torch.core.controller import FedAdaptController
from repro_torch.core.env import SimulatedCluster
from repro_torch.core.testbed import paper_testbed
from repro_torch.data import make_cifar_like, split_clients
from repro_torch.fl import async_loop
from repro_torch.fl.async_loop import run_federated_async, staleness_weights
from repro_torch.fl.comm import Transport, device_bandwidths
from repro_torch.fl.fedavg import fedavg_apply_deltas
from repro_torch.fl.flatbuf import FlatLayout
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


DEVICES = [0, 1, 4]          # jetson, a pi4 and the pi3 straggler
SMALL = dict(local_iters=2, batch_size=10, augment=True, seed=0)
ASYNC_MODES = {
    "sfl-op2-buffer2-maxstale1": dict(mode="sfl", static_op=4, rounds=5,
                                      buffer_size=2, staleness_discount=0.5,
                                      max_staleness=1),
    "sfl-op1-int8-topk-buffer2": dict(mode="sfl", static_op=2, rounds=2,
                                      quantize_transfer=True,
                                      delta_density=0.1, quantize_deltas=True,
                                      buffer_size=2, staleness_discount=0.5),
}
# the sfl-OP2 case crosses a ReLU / max-pool flip (see above): the
# discrete-step atol
PARAMS_ATOL = {"sfl-op2-buffer2-maxstale1": 1e-3,
               "sfl-op1-int8-topk-buffer2": 1e-3}
# the max_staleness case runs K=4 (both pi4s): with buffer 2 the pi3
# straggler then reports two versions late and is dropped
MODE_DEVICES = {"sfl-op2-buffer2-maxstale1": [0, 1, 2, 4],
                "sfl-op1-int8-topk-buffer2": DEVICES}
EXACT = ("ops", "times", "comm_time", "round_time", "virtual_time",
         "staleness", "dropped", "agg_weight_sum")
SUFFIX = ("accuracy", "virtual_time", "staleness", "round_time", "dropped",
          "agg_weight_sum", "ops", "times")


def _data(K=3, n=20):
    return (split_clients(make_cifar_like(n * K, seed=1), K),
            make_cifar_like(20, seed=2))


def _sims(devices=DEVICES):
    jw, jdev, jsrv, jovh = j_testbed(J_VGG5)
    tw, tdev, tsrv, tovh = paper_testbed(VGG5)
    jdev, tdev = [jdev[i] for i in devices], [tdev[i] for i in devices]
    jsim = JSim(jw, jdev, jsrv, J_VGG5.ops, iterations=2, jitter=0.05,
                seed=3, overhead_s=jovh)
    tsim = SimulatedCluster(tw, tdev, tsrv, VGG5.ops, iterations=2,
                            jitter=0.05, seed=3, overhead_s=tovh)
    return (jsim, JTransport(j_bw(jdev))), (tsim,
                                            Transport(device_bandwidths(tdev)))


def _init():
    return jax.tree_util.tree_map(
        np.asarray, j_program(J_VGG5).init(jax.random.PRNGKey(0)))


def _assert_matches(th, jh, atol, keys=EXACT):
    for key in keys:
        np.testing.assert_array_equal(th[key], jh[key], err_msg=key)
    n_test = 20
    assert np.all(np.abs(th["accuracy"] - jh["accuracy"])
                  <= 1 / n_test + 1e-9)
    for tl, jl in zip(vgg_params_to_numpy(th["params"]), jh["params"]):
        for k in tl:
            np.testing.assert_allclose(tl[k], np.asarray(jl[k]), rtol=0,
                                       atol=atol, err_msg=k)


def _assert_bitwise(a, b, keys):
    for key in keys:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for la, lb in zip(a["params"], b["params"]):
        for k in la:
            assert torch.equal(la[k], lb[k]), k


# =============================================================================
# staleness-aware weights
# =============================================================================
def test_staleness_weights_hand_computed():
    # sizes (1, 1, 2), staleness (0, 1, 3), a=1: raw (1, .5, .5)
    w = staleness_weights([1, 1, 2], [0, 1, 3], 1.0)
    np.testing.assert_allclose(w, [1.0, 0.5, 0.5])
    g = [{"w": torch.zeros(4)}]
    deltas = [[{"w": torch.full((4,), v)}] for v in (1.0, 2.0, 4.0)]
    out = fedavg_apply_deltas(g, deltas, w)
    # .5*1 + .25*2 + .25*4 = 2.0
    np.testing.assert_allclose(out[0]["w"].numpy(), 2.0, atol=1e-6)
    np.testing.assert_allclose(staleness_weights([3, 1], [5, 0], 0.0),
                               [3.0, 1.0])


# =============================================================================
# buffer_size=K, discount 0 is the sync loop
# =============================================================================
@pytest.mark.parametrize("over", [
    dict(delta_density=0.25, quantize_deltas=True),
    dict(delta_density=0.5, engine="batched", server_step="reference"),
    dict(),
], ids=["fused-topk-int8", "batched-reference-topk", "fused-plain"])
def test_buffer_k_equals_run_federated_bitwise(over):
    clients, test = _data()
    _, (tsim, ttr) = _sims()
    cfg = FLConfig(rounds=3, mode="sfl", static_op=2,
                   quantize_transfer=True, **SMALL, **over)
    hs = run_federated(VGG5, clients, test, cfg, sim=tsim, transport=ttr,
                       device="cpu")
    ha = run_federated_async(VGG5, clients, test, cfg, sim=tsim,
                             transport=ttr, device="cpu")
    _assert_bitwise(hs, ha, ("ops", "times", "accuracy", "comm_time",
                             "dropped"))
    np.testing.assert_allclose(ha["round_time"], hs["round_time"],
                               rtol=1e-12)
    np.testing.assert_allclose(ha["virtual_time"],
                               np.cumsum(hs["round_time"]), rtol=1e-12)
    assert (ha["staleness"] == 0).all() and (ha["agg_weight_sum"] == 1).all()
    assert len(ha["wall_s"]) == 3 and (ha["wall_s"] > 0).all()


# =============================================================================
# against the reference's run_federated_async
# =============================================================================
@pytest.mark.parametrize("mode", list(ASYNC_MODES))
def test_run_federated_async_matches_reference(mode):
    clients, test = _data(K=len(MODE_DEVICES[mode]))
    (jsim, jtr), (tsim, ttr) = _sims(MODE_DEVICES[mode])
    kw = dict(SMALL, **ASYNC_MODES[mode])
    jh = j_run_async(J_VGG5, clients, test, JFLConfig(**kw), sim=jsim,
                     transport=jtr)
    th = run_federated_async(VGG5, clients, test, FLConfig(**kw), sim=tsim,
                             transport=ttr, init_params=_init(),
                             device="cpu")
    assert len(th["accuracy"]) == kw["rounds"]
    assert th["staleness"].max() > 0          # the buffers interleave
    _assert_matches(th, jh, PARAMS_ATOL[mode])
    if "max_staleness" in kw:
        assert th["dropped"].sum() >= 1


@pytest.mark.parametrize("loop", ["sync", "async"])
def test_port_resumes_a_jax_written_checkpoint(tmp_path, loop):
    """The reference runs 4 rounds (aggregations), checkpointing every 2;
    the port resumes from its mid-run file and matches its last 2 rows."""
    clients, test = _data()
    (jsim, jtr), (tsim, ttr) = _sims()
    kw = dict(SMALL, mode="sfl", static_op=2, rounds=4,
              quantize_transfer=True, delta_density=0.25,
              checkpoint_every=2)
    if loop == "async":
        kw.update(buffer_size=2, staleness_discount=0.5)
    jckpt, tckpt = str(tmp_path / "jax"), str(tmp_path / "port")
    j_loop = j_run_async if loop == "async" else j_run
    t_loop = run_federated_async if loop == "async" else run_federated
    jh = j_loop(J_VGG5, clients, test,
                JFLConfig(checkpoint_dir=jckpt, **kw), sim=jsim,
                transport=jtr)
    # the port resumes from a copy of the reference's directory
    shutil.copytree(jckpt, tckpt)
    ckpts = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert ckpts[0] == "ckpt_00000002.npz"
    if loop == "sync":
        for p in ckpts[1:]:                  # keep the mid-run file only
            (tmp_path / "port" / p).unlink()
    th = t_loop(VGG5, clients, test, FLConfig(checkpoint_dir=tckpt, **kw),
                sim=tsim, transport=ttr, resume=True, init_params=_init(),
                device="cpu")
    assert len(th["accuracy"]) == 2
    suffix = {k: (v[-2:] if k != "params" else v) for k, v in jh.items()}
    keys = ("ops", "times", "round_time", "dropped") + (
        ("virtual_time", "staleness", "agg_weight_sum")
        if loop == "async" else ())
    _assert_matches(th, suffix, 1e-3, keys=keys)


def test_later_aggregations_match_reference_from_its_checkpoints(tmp_path):
    """The int8/top-k mode's aggregations 3 and 4, each from the reference's
    own state two aggregations before: the port resumes from the
    reference's checkpoint of version v (its in-flight rows trained by the
    reference) and makes aggregations v+1 (the reference's rows) and v+2
    (rows the port trained from the port's v+1), which must match the
    reference's."""
    clients, test = _data()
    (jsim, jtr), (tsim, ttr) = _sims()
    kw = dict(SMALL, **dict(ASYNC_MODES["sfl-op1-int8-topk-buffer2"],
                            rounds=4), checkpoint_every=1)
    jckpt = tmp_path / "jax"
    jh = j_run_async(J_VGG5, clients, test,
                     JFLConfig(checkpoint_dir=str(jckpt), **kw), sim=jsim,
                     transport=jtr)
    for v in (1, 2):
        step_dir = tmp_path / f"v{v}"
        step_dir.mkdir()
        name = f"ckpt_{v:08d}.npz"
        shutil.copy(jckpt / name, step_dir / name)
        th = run_federated_async(
            VGG5, clients, test,
            FLConfig(checkpoint_dir=str(step_dir), **dict(kw, rounds=v + 2)),
            sim=tsim, transport=ttr, resume=True, init_params=_init(),
            device="cpu")
        want = {k: (x[v:v + 2] if k != "params" else x)
                for k, x in jh.items()}
        if v + 2 < 4:
            want["params"] = j_restore_tree(
                str(jckpt / f"ckpt_{v + 2:08d}.npz"),
                {"params": jh["params"]})["params"]
        _assert_matches(th, want, PARAMS_ATOL["sfl-op1-int8-topk-buffer2"])


# =============================================================================
# the event loop's edges (twins of tests/test_async.py)
# =============================================================================
class FixedSim:
    """Hand-picked per-device durations: hand-computable clock traces."""

    iterations = 1

    def __init__(self, durations):
        self.durations = np.asarray(durations, np.float64)

    def bandwidths(self, round_idx):
        return np.full(len(self.durations), 75e6)

    def round_times(self, ops, round_idx):
        return self.durations.copy()


def _tiny(**kw):
    base = dict(local_iters=1, batch_size=10, mode="sfl", static_op=2,
                augment=False, seed=0)
    base.update(kw)
    return FLConfig(**base)


def test_virtual_clock_trace_hand_computed():
    clients, test = _data(n=30)
    h = run_federated_async(VGG5, clients, test,
                            _tiny(rounds=6, buffer_size=1,
                                  staleness_discount=0.5),
                            sim=FixedSim([1.0, 2.0, 7.0]), device="cpu")
    # t=1: A(v0, s=0) -> v1 | t=2: B(v0, s=1) -> v2 | t=2: A(v1, s=1) -> v3
    # t=3: A(v3, s=0) -> v4 | t=4: B(v2, s=2) -> v5 | t=4: A(v4, s=1) -> v6
    np.testing.assert_allclose(h["virtual_time"], [1, 2, 2, 3, 4, 4])
    np.testing.assert_allclose(h["staleness"], [0, 1, 1, 0, 2, 1])
    np.testing.assert_allclose(h["round_time"], [1, 1, 0, 1, 1, 0])
    assert (h["dropped"] == 0).all() and (h["edge_time"] == 0).all()


def test_max_staleness_drops_updates():
    clients, test = _data(n=30)
    h = run_federated_async(VGG5, clients, test,
                            _tiny(rounds=40, buffer_size=1,
                                  staleness_discount=1.0, max_staleness=3),
                            sim=FixedSim([1.0, 1.1, 20.0]), device="cpu")
    assert h["dropped"].sum() >= 1
    assert h["staleness"].max() <= 3
    assert len(h["accuracy"]) == 40
    # a buffer holding only the discarded report applies nothing
    assert set(h["agg_weight_sum"][h["dropped"] > 0]) == {0.0}


def test_partial_buffer_flushed_when_dead_links_shrink_the_fleet():
    """buffer_size=K with one dead link: the live clients' reports are
    flushed, not discarded, and the run makes all its aggregations."""
    clients, test = _data(n=40)
    h = run_federated_async(
        VGG5, clients, test, _tiny(rounds=4),
        transport=Transport(lambda r, d: 0.0 if d == 2 else 75e6),
        device="cpu")
    assert len(h["accuracy"]) == 4
    assert np.isfinite(h["virtual_time"]).all()
    assert np.isinf(h["times"][-1, 2])
    assert h["accuracy"][-1] > h["accuracy"][0] - 0.05


def test_stalled_fleet_ends_early():
    clients, test = _data(K=2, n=30)
    h = run_federated_async(VGG5, clients, test, _tiny(rounds=5),
                            transport=Transport(lambda r, d: 0.0),
                            device="cpu")
    assert len(h["accuracy"]) == 0 and "params" in h


@pytest.mark.parametrize("bad", [dict(deadline_factor=2.0),
                                 dict(fail_prob=0.5), dict(buffer_size=3),
                                 dict(cohort_size=3)])
def test_sync_only_and_out_of_range_knobs_rejected(bad):
    clients, test = _data(K=2, n=30)
    with pytest.raises(ValueError):
        run_federated_async(VGG5, clients, test, _tiny(rounds=1, **bad),
                            device="cpu")


@pytest.mark.parametrize("knob,value,item", [
    ("mesh_shape", (1, 1), "multi-device")])
def test_unported_knobs_raise_naming_their_item(knob, value, item):
    """The knobs the port did not run raised ``NotImplementedError``
    naming their ROADMAP item; ``mesh_shape`` ("multi-device") now runs,
    and no port source names the item any more."""
    clients, test = _data(K=2, n=30)
    h = run_federated_async(VGG5, clients, test,
                            _tiny(rounds=1, **{knob: value}), device="cpu")
    assert len(h["accuracy"]) == 1
    port = Path(async_loop.__file__).resolve().parents[1]
    assert not [p for p in port.rglob("*.py")
                if f'"{item}"' in p.read_text()]


def test_checkpoint_requires_an_exact_fp32_layout(monkeypatch, tmp_path):
    class Lossy(async_loop.FlatLayout):
        def __init__(self, params):
            super().__init__(params)
            self.exact_fp32 = False

    monkeypatch.setattr(async_loop, "FlatLayout", Lossy)
    clients, test = _data(n=30)
    with pytest.raises(ValueError, match="fp32"):
        run_federated_async(VGG5, clients, test,
                            _tiny(rounds=1, checkpoint_dir=str(tmp_path)),
                            device="cpu")


def test_on_aggregate_sees_every_version():
    clients, test = _data(n=30)
    seen = []
    h = run_federated_async(
        VGG5, clients, test, _tiny(rounds=3, buffer_size=2),
        sim=FixedSim([1.0, 2.0, 3.0]), device="cpu",
        on_aggregate=lambda v, p, g_flat: seen.append((v, g_flat.clone())))
    assert [v for v, _ in seen] == [1, 2, 3]
    assert torch.equal(seen[-1][1],
                       FlatLayout(h["params"]).flatten(h["params"]))


def test_entry_points_need_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    from repro_torch.fl.cohort import EFStore
    from repro_torch.runtime.chaos import ChaosScript, run_chaos_drill
    clients, test = _data(K=2, n=30)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_federated_async(VGG5, clients, test, _tiny(rounds=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_chaos_drill(VGG5, clients, test, _tiny(rounds=1),
                        ChaosScript.flapping(2, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        EFStore(4, 1024)


# =============================================================================
# resume within the port: bitwise
# =============================================================================
def _testbed_sim(jitter=0.0, seed=0):
    w = cm.vgg_workload(VGG5, batch_size=20)
    devices = [cm.DeviceProfile("fast", 4e9, 75e6),
               cm.DeviceProfile("mid", 2e9, 75e6),
               cm.DeviceProfile("slow", 5e8, 75e6)]
    return SimulatedCluster(w, devices, 8e9, VGG5.ops, iterations=2,
                            jitter=jitter, seed=seed)


@pytest.mark.parametrize("over", [
    dict(mode="sfl", static_op=2, augment=True, delta_density=0.5),
    dict(mode="fl", fail_prob=0.4),
    dict(mode="sfl", static_op=2, quantize_transfer=True, delta_density=0.1,
         quantize_deltas=True, engine="batched", server_step="reference"),
], ids=["jittered-topk", "failure-masks", "batched-reference-int8-topk"])
def test_sync_resume_bitwise(tmp_path, over):
    """Checkpoint at round 3 of 6 and resume: the suffix is the
    uninterrupted run's, bitwise (the loaders replay the draws of the
    rounds each client was alive in)."""
    clients, test = _data(n=40)
    base = dict(local_iters=2, batch_size=20, augment=False, seed=0)
    base.update(over)
    sim = _testbed_sim(jitter=0.2, seed=3)
    full = run_federated(VGG5, clients, test, FLConfig(rounds=6, **base),
                         sim=sim, device="cpu")
    ck = str(tmp_path / "ck")
    run_federated(VGG5, clients, test,
                  FLConfig(rounds=3, checkpoint_dir=ck, checkpoint_every=3,
                           **base), sim=sim, device="cpu")
    resumed = run_federated(VGG5, clients, test,
                            FLConfig(rounds=6, checkpoint_dir=ck,
                                     checkpoint_every=3, **base),
                            sim=sim, resume=True, device="cpu")
    assert len(resumed["accuracy"]) == 3
    tail = {k: (v[-3:] if k != "params" else v) for k, v in full.items()}
    _assert_bitwise(resumed, tail, ("accuracy", "times", "round_time",
                                    "dropped", "ops"))


def test_fedadapt_controller_state_survives_resume(tmp_path):
    w = cm.vgg_workload(VGG5, batch_size=20)

    def make():
        ctl = FedAdaptController(w, VGG5.ops, num_groups=2,
                                 low_bw_threshold=None, seed=0, device="cpu")
        return _testbed_sim(), ctl

    clients, test = _data(n=40)
    base = dict(local_iters=2, batch_size=20, mode="fedadapt", augment=False,
                seed=0)
    sim, ctl = make()
    full = run_federated(VGG5, clients, test, FLConfig(rounds=4, **base),
                         sim=sim, controller=ctl, device="cpu")
    ck = str(tmp_path / "ck")
    sim, ctl = make()
    run_federated(VGG5, clients, test,
                  FLConfig(rounds=2, checkpoint_dir=ck, checkpoint_every=2,
                           **base), sim=sim, controller=ctl, device="cpu")
    sim, ctl = make()
    resumed = run_federated(VGG5, clients, test,
                            FLConfig(rounds=4, checkpoint_dir=ck,
                                     checkpoint_every=2, **base),
                            sim=sim, controller=ctl, resume=True,
                            device="cpu")
    np.testing.assert_array_equal(resumed["ops"], full["ops"][-2:])
    np.testing.assert_array_equal(resumed["accuracy"], full["accuracy"][-2:])


@pytest.mark.parametrize("over", [
    dict(quantize_transfer=True, delta_density=0.1, quantize_deltas=True),
    dict(server_step="reference", delta_density=0.5),
], ids=["fused-int8-topk", "reference-topk"])
def test_async_resume_bitwise(tmp_path, over):
    """Checkpoint at version 3 of 6 (buffer 2 of 3, discount 0.5), resume:
    the suffix is the uninterrupted run's, bitwise."""
    clients, test = _data()
    _, (tsim, ttr) = _sims()
    cfg = FLConfig(rounds=6, mode="sfl", static_op=2, buffer_size=2,
                   staleness_discount=0.5, checkpoint_dir=str(tmp_path),
                   checkpoint_every=3, **SMALL, **over)
    full = run_federated_async(VGG5, clients, test, cfg, sim=tsim,
                               transport=ttr, device="cpu")
    assert [p.name for p in tmp_path.iterdir()] == ["ckpt_00000003.npz"]
    resumed = run_federated_async(VGG5, clients, test, cfg,
                                  sim=tsim, transport=ttr, resume=True,
                                  device="cpu")
    tail = {k: (v[-3:] if k != "params" else v) for k, v in full.items()}
    _assert_bitwise(resumed, tail, SUFFIX + ("comm_time",))
    assert full["staleness"].max() > 0
