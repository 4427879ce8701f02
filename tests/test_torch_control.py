"""The port's control plane and data pipeline against the JAX reference:
numpy streams and Eq. 1 arithmetic are exact, and the deployed FedAdapt
controller picks the same OPs from carried agent params."""
import jax
import numpy as np
import pytest

from repro.configs.vgg import VGG5 as J_VGG5, VGG8 as J_VGG8
from repro.core import clustering as jcl
from repro.core import costmodel as jcm
from repro.core import offload as joff
from repro.core.agent import PPOAgent as JAgent, PPOConfig as JPPOConfig
from repro.core.controller import FedAdaptController as JController
from repro.core.env import SimulatedCluster as JSim
from repro.core.testbed import paper_testbed as j_testbed
from repro.data.loader import FleetLoader as JFleetLoader
from repro.data.synthetic import make_cifar_like as j_make, split_clients
from repro.fl.comm import Transport as JTransport, paper_schedule as j_sched
from repro.fl.fleet import flip_augment as j_flip
from repro.fl.planner import GreedyPlanner as JGreedy
from repro.runtime.failures import FailureInjector as JInjector
from repro.runtime.straggler import deadline_mask as j_deadline
from repro.runtime.straggler import reweight as j_reweight
from repro_torch.configs.vgg import VGG5, VGG8
from repro_torch.convert import agent_params_from_numpy
from repro_torch.core import clustering as tcl
from repro_torch.core import costmodel as tcm
from repro_torch.core import offload as toff
from repro_torch.core.agent import PPOAgent, PPOConfig
from repro_torch.core.controller import FedAdaptController
from repro_torch.core.env import SimulatedCluster
from repro_torch.core.testbed import paper_testbed
from repro_torch.data import FleetLoader, make_cifar_like
from repro_torch.fl.comm import Transport, paper_schedule
from repro_torch.fl.fleet import flip_augment
from repro_torch.fl.planner import FedAdaptPlanner, GreedyPlanner
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.straggler import deadline_mask, reweight


def test_data_streams_are_byte_identical():
    a, b = make_cifar_like(90, seed=4), j_make(90, seed=4)
    for k in ("images", "labels"):
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    clients = split_clients(b, 3)
    tl, jl = FleetLoader(clients, 8, seed=5), \
        JFleetLoader.for_clients(clients, 8, seed=5)
    for step in range(9):                      # crosses epoch boundaries
        for k in (2, 0, 1):
            x, y = tl.next_batch(k), jl.next_batch(k)
            for key in x:
                assert x[key].tobytes() == y[key].tobytes()
            assert flip_augment(x["images"], 5, step, k, 1).tobytes() == \
                j_flip(y["images"], 5, step, k, 1).tobytes()


@pytest.mark.parametrize("name", ["vgg5", "vgg8"])
def test_testbed_and_eq1_times_are_exact(name):
    tcfg, jcfg = {"vgg5": (VGG5, J_VGG5), "vgg8": (VGG8, J_VGG8)}[name]
    tw, tdev, tsrv, tovh = paper_testbed(tcfg)
    jw, jdev, jsrv, jovh = j_testbed(jcfg)
    np.testing.assert_array_equal(tw.layer_flops, jw.layer_flops)
    np.testing.assert_array_equal(tw.cut_bytes, jw.cut_bytes)
    assert (tsrv, tovh) == (jsrv, jovh)
    assert [(d.name, d.flops_per_s, d.bandwidth_bps) for d in tdev] == \
        [(d.name, d.flops_per_s, d.bandwidth_bps) for d in jdev]
    assert toff.op_fractions(tw, tcfg.ops).tolist() == \
        joff.op_fractions(jw, jcfg.ops).tolist()
    ops = [tcfg.ops[i % 4] for i in range(5)]
    np.testing.assert_array_equal(
        tcm.round_times(tw, ops, tdev, tsrv, 7, tovh),
        jcm.round_times(jw, ops, jdev, jsrv, 7, jovh))
    for jitter, sched in [(0.0, None), (0.05, (10e6, 2, 1))]:
        kw = dict(iterations=5, jitter=jitter, seed=3, overhead_s=tovh)
        tsim = SimulatedCluster(
            tw, tdev, tsrv, tcfg.ops, **kw,
            bandwidth_fn=paper_schedule(75e6, *sched) if sched else None)
        jsim = JSim(jw, jdev, jsrv, jcfg.ops, **kw,
                    bandwidth_fn=j_sched(75e6, *sched) if sched else None)
        for r in range(6):
            np.testing.assert_array_equal(tsim.bandwidths(r),
                                          jsim.bandwidths(r))
            np.testing.assert_array_equal(tsim.round_times(ops, r),
                                          jsim.round_times(ops, r))
            np.testing.assert_array_equal(tsim.round_compute_times(ops, r),
                                          jsim.round_compute_times(ops, r))


def test_kmeans_and_grouping_are_exact():
    rng = np.random.RandomState(0)
    for K in (3, 5, 12):
        pts = rng.rand(K, 1)
        for k in (1, 2, 3):
            tc, ta = tcl.kmeans(pts, k, seed=K)
            jc, ja = jcl.kmeans(pts, k, seed=K)
            np.testing.assert_array_equal(tc, jc)
            np.testing.assert_array_equal(ta, ja)
        assert tcl.elbow(pts) == jcl.elbow(pts)
        times, bw = rng.rand(K) * 5, rng.choice([10e6, 75e6], K)
        for groups, low in [(None, None), (2, 25e6)]:
            tg = tcl.cluster_devices(times, bw, groups, low)
            jg = jcl.cluster_devices(times, bw, groups, low)
            np.testing.assert_array_equal(tg.assignments, jg.assignments)
            np.testing.assert_array_equal(tg.representative, jg.representative)
            np.testing.assert_array_equal(tg.centers, jg.centers)
            assert tg.low_bw_group == jg.low_bw_group


def test_controller_plans_identical_ops_from_carried_agent():
    tw, tdev, tsrv, tovh = paper_testbed(VGG5)
    jw, jdev, jsrv, jovh = j_testbed(J_VGG5)
    for seed, low in [(0, 25e6), (1, None), (2, 25e6)]:
        jagent = JAgent(JPPOConfig(num_groups=3), seed=seed)
        agent = PPOAgent(PPOConfig(num_groups=3),
                         params=agent_params_from_numpy(jax.tree_util.tree_map(
                             np.asarray, jagent.params), device="cpu"))
        jctl = JController(jw, J_VGG5.ops, 3, low_bw_threshold=low,
                           agent=jagent)
        tctl = FedAdaptController(tw, VGG5.ops, 3, low_bw_threshold=low,
                                  agent=agent)
        tsim = SimulatedCluster(tw, tdev, tsrv, VGG5.ops, iterations=5,
                                jitter=0.05, seed=seed, overhead_s=tovh,
                                bandwidth_fn=paper_schedule(75e6, 10e6, 2, 1))
        base = tsim.round_times(tsim.native_ops(), 0)
        jctl.begin(base)
        tctl.begin(base)
        times = base
        for r in range(1, 8):
            bw = tsim.bandwidths(r)
            jp = jctl.plan(times, bw, explore=False)
            tp = tctl.plan(times, bw, explore=False)
            assert tp.ops == jp.ops
            # the actor's fp32 matmuls may round differently (rtol 1e-6);
            # the obs carries the previous actions, its time half is exact
            np.testing.assert_allclose(tp.actions, jp.actions, rtol=1e-6)
            np.testing.assert_array_equal(tp.obs[:3], jp.obs[:3])
            np.testing.assert_allclose(tp.obs, jp.obs, rtol=1e-6)
            times = tsim.round_times(tp.ops, r)
            assert tctl.feedback(times) == jctl.feedback(times)


def test_greedy_planner_transport_and_straggler_rules_are_exact():
    tw, tdev, tsrv, tovh = paper_testbed(VGG5)
    jw, jdev, jsrv, jovh = j_testbed(J_VGG5)
    speeds = [d.flops_per_s for d in tdev]
    bw = [75e6, 10e6, 25e6, 50e6, 1e6]
    tg = GreedyPlanner(tw, VGG5.ops, speeds, tsrv, tovh)
    jg = JGreedy(jw, J_VGG5.ops, speeds, jsrv, jovh)
    assert tg.plan(0, [1.0] * 5, bw) == jg.plan(0, [1.0] * 5, bw)
    tt = Transport(lambda r, d: bw[d], latency_s=0.01)
    jt = JTransport(lambda r, d: bw[d], latency_s=0.01)
    for d in range(5):
        assert tt.round_comm_time(3e5, 2e6, 1, d) == \
            jt.round_comm_time(3e5, 2e6, 1, d)
    times = np.asarray([1.0, 2.5, 9.0, np.inf, 1.5])
    np.testing.assert_array_equal(deadline_mask(times, 2.0),
                                  j_deadline(times, 2.0))
    m = deadline_mask(times, 2.0)
    np.testing.assert_array_equal(reweight([1, 2, 3, 4, 5], m),
                                  j_reweight([1, 2, 3, 4, 5], m))
    for r in range(5):
        np.testing.assert_array_equal(
            FailureInjector(0.4, seed=9).round_mask(6, round_idx=r),
            JInjector(0.4, seed=9).round_mask(6, round_idx=r))


def test_exploration_is_not_ported_and_says_so():
    tw, *_ = paper_testbed(VGG5)
    ctl = FedAdaptController(tw, VGG5.ops, 3)
    times = [1.0, 2.0, 3.0, 4.0, 5.0]
    ctl.begin(times)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ctl.plan(times, [75e6] * 5, explore=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FedAdaptPlanner(ctl, explore=True)
