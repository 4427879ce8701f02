"""The port's PPO training half against the JAX reference
(``repro/core/agent.py``, ``repro/core/controller.py``).

Initial params come from the reference (``convert.agent_params_from_numpy``)
and the exploration noise is the reference's own threefry stream: the
agent's key is split once for its init and once per exploring act
(``agent.py:210-211,235``), and the test replays those splits with JAX and
injects the draws (``PPOAgent(noise=...)``).  Everything else is numpy and
identical on both sides.  Tolerances, stated per check:

* log-probs, GAE advantages, the loss: 1e-6 (fp32 rounding of the MLPs);
* one 50-epoch update: params within 1e-5 (observed 2e-6; 50 AdamW steps
  whose 1e-8 denominators amplify the loss's last-bit differences);
* training: actions within 1e-5 (observed 1.3e-7 after 350 rounds) and
  OPs exact.  Over the 350 rounds of the end-to-end twin no action came
  near enough an OP boundary for the two to part: every round's OPs are
  equal, which the test checks.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.vgg import VGG5 as J_VGG5
from repro.core import agent as jag
from repro.core.controller import FedAdaptController as JController
from repro.core.controller import run_fl_with_controller as j_deploy
from repro.core.controller import train_rl_agent as j_train
from repro.core.env import SimulatedCluster as JSim
from repro.core.testbed import paper_testbed as j_testbed
from repro_torch.configs.vgg import VGG5
from repro_torch.convert import agent_params_from_numpy
from repro_torch.core import agent as tag
from repro_torch.core.controller import (FedAdaptController,
                                         run_fl_with_controller,
                                         train_rl_agent)
from repro_torch.core.env import SimulatedCluster
from repro_torch.core.testbed import paper_testbed
from repro_torch.fl.planner import FedAdaptPlanner
from repro_torch.tree import tree_leaves

FP32_ATOL = 1e-6
UPDATE_ATOL = 1e-5
ACTION_ATOL = 1e-5


def reference_noise(seed: int):
    """The reference agent's exploration draws: PRNGKey(seed), one split
    for the init, then one split and one normal per exploring act."""
    key = [jax.random.split(jax.random.PRNGKey(seed))[0]]

    def draw(shape):
        key[0], sub = jax.random.split(key[0])
        return np.asarray(jax.random.normal(sub, shape))
    return draw


def _np(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _ported(params):
    return agent_params_from_numpy(_np(params), device="cpu")


def _assert_params_close(tparams, jparams, atol):
    jl, tl = jax.tree_util.tree_leaves(jparams), tree_leaves(tparams)
    assert len(jl) == len(tl) == 12
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=atol)


def _trajectory(rng, T, G, factored):
    obs = rng.rand(T, 2 * G).astype(np.float32)
    rewards = (rng.randn(T, G) if factored else rng.randn(T)) \
        .astype(np.float32)
    return (obs, rng.rand(T, G).astype(np.float32),
            (rng.randn(T, G) * 0.3 - 0.5).astype(np.float32), rewards,
            np.roll(obs, -1, axis=0))


@pytest.mark.parametrize("factored", [False, True])
def test_log_prob_gae_and_loss_match_reference(factored):
    G = 3
    cfg_j = jag.PPOConfig(num_groups=G, factored=factored)
    cfg_t = tag.PPOConfig(num_groups=G, factored=factored)
    jparams = jag.init_agent(cfg_j, jax.random.PRNGKey(5))
    tparams = _ported(jparams)
    rng = np.random.RandomState(7 + factored)
    traj = _trajectory(rng, 10, G, factored)
    jt = jag.Trajectory(*map(jax.numpy.asarray, traj))
    tt = tag.Trajectory(*map(torch.from_numpy, traj))
    for std in (0.5, 0.02):
        mean = rng.rand(4, G).astype(np.float32)
        raw = (mean + rng.randn(4, G) * std).astype(np.float32)
        np.testing.assert_allclose(
            tag._log_prob_dims(torch.from_numpy(mean), std,
                               torch.from_numpy(raw)).numpy(),
            np.asarray(jag._log_prob_dims(mean, std, raw)), rtol=0,
            atol=FP32_ATOL)
        np.testing.assert_allclose(
            tag._log_prob(torch.from_numpy(mean), std,
                          torch.from_numpy(raw)).numpy(),
            np.asarray(jag._log_prob(mean, std, raw)), rtol=0,
            atol=FP32_ATOL)
    np.testing.assert_allclose(
        tag.critic_value(cfg_t, tparams, tt.obs).numpy(),
        np.asarray(jag.critic_value(cfg_j, jparams, jt.obs)), rtol=0,
        atol=FP32_ATOL)
    jadv, jtarget = jag.gae_advantages(cfg_j, jparams, jt)
    tadv, ttarget = tag.gae_advantages(cfg_t, tparams, tt)
    assert tadv.shape == jadv.shape == ((10, G) if factored else (10,))
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), rtol=0,
                               atol=FP32_ATOL)
    np.testing.assert_allclose(ttarget.numpy(), np.asarray(jtarget), rtol=0,
                               atol=FP32_ATOL)
    for std in (0.5, 0.3):
        jl = jag.ppo_loss(cfg_j, jparams, jt, jadv, jtarget, std)
        tl = tag.ppo_loss(cfg_t, tparams, tt, tadv, ttarget, std)
        np.testing.assert_allclose(float(tl), float(jl), rtol=0,
                                   atol=FP32_ATOL)
    assert tag.current_std(cfg_t, 250) == jag.current_std(cfg_j, 250)


@pytest.mark.parametrize("factored", [False, True])
def test_one_update_matches_reference(factored):
    """One ``make_update_fn`` call (50 epochs, advantages recomputed each
    epoch, AdamW with clip 0.5) from shared params and trajectory."""
    G = 3
    cfg_j = jag.PPOConfig(num_groups=G, factored=factored)
    cfg_t = tag.PPOConfig(num_groups=G, factored=factored)
    jparams = jag.init_agent(cfg_j, jax.random.PRNGKey(11))
    traj = _trajectory(np.random.RandomState(3 + factored), 10, G, factored)
    jopt, jupdate = jag.make_update_fn(cfg_j)
    topt, tupdate = tag.make_update_fn(cfg_t)
    jp, js = jupdate(jparams, jopt.init(jparams),
                     *map(jax.numpy.asarray, traj), np.float32(0.5))
    tparams = _ported(jparams)
    tp, ts = tupdate(tparams, topt.init(tparams),
                     *map(torch.from_numpy, traj), torch.tensor(0.5))
    assert int(ts["step"]) == int(js["step"]) == 50
    _assert_params_close(tp, jp, UPDATE_ATOL)
    # the update moved the params: the comparison is not of the start
    assert max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(tp), tree_leaves(tparams))) > 1e-3


def test_exploring_act_matches_reference_under_its_draws():
    cfg_j, cfg_t = jag.PPOConfig(num_groups=3), tag.PPOConfig(num_groups=3)
    jagent = jag.PPOAgent(cfg_j, seed=2)
    tagent = tag.PPOAgent(cfg_t, params=_ported(jagent.params),
                          noise=reference_noise(2))
    rng = np.random.RandomState(0)
    for r in range(3):
        obs = rng.rand(6).astype(np.float32)
        ja, ta = jagent.act(obs, explore=True), tagent.act(obs, explore=True)
        np.testing.assert_allclose(ta, ja, rtol=0, atol=FP32_ATOL)
        assert ((ta >= 1e-3) & (ta <= 1.0)).all()
        for x, y in zip(tagent._last[1:3], jagent._last[1:3]):  # raw, logp
            np.testing.assert_allclose(x, y, rtol=0, atol=FP32_ATOL)
        assert tagent._last[3] == jagent._last[3] == 0.5
        jagent.observe(float(r))
        tagent.observe(float(r))
    # sample_action: the same draw through the functional form
    obs = rng.rand(6).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ja, jl = jag.sample_action(cfg_j, jagent.params, obs, key, 0.3)
    noise = np.array(jax.random.normal(key, (3,)))
    ta, tl = tag.sample_action(cfg_t, tagent.params, torch.from_numpy(obs),
                               torch.from_numpy(noise), 0.3)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=FP32_ATOL)
    np.testing.assert_allclose(float(tl), float(jl), atol=FP32_ATOL)


def _train_both(rounds, deploy_rounds=0):
    """train_rl_agent (factored, G=3, the paper testbed) in the reference
    and in the port from the reference's params and noise; then, if asked,
    run_fl_with_controller with the trained agents."""
    out = {}
    for side in ("j", "t"):
        if side == "j":
            w, devices, srv, ovh = j_testbed(J_VGG5)
            Sim, Ctl, ops = JSim, JController, J_VGG5.ops
            agent = jag.PPOAgent(jag.PPOConfig(num_groups=3, factored=True),
                                 seed=0)
            init = agent.params
            train, deploy = j_train, j_deploy
        else:
            w, devices, srv, ovh = paper_testbed(VGG5)
            Sim, Ctl, ops = SimulatedCluster, FedAdaptController, VGG5.ops
            agent = tag.PPOAgent(tag.PPOConfig(num_groups=3, factored=True),
                                 params=_ported(init),
                                 noise=reference_noise(0))
            train, deploy = train_rl_agent, run_fl_with_controller
        sim = Sim(w, devices, srv, ops, iterations=5, jitter=0.03, seed=1,
                  overhead_s=ovh)
        ctl = Ctl(w, ops, num_groups=3, low_bw_threshold=None, agent=agent,
                  seed=0)
        hist = train(sim, ctl, rounds=rounds)
        res = {"hist": hist, "agent": agent}
        if deploy_rounds:
            sim = Sim(w, devices, srv, ops, iterations=100, jitter=0.0,
                      seed=2, overhead_s=ovh)
            ctl = Ctl(w, ops, num_groups=3, low_bw_threshold=None,
                      agent=agent)
            res["deploy"] = deploy(sim, ctl, rounds=deploy_rounds)
            res["fl_round"] = max(sim.round_times(sim.native_ops(), 0))
        out[side] = res
    return out["j"], out["t"]


def test_train_rl_agent_matches_reference():
    """31 rounds, so that the third update (at the 31st act) shapes an
    action: updates after acts 11, 21 and 31."""
    j, t = _train_both(31)
    np.testing.assert_array_equal(t["hist"]["ops"], j["hist"]["ops"])
    np.testing.assert_allclose(t["hist"]["actions"], j["hist"]["actions"],
                               rtol=0, atol=ACTION_ATOL)
    np.testing.assert_array_equal(t["hist"]["reward"], j["hist"]["reward"])
    assert int(t["agent"].opt_state["step"]) == 150
    _assert_params_close(t["agent"].params, j["agent"].params, UPDATE_ATOL)


def test_fedadapt_beats_classic_fl_end_to_end():
    """The torch twin of tests/test_system.py's headline test: 350 training
    rounds from the reference's initial params and noise, then 5 deployed
    rounds; the trained FedAdapt cuts the round time by more than 25%
    against classic FL (paper: 40%)."""
    j, t = _train_both(350, deploy_rounds=5)
    np.testing.assert_array_equal(t["hist"]["ops"], j["hist"]["ops"])
    np.testing.assert_allclose(t["hist"]["actions"], j["hist"]["actions"],
                               rtol=0, atol=ACTION_ATOL)
    np.testing.assert_array_equal(t["deploy"]["ops"], j["deploy"]["ops"])
    reduction = 1 - t["deploy"]["round_time"][-1] / t["fl_round"]
    assert reduction > 0.25, f"only {reduction:.0%} reduction (paper: 40%)"


def test_exploring_planner_learns():
    tw, *_ = paper_testbed(VGG5)
    ctl = FedAdaptController(tw, VGG5.ops, 3, device="cpu")
    assert ctl.agent.params["actor"]["w0"].device.type == "cpu"
    planner = FedAdaptPlanner(ctl, explore=True)
    times = [1.0, 2.0, 3.0, 4.0, 5.0]
    planner.begin(times)
    for r in range(11):                      # one update, at the 11th act
        ops = planner.plan(r, times, [75e6] * 5)
        assert all(op in VGG5.ops for op in ops)
        planner.feedback([t * (0.9 + 0.01 * r) for t in times])
    assert int(ctl.agent.opt_state["step"]) == 50
