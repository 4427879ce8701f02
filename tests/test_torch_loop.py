"""The slice end to end: the port's ``run_federated`` against the JAX
reference's on VGG-5 at a small size (K=3 clients of 20 samples, batch 10,
2 local iterations, 2 rounds, flip augmentation), from the same initial
weights, data, testbed and agent.

``ops``, ``round_time``, ``comm_time`` and ``dropped`` are exact: they come
from numpy arithmetic on identical inputs.  ``accuracy`` is within one test
sample.  Final params agree within a per-mode atol:

* ``fl``: 1e-5.  The two frameworks' convs and matmuls round differently
  at the fp32 ulp level, and local SGD carries that through 4 steps per
  client (observed 2.4e-7).
* the int8 and top-k modes: 1e-3.  There a discrete step can turn such a
  difference into a jump: an int8 code at the cut or on the delta wire can
  round the other way (one quantization step, about 1% of the row's
  absmax), and a near-tie at a top-k threshold can send a different entry,
  the error feedback keeping the unsent one.  Either moves a few params by
  up to an lr-scaled step or one delta entry times its client weight
  (observed 1.9e-4 with the int8 cut, 6.1e-5 with top-k and int8 deltas).

The ``fail_prob`` / ``deadline_factor`` cases choose the kept clients
(FailureInjector's numpy draws, the deadline over Eq. 1 times) and the
round time of the slowest kept one, so ``dropped`` is exact.  ``fl`` drops
1 and 2 of 3 clients, ``fedadapt`` 1 and 1, ``sfl`` at deadline 1.05 none;
params agree within 2.4e-7 (``fedadapt`` takes the top-k atol).  A tighter
deadline can keep a client whose training crosses a ReLU / max-pool flip
(at 0.9, ``fl``: a pre-ReLU value of +1.85e-6 in the reference is <= 0 in
the port, and the max pool routes the gradient elsewhere: 5.06e-5 apart);
such a case would take the discrete-step atol 1e-3, as int8 and top-k do.

The ``*-batched-*`` and ``*-reference`` cases run the batched engine
(clients vmapped per OP group; ``fedadapt`` plans two OP groups in its
second round) and the per-leaf reference server step on both sides: the
stacked ``tensordot`` for plain averaging, else per-client top-k with error
feedback and the int8 wire.  They hold the same contract and atols
(observed: ``fl`` 6.0e-8, ``sfl`` at OP1 with the int8 cut, top-k 0.1 and
int8 deltas 6.2e-4, ``fedadapt`` with top-k and int8 deltas 3.2e-5).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.vgg import VGG5 as J_VGG5
from repro.core.agent import PPOAgent as JAgent, PPOConfig as JPPOConfig
from repro.core.controller import FedAdaptController as JController
from repro.core.env import SimulatedCluster as JSim
from repro.core.testbed import paper_testbed as j_testbed
from repro.fl.comm import Transport as JTransport
from repro.fl.comm import device_bandwidths as j_bw
from repro.fl.loop import FLConfig as JFLConfig
from repro.fl.loop import run_federated as j_run
from repro.models.split_program import get_split_program as j_program
from repro_torch.configs.vgg import VGG5
from repro_torch.convert import (agent_params_from_numpy,
                                 vgg_params_from_numpy, vgg_params_to_numpy)
from repro_torch.core.agent import PPOAgent, PPOConfig
from repro_torch.core.controller import FedAdaptController
from repro_torch.core.env import SimulatedCluster
from repro_torch.core.testbed import paper_testbed
from repro_torch.data import make_cifar_like, split_clients
from repro_torch.fl.comm import Transport, device_bandwidths
from repro_torch.fl.loop import FLConfig, run_federated
from repro_torch.models import vgg as tvgg
from repro_torch.models.split_program import get_split_program

MODES = {
    "fl": dict(mode="fl"),
    "sfl-op2-int8": dict(mode="sfl", static_op=2, quantize_transfer=True),
    "fedadapt-topk-int8": dict(mode="fedadapt", delta_density=0.5,
                               quantize_deltas=True),
    # failures and the straggler deadline: which clients are kept, and the
    # round time of the slowest kept one
    "fl-fail-deadline": dict(mode="fl", fail_prob=0.3, deadline_factor=1.0),
    "sfl-op2-deadline": dict(mode="sfl", static_op=2, deadline_factor=1.05),
    "fedadapt-fail-deadline-topk": dict(mode="fedadapt", fail_prob=0.3,
                                        deadline_factor=1.05,
                                        delta_density=0.5),
    # the batched engine and the per-leaf reference server step
    "fl-batched-reference": dict(mode="fl", engine="batched",
                                 server_step="reference"),
    "sfl-op1-batched-reference-int8-topk": dict(
        mode="sfl", static_op=2, quantize_transfer=True, delta_density=0.1,
        quantize_deltas=True, engine="batched", server_step="reference"),
    "fedadapt-batched-reference-topk-int8": dict(
        mode="fedadapt", delta_density=0.5, quantize_deltas=True,
        engine="batched", server_step="reference"),
    "sfl-op1-batched-fused-int8-topk": dict(
        mode="sfl", static_op=2, quantize_transfer=True, delta_density=0.1,
        quantize_deltas=True, engine="batched"),
    "fl-sequential-reference": dict(mode="fl", server_step="reference"),
}
PARAMS_ATOL = {"fl": 1e-5, "sfl-op2-int8": 1e-3, "fedadapt-topk-int8": 1e-3,
               "fl-fail-deadline": 1e-5, "sfl-op2-deadline": 1e-5,
               "fedadapt-fail-deadline-topk": 1e-3,
               "fl-batched-reference": 1e-5,
               "sfl-op1-batched-reference-int8-topk": 1e-3,
               "fedadapt-batched-reference-topk-int8": 1e-3,
               "sfl-op1-batched-fused-int8-topk": 1e-3,
               "fl-sequential-reference": 1e-5}
SMALL = dict(rounds=2, local_iters=2, batch_size=10, augment=True, seed=0)


def _run_both(kw):
    clients = split_clients(make_cifar_like(60, seed=1), 3)
    test = make_cifar_like(20, seed=2)
    jw, jdev, jsrv, jovh = j_testbed(J_VGG5)
    tw, tdev, tsrv, tovh = paper_testbed(VGG5)
    jsim = JSim(jw, jdev[:3], jsrv, J_VGG5.ops, iterations=2, jitter=0.05,
                seed=3, overhead_s=jovh)
    tsim = SimulatedCluster(tw, tdev[:3], tsrv, VGG5.ops, iterations=2,
                            jitter=0.05, seed=3, overhead_s=tovh)
    jctl = tctl = None
    if kw["mode"] == "fedadapt":
        jagent = JAgent(JPPOConfig(num_groups=3), seed=4)
        tagent = PPOAgent(PPOConfig(num_groups=3),
                         params=agent_params_from_numpy(jax.tree_util.tree_map(
                             np.asarray, jagent.params), device="cpu"))
        jctl = JController(jw, J_VGG5.ops, 3, agent=jagent)
        tctl = FedAdaptController(tw, VGG5.ops, 3, agent=tagent)
    # the reference draws its initial weights from PRNGKey(seed); the port
    # starts from the same weights
    init = j_program(J_VGG5).init(jax.random.PRNGKey(SMALL["seed"]))
    jh = j_run(J_VGG5, clients, test, JFLConfig(**SMALL, **kw), sim=jsim,
               controller=jctl, transport=JTransport(j_bw(jdev[:3])))
    th = run_federated(VGG5, clients, test, FLConfig(**SMALL, **kw),
                       sim=tsim, controller=tctl,
                       transport=Transport(device_bandwidths(tdev[:3])),
                       init_params=jax.tree_util.tree_map(np.asarray, init),
                       device="cpu")
    return jh, th


@pytest.mark.parametrize("mode", list(MODES))
def test_run_federated_matches_reference(mode):
    jh, th = _run_both(MODES[mode])
    for key in ("ops", "round_time", "comm_time", "dropped", "times"):
        np.testing.assert_array_equal(th[key], jh[key], err_msg=key)
    assert np.all(np.abs(th["accuracy"] - jh["accuracy"]) <= 1 / 20 + 1e-9)
    for tl, jl in zip(vgg_params_to_numpy(th["params"]), jh["params"]):
        for k in tl:
            np.testing.assert_allclose(tl[k], np.asarray(jl[k]), rtol=0,
                                       atol=PARAMS_ATOL[mode], err_msg=k)


def test_entry_point_runs_on_the_card_by_default():
    clients = split_clients(make_cifar_like(20, seed=1), 2)
    fl = FLConfig(rounds=1, local_iters=1, batch_size=10)
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_federated(VGG5, clients, clients[0], fl)


@pytest.mark.parametrize("make", [
    lambda: tvgg.init(VGG5, torch.Generator().manual_seed(0)),
    lambda: get_split_program(VGG5).init(torch.Generator().manual_seed(0)),
    lambda: vgg_params_from_numpy(vgg_params_to_numpy(
        tvgg.init(VGG5, torch.Generator().manual_seed(0), device="cpu"))),
    lambda: agent_params_from_numpy({"actor": {"w0": np.ones((6, 64))}}),
    lambda: PPOAgent(PPOConfig(num_groups=3)),
    lambda: FedAdaptController(paper_testbed(VGG5)[0], VGG5.ops, 3),
], ids=["vgg.init", "SplitProgram.init", "vgg_params_from_numpy",
        "agent_params_from_numpy", "PPOAgent", "FedAdaptController"])
def test_param_constructors_default_to_the_card(make):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        make()


@pytest.mark.parametrize("knob,value", [
    ("client_widths", (1.0, 0.5)), ("cohort_size", 1), ("num_edges", 1),
    ("mesh_shape", (1, 1)), ("checkpoint_dir", "ckpt")])
def test_unported_knobs_raise_naming_their_roadmap_item(knob, value):
    clients = split_clients(make_cifar_like(20, seed=1), 2)
    fl = FLConfig(rounds=1, local_iters=1, batch_size=10, **{knob: value})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        run_federated(VGG5, clients, clients[0], fl, device="cpu")


@pytest.mark.parametrize("knob,value", [("engine", "warp"),
                                        ("server_step", "fast")])
def test_unknown_engine_or_server_step_raises(knob, value):
    clients = split_clients(make_cifar_like(20, seed=1), 2)
    fl = FLConfig(rounds=1, local_iters=1, batch_size=10, **{knob: value})
    with pytest.raises(ValueError, match="unknown"):
        run_federated(VGG5, clients, clients[0], fl, device="cpu")


def test_non_vgg_configs_raise():
    from repro_torch.models.split_program import get_split_program
    with pytest.raises(NotImplementedError, match="LM families"):
        get_split_program(object())
