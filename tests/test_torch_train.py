"""The port's LM training driver (``repro_torch.launch.train``) against the
reference's (``repro.launch.train.main``).

Both run the same command line on the CPU.  The port gets the reference's
initial draws injected: the split program's params
(``program.init(PRNGKey(seed))``, through ``convert``), the PPO agent's
params and its threefry exploration noise (one split for the init, then
one per exploring act, as ``tests/test_torch_agent.py`` replays them).
Everything else (token streams, the cluster's jitter, failures) is numpy
and identical.  The reference prints its CSV; the test reads its OPs and
drops from it, its unrounded round times from its ``SimulatedCluster``
and each round's client losses from the ``np.mean`` it prints, and gets
its final params as ``main``'s return value.

Bounds: OPs, modelled round times (every client's) and drops exactly; the
round's mean loss within 1e-5 relative (observed <= 4.2e-7); every final
param within 1e-5 (observed <= 2.3e-6): fp32 sums in other orders over a
few AdamW steps.  The checkpoint-resume twin resumes bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

import repro.launch.train as jtrain
from repro.core import agent as jag
from repro.models.split_program import get_split_program as jget
from repro_torch import convert
from repro_torch.launch import train as ttrain
from repro_torch.tree import tree_leaves

LOSS_REL, PARAM_ATOL = 1e-5, 1e-5

RUNS = {
    "lm16m-int8": ["--arch", "lm16m", "--rounds", "3", "--local-steps", "2",
                   "--batch", "2", "--seq", "32", "--clients", "3",
                   "--quantize-transfer"],
    # failures and a deadline: drops, reweighted FedAvg
    "mamba2-smoke-drops": ["--arch", "mamba2-780m-smoke", "--rounds", "3",
                           "--local-steps", "2", "--batch", "2", "--seq",
                           "32", "--clients", "4", "--fail-prob", "0.3",
                           "--deadline", "1.2", "--seed", "1"],
}


def reference_noise(seed: int):
    key = [jax.random.split(jax.random.PRNGKey(seed))[0]]

    def draw(shape):
        key[0], sub = jax.random.split(key[0])
        return np.asarray(jax.random.normal(sub, shape))
    return draw


def _injected(argv):
    """The reference's initial params and agent params (numpy -> port)
    and its noise, for ``argv``'s arch and seed."""
    args = ttrain.parser().parse_args(argv)
    jcfg = jtrain.resolve_arch(args.arch)
    jp = jget(jcfg).init(jax.random.PRNGKey(args.seed))
    agent = jag.PPOAgent(jag.PPOConfig(num_groups=3, factored=True),
                         seed=args.seed)
    to_np = jax.tree_util.tree_map
    return {"init_params": convert.lm_params_from_numpy(
                to_np(np.asarray, jp), device="cpu"),
            "agent_params": convert.agent_params_from_numpy(
                to_np(np.asarray, agent.params), device="cpu"),
            "agent_noise": reference_noise(args.seed)}


def _reference_run(argv, monkeypatch, capsys):
    times, losses = [], []

    class Sim(jtrain.SimulatedCluster):
        def round_times(self, ops, round_idx):
            out = super().round_times(ops, round_idx)
            times.append(np.array(out))
            return out

    class NP:                      # numpy, with the printed mean recorded
        def __getattr__(self, name):
            return getattr(np, name)

        def mean(self, x, *a, **k):
            losses.append([float(v) for v in x])
            return np.mean(x, *a, **k)

    monkeypatch.setattr(jtrain, "SimulatedCluster", Sim)
    monkeypatch.setattr(jtrain, "np", NP())
    capsys.readouterr()
    params = jtrain.main(argv)
    rows = [line for line in capsys.readouterr().out.splitlines()
            if line[:1].isdigit()]
    monkeypatch.undo()
    ops = [eval(r.split('"')[1]) for r in rows]
    dropped = [int(r.split('"')[2].split(",")[1]) for r in rows]
    # times[0] is the round-0 baseline; then one per round
    return {"params": params, "ops": ops, "dropped": dropped,
            "times": times[1:], "losses": losses, "rows": rows}


@pytest.mark.parametrize("name", list(RUNS))
def test_driver_matches_reference(name, monkeypatch, capsys):
    argv = RUNS[name]
    ref = _reference_run(argv, monkeypatch, capsys)
    args = ttrain.parser().parse_args(argv)
    cfg, inject = ttrain.resolve_arch(args.arch), _injected(argv)
    out = ttrain.train(cfg, args, device="cpu", log=lambda line: None,
                       **inject)
    h = out["history"]
    assert h["ops"] == ref["ops"] and h["dropped"] == ref["dropped"]
    assert len(h["times"]) == len(ref["times"]) == 3
    for got, want in zip(h["times"], ref["times"]):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(h["client_losses"], ref["losses"]):
        assert len(got) == len(want)
        np.testing.assert_allclose(np.mean(got), np.mean(want),
                                   rtol=LOSS_REL)
    jl, tl = jax.tree_util.tree_leaves(ref["params"]), \
        tree_leaves(out["params"])
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=PARAM_ATOL)
    # the control plane alone replays the same OPs, times and drops
    rep = ttrain.replay_control(cfg, args, inject["agent_params"],
                                reference_noise(args.seed))
    assert rep["ops"] == h["ops"] and rep["dropped"] == h["dropped"]
    for got, want in zip(rep["times"], h["times"]):
        np.testing.assert_array_equal(got, want)
    if name == "mamba2-smoke-drops":
        assert sum(h["dropped"]) > 0


def test_train_driver_checkpoint_resume(tmp_path, capsys):
    """The twin of tests/test_runtime.py's: the driver resumes from its
    checkpoint; in ``fl`` mode (no agent, whose actions replay from the
    seed after a resume) the resumed run's params are bit for bit an
    uninterrupted run's."""
    ck = str(tmp_path / "lm")
    base = ["--arch", "lm16m", "--local-steps", "1", "--batch", "1",
            "--seq", "32", "--clients", "2"]
    ttrain.main(base + ["--rounds", "4", "--ckpt-dir", ck, "--ckpt-every",
                        "2"], device="cpu")
    params = ttrain.main(base + ["--rounds", "6", "--ckpt-dir", ck,
                                 "--ckpt-every", "2", "--resume"],
                         device="cpu")
    assert params is not None
    assert "# resumed from round 4" in capsys.readouterr().out
    fl = base + ["--mode", "fl", "--rounds", "3"]
    ck2 = str(tmp_path / "fl")
    ttrain.main(fl[:-1] + ["2", "--ckpt-dir", ck2, "--ckpt-every", "2"],
                device="cpu")
    resumed = ttrain.main(fl + ["--ckpt-dir", ck2, "--ckpt-every", "2",
                                "--resume"], device="cpu")
    whole = ttrain.main(fl, device="cpu")
    for a, b in zip(tree_leaves(resumed), tree_leaves(whole)):
        assert torch.equal(a, b)
