"""The port's LM launch twins against the JAX package's examples.

* ``repro_torch.launch.generic_split_fl.FAMILIES``: each family's
  config, client and test data (bitwise), sequence length, batch,
  learning rate and int8 cut equal the arguments that the example's
  ``__main__`` block passes to its ``one_family`` (the block run with a
  recorder in place of ``one_family``: no training), in its order.
* ``generic_split_fl.run_family`` against ``examples/generic_split_fl.py``
  for its mamba2-ssm family (mamba2's smoke config; the dense-lm family,
  lm16m over 4 rounds of 3 local iterations, takes ~30 s a package on one
  thread and is run only through its arguments above: lm16m's federated
  runs are in ``tests/test_torch_lm_federated_dense.py``, VGG-5's in
  ``tests/test_torch_loop.py``), from the reference's initial params: the
  greedy planner's OPs, the modelled round and comm times and drops
  exact; the -CE metric within the discrete-step bound of
  ``tests/torch_fl_cases.py`` (the example's int8 cut over 4 rounds at lr
  0.5); the printed line in the example's format.
* ``repro_torch.launch.train_lm_fedadapt``: the example's default flags
  (``--arch`` replaced when given), a temporary checkpoint directory
  unless one is given, and a run equal to ``launch.train.main`` of the
  same arguments.
"""
import ast
import dataclasses
import importlib.util
import os
import tempfile
from pathlib import Path

import jax
import numpy as np
import torch

from repro.models.split_program import get_split_program as j_program
from repro_torch.launch import generic_split_fl, train_lm_fedadapt
from repro_torch.launch import train as driver
from repro_torch.tree import tree_leaves
from torch_fl_cases import DISCRETE_METRIC_REL, one_intra_op_thread

_ = one_intra_op_thread
EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "generic_split_fl.py"


def _reference_example():
    spec = importlib.util.spec_from_file_location("j_generic_split_fl",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_generic_split_fl_families_are_the_examples():
    jex = _reference_example()
    block = next(node for node in ast.parse(EXAMPLE.read_text()).body
                 if isinstance(node, ast.If)
                 and "__main__" in ast.unparse(node.test))
    calls = []
    scope = dict(vars(jex), print=lambda *a, **k: None,
                 one_family=lambda *args: calls.append(args))
    exec(compile(ast.Module(body=block.body, type_ignores=[]),
                 str(EXAMPLE), "exec"), scope)
    assert [c[0] for c in calls] == list(generic_split_fl.FAMILIES)
    for name, jcfg, jclients, jtest, *rest in calls:
        cfg, clients, test, *mine = generic_split_fl.FAMILIES[name]()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), name
        # the tour runs every family with the int8 cut on
        assert mine + [True] == rest, name
        assert len(clients) == len(jclients) == jex.K, name
        for a, b in zip(clients + [test], jclients + [jtest]):
            assert a.keys() == b.keys(), name
            for key in a:
                assert a[key].dtype == b[key].dtype, (name, key)
                np.testing.assert_array_equal(a[key], b[key],
                                              err_msg=f"{name}: {key}")


def test_generic_split_fl_matches_the_reference_example(capsys):
    family = "mamba2-ssm"
    jex = _reference_example()
    runs = []
    run = jex.run_federated
    jex.run_federated = lambda *a, **k: runs.append(run(*a, **k)) or runs[-1]
    # the example's own arguments for the family (its __main__ block;
    # the port's are generic_split_fl.FAMILIES)
    cfg = jex.get_smoke_config("mamba2-780m")
    toks = jex.token_dataset(240, 32, cfg.vocab_size, seed=0)
    jex.one_family(family, cfg, jex.split_clients(toks, jex.K),
                   jex.token_dataset(24, 32, cfg.vocab_size, seed=9), 32, 8,
                   0.5, True)
    jline = capsys.readouterr().out.rstrip("\n").splitlines()[-1]
    init = jax.tree_util.tree_map(
        np.asarray, j_program(cfg).init(jax.random.PRNGKey(0)))
    lines = []
    th = generic_split_fl.run_family(family, "cpu", init, lines.append)
    jh = runs[0]
    for key in ("ops", "round_time", "comm_time", "dropped"):
        np.testing.assert_array_equal(th[key], jh[key], err_msg=key)
    rel = np.abs(th["accuracy"] - jh["accuracy"]) / np.abs(jh["accuracy"])
    assert rel.max() <= DISCRETE_METRIC_REL, rel
    # the same line but for the metric's last digits
    assert lines[-1].split("ops=")[1] == jline.split("ops=")[1]
    assert lines[-1].split("metric")[0] == jline.split("metric")[0]
    print(f"{family}: metric {rel.max():.3g} relative")


def test_train_lm_fedadapt_arguments():
    args = train_lm_fedadapt.arguments([])
    assert args[:2] == ["--arch", "lm100m"]
    ckpt = args[args.index("--ckpt-dir") + 1]
    assert os.path.isdir(ckpt)
    assert Path(ckpt).resolve().parent == \
        Path(tempfile.gettempdir()).resolve()
    os.rmdir(ckpt)
    args = train_lm_fedadapt.arguments(["--arch", "lm16m", "--ckpt-dir",
                                        "/x"])
    assert "lm100m" not in args and args[-4:] == ["--arch", "lm16m",
                                                 "--ckpt-dir", "/x"]


def test_train_lm_fedadapt_runs_the_driver(tmp_path):
    argv = ["--arch", "lm16m", "--rounds", "1", "--local-steps", "1",
            "--clients", "2", "--batch", "1", "--seq", "8", "--ckpt-every",
            "1", "--ckpt-dir", str(tmp_path / "a")]
    got = train_lm_fedadapt.main(argv, device="cpu")
    want = driver.main(train_lm_fedadapt.arguments(
        argv[:-1] + [str(tmp_path / "b")]), device="cpu")
    assert (tmp_path / "a" / "ckpt_00000001.npz").exists()
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
