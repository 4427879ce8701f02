"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX nor anything of the JAX package, and no source of the port (nor
``chip_smoke.py`` and the development scripts in ``scripts/``) imports
them."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
SOURCES = (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
           + sorted((REPO / "scripts").glob("*.py")))


def _module_names():
    return sorted(".".join(("repro_torch",) + p.relative_to(PORT)
                           .with_suffix("").parts).removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


def test_importing_every_port_module_loads_no_jax_or_reference():
    code = (
        "import importlib, json, sys\n"
        f"names = {_module_names()!r}\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(json.dumps({'n': len(names), 'bad': bad}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["n"] >= 20 and res["bad"] == []


def test_no_port_source_imports_jax_or_the_reference():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+repro\b(?!_)"
                         r"|from\s+repro[.\s]|import\s+repro\.)", re.M)
    assert (REPO / "chip_smoke.py").exists()
    offenders = [str(p.relative_to(REPO)) for p in SOURCES
                 if pattern.search(p.read_text())]
    assert offenders == []


# the training side of the port, each run in a fresh interpreter in which
# importing JAX fails
NO_JAX = "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
ENTRY_POINTS = {
    "PPOAgent.act(explore=True)": (
        "import numpy as np\n"
        "from repro_torch.core.agent import PPOAgent, PPOConfig\n"
        "a = PPOAgent(PPOConfig(num_groups=2), device='cpu')\n"
        "for r in range(11):\n"
        "    a.act(np.full(4, 0.5, np.float32), explore=True)\n"
        "    a.observe(1.0)\n"
        "assert int(a.opt_state['step']) == 50\n"),
    "train_rl_agent+run_fl_with_controller": (
        "from repro_torch.configs.vgg import VGG5\n"
        "from repro_torch.core.controller import (FedAdaptController,\n"
        "    run_fl_with_controller, train_rl_agent)\n"
        "from repro_torch.core.env import SimulatedCluster\n"
        "from repro_torch.core.testbed import paper_testbed\n"
        "w, d, s, o = paper_testbed(VGG5)\n"
        "sim = SimulatedCluster(w, d, s, VGG5.ops, iterations=5, seed=1,\n"
        "                       overhead_s=o)\n"
        "ctl = FedAdaptController(w, VGG5.ops, 3, device='cpu')\n"
        "assert len(train_rl_agent(sim, ctl, rounds=12)['ops']) == 12\n"
        "assert len(run_fl_with_controller(sim, ctl, 2)['ops']) == 2\n"),
    "FedAdaptPlanner(explore=True)": (
        "from repro_torch.configs.vgg import VGG5\n"
        "from repro_torch.core.controller import FedAdaptController\n"
        "from repro_torch.core.testbed import paper_testbed\n"
        "from repro_torch.fl.planner import FedAdaptPlanner\n"
        "p = FedAdaptPlanner(FedAdaptController(paper_testbed(VGG5)[0],\n"
        "    VGG5.ops, 3, device='cpu'), explore=True)\n"
        "p.begin([1.0, 2.0, 3.0, 4.0, 5.0])\n"
        "assert len(p.plan(0, [1.0, 2.0, 3.0, 4.0, 5.0], [75e6] * 5)) == 5\n"),
    "run_federated(engine='batched', server_step='reference')": (
        "from repro_torch.configs.vgg import VGG5\n"
        "from repro_torch.data import make_cifar_like, split_clients\n"
        "from repro_torch.fl.loop import FLConfig, run_federated\n"
        "c = split_clients(make_cifar_like(20, seed=1), 2)\n"
        "h = run_federated(VGG5, c, c[0], FLConfig(rounds=1, local_iters=1,\n"
        "    batch_size=10, mode='sfl', static_op=2, quantize_transfer=True,\n"
        "    delta_density=0.1, quantize_deltas=True, engine='batched',\n"
        "    server_step='reference'), device='cpu')\n"
        "assert len(h['accuracy']) == 1\n"),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_training_entry_points_run_without_jax(name):
    out = subprocess.run([sys.executable, "-c", NO_JAX + ENTRY_POINTS[name]],
                         capture_output=True, text=True, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr[-2000:]


def test_the_new_training_modules_are_in_the_import_check():
    for name in ("repro_torch.optim.optimizers", "repro_torch.optim.schedule",
                 "repro_torch.tree", "repro_torch.fl.fedavg",
                 "repro_torch.launch.quickstart"):
        assert name in _module_names()
