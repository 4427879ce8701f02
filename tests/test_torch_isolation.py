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
    # the step analysis is among the modules imported
    assert "repro_torch.launch.hlo_analysis" in _module_names()


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
    "run_federated(client_widths=..., num_edges=2)": (
        "from repro_torch.configs.vgg import VGG5\n"
        "from repro_torch.data import make_cifar_like, split_clients\n"
        "from repro_torch.fl.comm import Transport, indexed_bandwidths\n"
        "from repro_torch.fl.loop import FLConfig, run_federated\n"
        "c = split_clients(make_cifar_like(30, seed=1), 3)\n"
        "h = run_federated(VGG5, c, c[0], FLConfig(rounds=1, local_iters=1,\n"
        "    batch_size=10, mode='sfl', static_op=2, delta_density=0.1,\n"
        "    quantize_deltas=True, client_widths=(0.25, 1.0, 0.5),\n"
        "    num_edges=2), edge_transport=Transport(indexed_bandwidths(\n"
        "    [1e7, 2e7])), device='cpu')\n"
        "assert h['edge_time'][0] > 0\n"),
    "run_federated(mesh_shape=(2, 4), engine='batched')": (
        "from repro_torch.configs.vgg import VGG5\n"
        "from repro_torch.data import make_cifar_like, split_clients\n"
        "from repro_torch.fl.loop import FLConfig, run_federated\n"
        "c = split_clients(make_cifar_like(30, seed=1), 3)\n"
        "h = run_federated(VGG5, c, c[0], FLConfig(rounds=1, local_iters=1,\n"
        "    batch_size=10, mode='sfl', static_op=2, delta_density=0.1,\n"
        "    quantize_deltas=True, engine='batched', mesh_shape=(2, 4)),\n"
        "    device='cpu', mesh_devices=['cpu'] * 8)\n"
        "assert len(h['accuracy']) == 1\n"),
    "moe_block under use_rules and moe_int8_gather": (
        "import torch\n"
        "from repro_torch.configs.registry import get_smoke_config\n"
        "from repro_torch.models import layers as L\n"
        "from repro_torch.parallel.sharding import (make_axis_rules,\n"
        "    make_flat_mesh, use_rules)\n"
        "cfg = get_smoke_config('arctic-480b')\n"
        "p = L.init_moe(torch.Generator().manual_seed(0), cfg,\n"
        "               torch.float32)\n"
        "x = torch.randn(2, 4, cfg.d_model)\n"
        "mesh = make_flat_mesh((2, 2), devices=['cpu'] * 4)\n"
        "with use_rules(make_axis_rules(mesh)), L.moe_int8_gather():\n"
        "    y = L.moe_block(cfg, p, x)\n"
        "assert y.shape == x.shape and bool(torch.isfinite(y).all())\n"),
    "the dry runs import without side effects and run on meta": (
        "import os, torch\n"
        "env = dict(os.environ)\n"
        "from repro_torch.launch import dryrun, fedavg_dryrun\n"
        "assert dict(os.environ) == env and not torch.cuda.is_initialized()\n"
        "r = dryrun.run_cell('mamba2-780m', 'long_500k', False)\n"
        "assert r['status'] == 'ok' and r['cost']['flops'] > 0\n"
        "assert dryrun.run_cell('qwen3-0.6b', 'long_500k', True)['status'] \\\n"
        "    == 'skipped'\n"
        "assert not torch.cuda.is_initialized()\n"),
    "make_local_sync_steps over two pods": (
        "import torch\n"
        "from repro_torch.configs.lm_small import LM16M\n"
        "from repro_torch.launch import steps as S\n"
        "from repro_torch.models import api\n"
        "from repro_torch.tree import tree_leaves, tree_map\n"
        "p = api.init(LM16M, 0, device='cpu')\n"
        "opt = S.make_opt(LM16M)\n"
        "local, sync = S.make_local_sync_steps(LM16M, opt, 2)\n"
        "pp = tree_map(lambda x: torch.stack([x, x]), p)\n"
        "oo = tree_map(lambda x: torch.stack([x, x]), opt.init(p))\n"
        "toks = torch.randint(0, LM16M.vocab_size, (2, 1, 17))\n"
        "b = {'tokens': toks[..., :-1], 'labels': toks[..., 1:]}\n"
        "loss, pp, oo = local(pp, oo, b)\n"
        "assert loss.shape == (2,) and bool(torch.isfinite(loss).all())\n"
        "for x in tree_leaves(sync(pp)):\n"
        "    assert torch.equal(x[0], x[1])\n"),
}


# the hybrid and encdec families' serving entry points, each run in a fresh
# interpreter in which importing JAX fails
LM_ENTRY_POINTS = {
    "hybrid api.prefill+decode (recurrentgemma-9b smoke)": (
        "import torch\n"
        "from repro_torch.configs import recurrentgemma_9b\n"
        "from repro_torch.models import api\n"
        "cfg = recurrentgemma_9b.smoke_config()\n"
        "p = api.init(cfg, device='cpu')\n"
        "t = torch.zeros((1, 40), dtype=torch.long)\n"
        "logits, c = api.prefill(cfg, p, {'tokens': t}, target_seq=42)\n"
        "logits, c = api.decode(cfg, p, c, t[:, :1], 40)\n"
        "assert logits.shape == (1, 256) and torch.isfinite(logits).all()\n"),
    "encdec api.prefill+decode (whisper-base smoke)": (
        "import torch\n"
        "from repro_torch.configs import whisper_base\n"
        "from repro_torch.models import api\n"
        "cfg = whisper_base.smoke_config()\n"
        "p = api.init(cfg, device='cpu')\n"
        "t = torch.zeros((1, 5), dtype=torch.long)\n"
        "f = torch.zeros((1, cfg.encoder_seq, cfg.d_model))\n"
        "logits, c = api.prefill(cfg, p, {'tokens': t, 'frames': f},\n"
        "                        target_seq=8)\n"
        "logits, c = api.decode(cfg, p, c, t[:, :1], 5)\n"
        "assert logits.shape == (1, 256) and torch.isfinite(logits).all()\n"),
    # LM training: every family's split program through the int8 cut, the
    # flash Function's gradient and adafactor
    "LM split programs: loss_through_cut + grad + adafactor": (
        "import torch\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.models.split_program import get_split_program\n"
        "from repro_torch.optim import adafactor\n"
        "from repro_torch.tree import tree_leaves, tree_map\n"
        "for arch in ('qwen3-0.6b', 'mixtral-8x22b', 'internvl2-2b',\n"
        "             'mamba2-780m', 'recurrentgemma-9b', 'whisper-base'):\n"
        "    cfg = get_smoke_config(arch)\n"
        "    prog = get_split_program(cfg)\n"
        "    p = tree_map(lambda t: t.requires_grad_(), prog.init(0, 'cpu'))\n"
        "    t = torch.zeros((1, 16), dtype=torch.long)\n"
        "    b = {'tokens': t, 'labels': t,\n"
        "         'patches': torch.zeros((1, cfg.num_patches, cfg.d_model)),\n"
        "         'frames': torch.zeros((1, cfg.encoder_seq, cfg.d_model))}\n"
        "    loss = prog.loss_through_cut(p, b, 1, quantize=True)\n"
        "    g = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True)\n"
        "    assert torch.isfinite(loss) and any(x is not None for x in g)\n"
        "opt = adafactor()\n"
        "q = {'w': torch.ones(2, 3, 4)}\n"
        "opt.update(q, q, opt.init(q))\n"),
    "launch.train.main (lm16m, int8 cut)": (
        "from repro_torch.launch.train import main\n"
        "p = main(['--arch', 'lm16m', '--rounds', '2', '--local-steps', '1',\n"
        "          '--batch', '1', '--seq', '16', '--clients', '2',\n"
        "          '--quantize-transfer'], device='cpu')\n"
        "assert p['embed'].shape == (4096, 320)\n"),
    "run_federated(_async) over LM configs (widths, edges, batched)": (
        "import numpy as np\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.data import split_clients, token_dataset\n"
        "from repro_torch.fl.async_loop import run_federated_async\n"
        "from repro_torch.fl.loop import FLConfig, run_federated\n"
        "for arch in ('qwen3-0.6b',):\n"
        "    cfg = get_smoke_config(arch)\n"
        "    data = token_dataset(12, 16, cfg.vocab_size, seed=0)\n"
        "    clients = split_clients(data, 3)\n"
        "    kw = dict(rounds=1, local_iters=1, batch_size=2, augment=False,\n"
        "              mode='sfl', static_op=1, quantize_transfer=True,\n"
        "              delta_density=0.5, quantize_deltas=True)\n"
        "    h = run_federated(cfg, clients, clients[0], FLConfig(\n"
        "        engine='batched', client_widths=(1.0, 0.5, 0.25),\n"
        "        num_edges=2, **kw), device='cpu')\n"
        "    a = run_federated_async(cfg, clients, clients[0],\n"
        "                            FLConfig(**kw), device='cpu')\n"
        "    assert np.isfinite(h['accuracy']).all()\n"
        "    assert np.isfinite(a['accuracy']).all()\n"),
}


@pytest.mark.parametrize("name", list(LM_ENTRY_POINTS))
def test_lm_entry_points_run_without_jax(name):
    out = subprocess.run([sys.executable, "-c",
                          NO_JAX + LM_ENTRY_POINTS[name]],
                         capture_output=True, text=True, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr[-2000:]


# the fault-tolerance and async drivers, run as a user runs them
DRIVERS = ["repro_torch.launch.async_federated",
           "repro_torch.launch.fault_tolerance_drill"]


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_training_entry_points_run_without_jax(name):
    out = subprocess.run([sys.executable, "-c", NO_JAX + ENTRY_POINTS[name]],
                         capture_output=True, text=True, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.mark.parametrize("module", DRIVERS)
def test_launch_drivers_run_without_jax(module):
    code = (NO_JAX + "import runpy, sys\n"
            f"sys.argv = [{module!r}, '--device', 'cpu']\n"
            f"runpy.run_module({module!r}, run_name='__main__')\n")
    # one intra-op thread: test workers run side by side
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src"),
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "virtual time" in out.stdout or "bitwise resume: OK" in out.stdout


def test_the_new_training_modules_are_in_the_import_check():
    for name in ("repro_torch.optim.optimizers", "repro_torch.optim.schedule",
                 "repro_torch.tree", "repro_torch.fl.fedavg",
                 "repro_torch.launch.quickstart",
                 "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
                 "repro_torch.fl.state", "repro_torch.fl.cohort",
                 "repro_torch.fl.async_loop", "repro_torch.runtime.chaos",
                 "repro_torch.runtime.elastic", "repro_torch.fl.hetero",
                 "repro_torch.fl.hierarchy", "repro_torch.models.hybrid",
                 "repro_torch.models.encdec", "repro_torch.models.split",
                 "repro_torch.models.split_program",
                 "repro_torch.launch.train",
                 "repro_torch.launch.generic_split_fl",
                 "repro_torch.launch.train_lm_fedadapt",
                 "repro_torch.parallel", "repro_torch.parallel.sharding",
                 *DRIVERS):
        assert name in _module_names()
