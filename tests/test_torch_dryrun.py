"""The port's dry runs (``repro_torch.launch.dryrun``,
``repro_torch.launch.fedavg_dryrun``) and the two example twins
(``launch.fleet_simulation``, ``launch.bandwidth_adaptation``) against
the JAX reference, on the CPU.

The reference's dry runs compile on 512 forced host devices, which these
tests do not start; what they report that the port also reports is
checked from the reference's own formulas and specs (stub meshes: its
rules read only ``mesh.shape``): a cell's ``params``, ``active_params``,
``model_flops`` and skip reason, its per-place argument, output (plus
XLA's 8-byte tuple entry a leaf) and alias bytes, and ``model_bytes``.
Every number of a cell is per place (``launch.hlo_analysis``): the dense
qwen3-0.6b train_4k cell's matmul FLOPs a place are the closed form
derived here over the 256 places, and its FSDP and TP collectives closed
forms too; the sharded MoE's collectives are one place's body's.  The MoE
decode cell is cut to two of mixtral's 56 layers (``opt_flags``); under
the analysis the expert-parallel body runs for one place.

The twins: ``fleet_simulation`` at K = 4 for 1 round, its two engines'
metric within the plain fp32 bound the federated LM tests hold
(``torch_fl_cases.PLAIN_METRIC_REL``); ``bandwidth_adaptation``
shortened, from the reference agent's params and threefry noise, its OPs
every round (training and deployment) exactly those of the same calls on
the reference's modules.
"""
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch_fl_cases import PLAIN_METRIC_REL

from repro.configs import SHAPES as J_SHAPES
from repro.configs import cell_is_runnable as j_runnable
from repro.configs import get_config as j_config
from repro.configs.vgg import VGG5 as J_VGG5
from repro.core import agent as jag
from repro.core import costmodel as jcm
from repro.core.controller import FedAdaptController as JController
from repro.core.controller import run_fl_with_controller as j_deploy
from repro.core.controller import train_rl_agent as j_train
from repro.core.env import SimulatedCluster as JSim
from repro.core.testbed import paper_testbed as j_testbed
from repro.fl.comm import paper_schedule as j_schedule
from repro.launch import inputs as JI
from repro.launch import steps as JS
from repro.parallel import sharding as JSH
from repro_torch.convert import agent_params_from_numpy
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import bandwidth_adaptation, dryrun, fedavg_dryrun
from repro_torch.launch import fleet_simulation


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j_place_bytes(tree, specs, mesh_shape):
    """Per-place bytes of the reference's stand-ins under its specs."""
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    total = 0.0
    for leaf, spec in zip(leaves, spec_leaves):
        shards = 1
        for entry in spec:
            for ax in ((entry,) if isinstance(entry, str) else entry or ()):
                shards *= mesh_shape[ax]
        total += leaf.size * leaf.dtype.itemsize / shards
    return total


def _qwen3_train_flops(cfg, shape):
    """The global matmul FLOPs of one train step at ``shape``: every
    projection and the tied unembedding forward (2 T d d_out) and each
    attention's two products over every head's S (S + 1) / 2 causal pairs
    (the flash kernel's written count: the pairs the mask leaves); then
    the backward, which first runs that forward again (every one of these
    products sits in a rematerialised body: the layers under
    ``cfg.remat``, the CE chunks always, and ``layers.remat`` recomputes
    under ``torch.func`` too) and then takes two products a forward one
    (the gradients of both operands; the flash backward's two kernels two
    each): four forwards in all.  A place does 1/256 of it on the 16 x 16
    mesh: every product is split over data (the batch) and model (heads,
    d_ff, the vocab, the KV heads two places a head)."""
    B, S = shape.global_batch, shape.seq_len
    T, d, L = B * S, cfg.d_model, cfg.num_layers
    per_layer = (d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
                 + 3 * d * cfg.d_ff)
    attention = 2 * 2 * B * cfg.num_heads * (S * (S + 1) // 2) * cfg.head_dim
    forward = 2 * T * (L * per_layer + cfg.vocab_size * d) + L * attention
    return 4 * forward


def test_qwen3_train_cell_on_meta():
    before = dict(LAUNCHES)
    r = dryrun.run_cell("qwen3-0.6b", "train_4k", False)
    assert dict(LAUNCHES) == before
    jcfg, shape = j_config("qwen3-0.6b"), J_SHAPES["train_4k"]
    assert r["status"] == "ok" and r["chips"] == 256
    assert (r["arch"], r["shape"], r["mesh"], r["kind"]) == \
        ("qwen3-0.6b", "train_4k", "16x16", "train")
    assert r["params"] == jcfg.param_count()
    assert r["active_params"] == jcfg.active_param_count()
    assert r["model_flops"] == 6.0 * jcfg.active_param_count() * shape.tokens
    # per place: the matmul FLOPs a 256th of the global form (summed over
    # the places, the global form), the elementwise ones on top
    global_flops = _qwen3_train_flops(jcfg, shape)
    assert r["cost"]["matmul_flops"] == global_flops / 256
    assert r["cost"]["matmul_flops"] * 256 == global_flops
    assert r["cost"]["flops"] > r["cost"]["matmul_flops"]
    assert r["unrolled"]["status"] == "ok"
    assert r["unrolled"]["cost"] == r["cost"]
    assert r["unrolled"]["collectives_total"] == r["collectives"]["total"]
    # the reference's stand-ins and specs on a 16 x 16 stub
    mesh_shape = {"data": 16, "model": 16}
    rules = JSH.make_axis_rules(SimpleNamespace(shape=mesh_shape))
    params = JS.abstract_params(jcfg, jnp.bfloat16)
    opt = JS.make_opt(jcfg)
    opt_state = JS.abstract_opt_state(opt, params)
    p_specs = JS.model_param_pspecs(jcfg, params, rules)
    o_specs = JS.opt_pspecs(opt_state, params, p_specs, rules)
    batch = JI.train_batch_specs(jcfg, shape)
    args = _j_place_bytes((params, opt_state, batch),
                          (p_specs, o_specs,
                           JI.batch_pspecs(jcfg, batch, rules)), mesh_shape)
    alias = _j_place_bytes((params, opt_state), (p_specs, o_specs),
                           mesh_shape)
    leaves = 1 + len(jax.tree_util.tree_leaves((params, opt_state)))
    mem = r["memory"]
    assert (mem["argument_size_in_bytes"], mem["output_size_in_bytes"],
            mem["alias_size_in_bytes"]) == (args, 4 + alias + 8 * leaves,
                                            alias)
    assert mem["peak_memory_in_bytes"] == args + mem["temp_size_in_bytes"]
    # FSDP and TP, per place: each weight matrix gathered over data (its
    # model split kept) in the forward, its recompute and for the input
    # gradient, the tied unembedding likewise in each of the 4 CE chunks;
    # each gradient leaf reduce-scattered to its share; the residual
    # stream (16 rows of 4096 x 1024, bf16) summed over model at the
    # embedding's and each block's two pins (forward and recompute) and at
    # the first layer's and each block's two input gradients
    L, d, V = jcfg.num_layers, jcfg.d_model, jcfg.vocab_size
    per_layer = (d * jcfg.q_dim + 2 * d * jcfg.kv_dim + jcfg.q_dim * d
                 + 3 * d * jcfg.d_ff)
    g = r["collective_groups"]
    fsdp = [v for k, v in g.items()
            if k.startswith("all-gather data ") and k.split()[2] in ("mm",
                                                                     "bmm")]
    assert sum(v["count"] for v in fsdp) == 3 * (7 * L + 4)
    assert sum(v["bytes"] for v in fsdp) == 2 * (
        3 * L * per_layer + 3 * 4 * V * d) / 16
    assert g["reduce-scatter data shard"] == {
        "count": 8, "bytes": 2 * (L * per_layer + V * d) / 256}
    resid = 2 * 16 * 4096 * d
    tp = [g[k] for k in ("all-reduce model shard", "all-reduce model add")]
    assert sum(v["count"] for v in tp) == 6 * L + 2
    assert sum(v["bytes"] for v in tp) == (6 * L + 2) * resid


def test_moe_decode_cell_counts_its_collectives():
    """mixtral-8x22b decode_32k at two of its layers: case B (8 experts
    do not divide by 16: d_ff over model), d over data (FSDP).  A place's
    body gathers its four weights once a layer (the router (d, E) and a
    d_ff / 16 slice of each expert's three) and sums its partial output
    over model once, as one device's program reads them."""
    cfg = j_config("mixtral-8x22b")
    r = dryrun.run_cell("mixtral-8x22b", "decode_32k", False,
                        variant="depth2", opt_flags={"num_layers": 2})
    assert r["status"] == "ok" and r["variant"] == "depth2"
    g = r["collective_groups"]
    B, d, E, f = (J_SHAPES["decode_32k"].global_batch, cfg.d_model,
                  cfg.moe.num_experts, cfg.d_ff)
    assert g["all-reduce model moe"] == {"count": 2,
                                         "bytes": 2.0 * (B // 16) * d * 2}
    assert g["all-gather data moe"] == {
        "count": 2 * 4, "bytes": 2 * 2.0 * (d * E + 3 * E * d * f // 16)}
    assert "reduce-scatter data moe" not in g
    assert r["cost"]["flops"] > 0


def test_long_context_cells_skip_as_the_reference():
    r = dryrun.run_cell("qwen3-0.6b", "long_500k", False)
    ok, why = j_runnable(j_config("qwen3-0.6b"), J_SHAPES["long_500k"])
    assert not ok and r == {
        "arch": "qwen3-0.6b", "shape": "long_500k", "mesh": "16x16",
        "variant": "baseline", "kind": "decode",
        "params": j_config("qwen3-0.6b").param_count(),
        "active_params": j_config("qwen3-0.6b").active_param_count(),
        "status": "skipped", "reason": why}


def test_dryrun_cli_writes_its_json(tmp_path):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "llama3-8b", "--shape", "long_500k",
                     "--out", str(tmp_path)])
    assert e.value.code == 0
    got = json.loads((tmp_path / "llama3-8b__long_500k__single.json")
                     .read_text())
    assert got["status"] == "skipped"
    # an existing cell is not run again without --force
    dryrun.main(["--arch", "llama3-8b", "--shape", "long_500k",
                 "--out", str(tmp_path)])


def test_fedavg_dryrun_on_meta(tmp_path):
    before = dict(LAUNCHES)
    r = fedavg_dryrun.main(["--arch", "qwen3-0.6b", "--out", str(tmp_path)])
    assert dict(LAUNCHES) == before
    assert json.loads((tmp_path / "qwen3-0.6b__train_4k__fedavg_sync.json")
                      .read_text()) == r
    jparams = JS.abstract_params(j_config("qwen3-0.6b"), jnp.bfloat16)
    model_bytes = sum(leaf.size * 2
                      for leaf in jax.tree_util.tree_leaves(jparams))
    assert r["status"] == "ok" and r["pods"] == 2
    assert r["model_bytes"] == model_bytes
    # per place: the local steps' collectives are within-pod (FSDP, TP:
    # nonzero for a dense model), none with a group spanning pod; the
    # sync is one all-reduce over pod of a place's share of the fp32 mean
    local = r["local_step"]["collectives"]
    assert local["all-gather"]["count"] > 0
    assert local["all-reduce"]["count"] > 0
    assert r["local_step"]["pod_spanning"] == 0
    mesh_shape = {"data": 16, "model": 16}
    rules = JSH.make_axis_rules(SimpleNamespace(shape=mesh_shape))
    p_specs = JS.model_param_pspecs(j_config("qwen3-0.6b"), jparams, rules)
    assert r["sync_step"]["collectives"]["all-reduce"] == {
        "count": 1, "bytes": 2.0 * _j_place_bytes(jparams, p_specs,
                                                  mesh_shape)}
    assert r["sync_step"]["collectives"]["total"]["count"] == 1


def test_fleet_simulation_engines_agree():
    out = fleet_simulation.main(["--device", "cpu", "--clients", "4",
                                 "--rounds", "1"])
    seq, bat = (out["hists"][e]["accuracy"] for e in ("sequential",
                                                      "batched"))
    assert len(seq) == 1 and out["rounds_per_s"]["batched"] > 0
    assert out["drift"] == float(np.abs(bat - seq).max())
    assert out["drift"] <= PLAIN_METRIC_REL * float(np.abs(seq).max())


def reference_noise(seed):
    key = [jax.random.split(jax.random.PRNGKey(seed))[0]]

    def draw(shape):
        key[0], sub = jax.random.split(key[0])
        return np.asarray(jax.random.normal(sub, shape))
    return draw


def _reference_bandwidth_adaptation(train_rounds, rounds):
    """The example's calls on the reference's modules, shortened."""
    w, devices, server, overhead = j_testbed(J_VGG5)
    train_devices = [jcm.DeviceProfile(d.name, d.flops_per_s,
                                       10e6 if d.name == "pi3_2" else 75e6)
                     for d in devices]
    sim_train = JSim(w, train_devices, server, J_VGG5.ops, iterations=5,
                     jitter=0.03, seed=1, overhead_s=overhead)
    agent = jag.PPOAgent(jag.PPOConfig(num_groups=3, factored=True), seed=0)
    init = jax.tree_util.tree_map(np.asarray, agent.params)
    ctl = JController(w, J_VGG5.ops, num_groups=3, low_bw_threshold=25e6,
                      agent=agent, seed=0)
    train = j_train(sim_train, ctl, rounds=train_rounds)
    sched = j_schedule(base_bps=75e6, low_bps=10e6, start_round=50,
                       slot_len=10)
    deploy = JSim(w, devices, server, J_VGG5.ops, iterations=100,
                  jitter=0.0, seed=2, overhead_s=overhead,
                  bandwidth_fn=lambda r, d: sched(r, d))
    ctl2 = JController(w, J_VGG5.ops, num_groups=3, low_bw_threshold=25e6,
                       agent=agent)
    return init, train, j_deploy(deploy, ctl2, rounds=rounds)


def test_bandwidth_adaptation_ops_match_reference():
    """31 training rounds (updates after acts 11, 21 and 31) and 60
    deployed rounds: the Jetson's throttled slot (rounds 50-59) and the
    first Pi's first round."""
    init, jtrain, jdeploy = _reference_bandwidth_adaptation(31, 60)
    out = bandwidth_adaptation.main(
        ["--device", "cpu", "--train-rounds", "31", "--rounds", "60"],
        agent_params=agent_params_from_numpy(init, device="cpu"),
        agent_noise=reference_noise(0))
    np.testing.assert_array_equal(out["train"]["ops"], jtrain["ops"])
    np.testing.assert_array_equal(out["deploy"]["ops"], jdeploy["ops"])
    np.testing.assert_allclose(out["deploy"]["round_time"],
                               jdeploy["round_time"], rtol=1e-12)
    # the throttled rounds reach the deployment: not every round alike
    assert len({tuple(o) for o in np.asarray(jdeploy["ops"])}) > 1
