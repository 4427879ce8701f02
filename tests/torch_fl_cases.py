"""Shared set-up of the LM federated-loop tests
(``test_torch_lm_federated*.py``): each family's smoke config in both
packages, seeded numpy client data (``torch_lm_cases.batch``: tokens,
labels with -1 entries, the VLM's patches, whisper's frames), the
generic example's three devices behind an Eq. 1 cluster and a
``Transport``, and one run of each package from the reference's initial
params (``PRNGKey(seed)``, carried across as numpy).

Tolerances, against the reference's run:

* OPs, modelled round and comm times, drops and ``edge_time``: exact
  (numpy arithmetic on the same inputs).
* Plain runs (fp32 throughout): the -CE eval metric within 1e-5 relative
  and every param leaf within 1e-5 of its largest entry, the split tests'
  bounds (``torch_lm_cases.check_split_program``).
* Runs with the int8 cut, top-k or int8 deltas: a value that the two
  packages' fp32 sums place within an ulp of an int8 code boundary, or a
  top-k near-tie, goes the other way in one of them, a discrete step
  (an int8 step is 1/127 of its row's absmax; a top-k flip moves one
  coordinate by its whole delta), and later steps carry it on.  Such runs
  take the metric within ``DISCRETE_METRIC_REL`` and are held lane by
  lane (``discrete_lanes``): at most ``DISCRETE_TREE_SHARE`` of the lanes
  may lie beyond the split tests' 1e-4 of their leaf's max, and none
  beyond ``DISCRETE_PARAMS_REL``.  Each family's plain run
  (``check_sync_plain``) holds every lane to the plain bounds.
"""
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import costmodel as jcm
from repro.core.env import SimulatedCluster as JSim
from repro.fl.async_loop import run_federated_async as j_run_async
from repro.fl.comm import Transport as JTransport
from repro.fl.comm import device_bandwidths as j_bw
from repro.fl.loop import FLConfig as JFLConfig
from repro.fl.loop import run_federated as j_run
from repro.models.split_program import get_split_program as j_program
from repro_torch.core import costmodel as cm
from repro_torch.core.env import SimulatedCluster
from repro_torch.fl.async_loop import run_federated_async
from repro_torch.fl.comm import Transport, device_bandwidths
from repro_torch.fl.flatbuf import FlatLayout
from repro_torch.fl.loop import FLConfig, run_federated
from repro_torch.models.split_program import get_split_program
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
from torch_lm_cases import batch

PLAIN_METRIC_REL = 1e-5
PLAIN_PARAMS_REL = 1e-5
DISCRETE_METRIC_REL = 5e-4
# the discrete-step runs' params, each lane's error over its leaf's largest
# reference entry (as params_gap): at most DISCRETE_TREE_SHARE of the
# tree's lanes beyond LANE_REL (the split tests' bound), none beyond
# DISCRETE_PARAMS_REL.  Read on the CPU against the reference by this
# file's __main__ (see PERF.md): sound runs, check_sync_discrete's
# seven families and phase 6's lm16m set-up on each engine, at most 2.68%
# of the tree and 0.130 (qwen3); the port's FAULTS, at least 49.2% of the
# tree and 0.770.  No share is set per leaf: a flip is carried by most
# lanes of a norm leaf (75% of a 64-lane one in qwen3, 66% of lm16m's
# stacked ln2), so leaf by leaf the plain runs (check_sync_plain) hold
# each family within 1e-5.
LANE_REL = 1e-4
DISCRETE_TREE_SHARE = 0.05
DISCRETE_PARAMS_REL = 0.25
# port runs that train wrongly, which the discrete-step bounds must refuse
FAULTS = {"training off": dict(lr=0.0),
          "1 local iteration of 2": dict(local_iters=1)}
# the generic example's devices (examples/generic_split_fl.py)
J_DEVICES = [jcm.DeviceProfile("jetson", 8e9, 75e6),
             jcm.DeviceProfile("pi4", 2e9, 75e6),
             jcm.DeviceProfile("pi3", 8e8, 10e6)]
T_DEVICES = [cm.DeviceProfile(d.name, d.flops_per_s, d.bandwidth_bps)
             for d in J_DEVICES]
SERVER = 1e11
SMALL = dict(rounds=2, local_iters=2, batch_size=2, lr=0.1, augment=False,
             seed=0)


def fleet(cfg, K, rows=4, seq=None):
    """K clients of ``rows`` seeded rows each, and a test set of 2: the
    family's batches of ``torch_lm_cases.batch`` (SEQ positions), or with
    ``seq`` plain token rows of that length (tokens and next-token
    labels)."""
    if seq is None:
        clients = [batch(cfg, seed=10 + k, B=rows) for k in range(K)]
        return clients, batch(cfg, seed=99, B=2)

    def rows_of(seed, n):
        rng = np.random.RandomState(seed)
        toks = rng.randint(0, cfg.vocab_size, (n, seq + 1)).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    return [rows_of(10 + k, rows) for k in range(K)], rows_of(99, 2)


def _setups(jcfg, tcfg, kw, K, clients):
    seq = clients[0]["tokens"].shape[1]
    jprog, tprog = j_program(jcfg), get_split_program(tcfg)
    jw = jcm.program_workload(jprog, SMALL["batch_size"], seq)
    tw = cm.program_workload(tprog, SMALL["batch_size"], seq)
    cfg = {**SMALL, **kw}
    jsim = JSim(jw, J_DEVICES[:K], SERVER, jprog.op_candidates(),
                iterations=cfg["local_iters"], jitter=0.05, seed=3)
    tsim = SimulatedCluster(tw, T_DEVICES[:K], SERVER, tprog.op_candidates(),
                            iterations=cfg["local_iters"], jitter=0.05,
                            seed=3)
    return cfg, (jsim, JTransport(j_bw(J_DEVICES[:K]))), \
        (tsim, Transport(device_bandwidths(T_DEVICES[:K])))


def reference_init(jcfg, seed=SMALL["seed"]):
    """The reference's initial params (``PRNGKey(seed)``) as numpy."""
    return jax.tree_util.tree_map(
        np.asarray, j_program(jcfg).init(jax.random.PRNGKey(seed)))


def run_port(jcfg, tcfg, kw, data, K=2, asynchronous=False, **port_kw):
    """The port's run on the CPU from the reference's initial params."""
    cfg, _, (tsim, ttr) = _setups(jcfg, tcfg, kw, K, data[0])
    trun = run_federated_async if asynchronous else run_federated
    return trun(tcfg, data[0], data[1], FLConfig(**cfg), sim=tsim,
                transport=ttr, init_params=reference_init(jcfg, cfg["seed"]),
                device="cpu", **port_kw)


def run_pair(jcfg, tcfg, kw, K=2, asynchronous=False, data=None,
             port_over=None, seq=None):
    """The reference's run and the port's on the CPU from the reference's
    initial params, the same data (``fleet(tcfg, K)`` unless given),
    cluster and transport; ``port_over`` overrides ``kw`` for the port
    alone.  Returns ``(reference history, port history)``."""
    data = fleet(tcfg, K, seq=seq) if data is None else data
    cfg, (jsim, jtr), _ = _setups(jcfg, tcfg, kw, K, data[0])
    jrun = j_run_async if asynchronous else j_run
    jh = jrun(jcfg, data[0], data[1], JFLConfig(**cfg), sim=jsim,
              transport=jtr)
    th = run_port(jcfg, tcfg, {**kw, **(port_over or {})}, data, K,
                  asynchronous)
    return jh, th


def lane_errors(tparams, jparams):
    """Each leaf's lane errors relative to its largest reference entry
    (and to 1e-3, for a leaf near zero), flat numpy arrays."""
    jl = jax.tree_util.tree_leaves(jparams)
    tl = tree_leaves(tparams)
    assert len(tl) == len(jl)
    errs = []
    for t, j in zip(tl, jl):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        errs.append(np.abs(t.detach().numpy() - j).reshape(-1)
                    / max(float(np.abs(j).max()), 1e-3))
    return errs


def params_gap(tparams, jparams):
    """The largest error of any leaf relative to its largest reference
    entry (and to 1e-3, for a leaf near zero)."""
    return max(float(e.max()) for e in lane_errors(tparams, jparams))


def lane_readings(tparams, jparams):
    """(worst lane, the tree's share of lanes beyond LANE_REL)."""
    errs = lane_errors(tparams, jparams)
    share = (sum(int((e > LANE_REL).sum()) for e in errs)
             / sum(e.size for e in errs))
    return max(float(e.max()) for e in errs), share


def discrete_lanes(tparams, jparams, what):
    """The discrete-step runs' params check (the bounds above); returns
    (worst lane, the tree's share of lanes beyond LANE_REL)."""
    worst, share = lane_readings(tparams, jparams)
    assert share <= DISCRETE_TREE_SHARE, \
        f"{what}: {share:.3g} of the lanes beyond {LANE_REL}"
    assert worst <= DISCRETE_PARAMS_REL, \
        f"{what}: a lane {worst:.3g} of its leaf's max"
    return worst, share


def assert_same_run(th, jh, discrete, what, keys=("ops", "round_time",
                                                  "comm_time", "dropped",
                                                  "edge_time")):
    """The control plane exactly, the metric and params within the
    plain bounds or the discrete-step ones; returns (metric gap, params
    gap), and for a discrete run also the tree's share of lanes beyond
    LANE_REL."""
    for key in keys:
        np.testing.assert_array_equal(th[key], jh[key],
                                      err_msg=f"{what}: {key}")
    assert np.all(np.isfinite(th["accuracy"])), what
    metric = float(np.max(np.abs(th["accuracy"] - jh["accuracy"])
                          / np.abs(jh["accuracy"])))
    mrel = DISCRETE_METRIC_REL if discrete else PLAIN_METRIC_REL
    assert metric <= mrel, f"{what}: metric {metric:.3g} relative > {mrel}"
    if discrete:
        return (metric,) + discrete_lanes(th["params"], jh["params"], what)
    gap = params_gap(th["params"], jh["params"])
    assert gap <= PLAIN_PARAMS_REL, \
        f"{what}: params {gap:.3g} of a leaf's max > {PLAIN_PARAMS_REL}"
    return metric, gap


def check_sync_discrete(arch):
    """One family's smoke config (``torch_lm_cases.configs``) in sync sfl
    at the middle OP with the int8 cut, top-k 0.5 EF and int8 deltas,
    against the reference's run, within the discrete-step bounds."""
    from torch_lm_cases import configs
    jcfg, tcfg = configs(arch)
    jh, th = run_pair(jcfg, tcfg, dict(DISCRETE_KW, static_op=sfl_op(tcfg)))
    metric, worst, share = assert_same_run(th, jh, True, arch)
    print(f"{arch}: metric {metric:.3g} relative, worst lane {worst:.3g}, "
          f"{share:.3g} of the lanes beyond {LANE_REL}")


DISCRETE_KW = dict(mode="sfl", quantize_transfer=True, delta_density=0.5,
                   quantize_deltas=True)


def discrete_readings(arch):
    """check_sync_discrete's run of the reference, the port's and the
    port's FAULTS: each port run's (metric gap, worst lane, lane share)."""
    from torch_lm_cases import configs
    jcfg, tcfg = configs(arch)
    kw = dict(DISCRETE_KW, static_op=sfl_op(tcfg))
    data = fleet(tcfg, 2)
    jh, th = run_pair(jcfg, tcfg, kw, data=data)
    runs = {"sound": th}
    runs.update((name, run_port(jcfg, tcfg, {**kw, **fault}, data))
                for name, fault in FAULTS.items())
    return {name: (float(np.max(np.abs(h["accuracy"] - jh["accuracy"])
                                / np.abs(jh["accuracy"]))),)
            + lane_readings(h["params"], jh["params"])
            for name, h in runs.items()}


# the port's plain runs of check_sync_plain (the sequential engine), kept
# for check_engines_bitwise in the same test file: the same data, so the
# same run
PLAIN_RUNS = {}
# whisper-base's batched run against its sequential run, each lane over
# its leaf's largest entry: 8.25e-7 on the CPU (torch 2.13); see
# check_engines_bitwise
ENCDEC_REMAT_REL = 1e-6


def check_sync_plain(arch):
    """The same family and set-up in plain fp32 (no int8 cut, top-k or
    int8 deltas), within the plain bounds."""
    from torch_lm_cases import configs
    jcfg, tcfg = configs(arch)
    jh, th = run_pair(jcfg, tcfg, dict(mode="sfl", static_op=sfl_op(tcfg)))
    PLAIN_RUNS[arch] = th
    metric, gap = assert_same_run(th, jh, False, f"{arch} plain")
    print(f"{arch} plain: metric {metric:.3g} relative, params {gap:.3g}")


def check_engines_bitwise(arch, seq=None, cut=None, **over):
    """check_sync_plain's port run (sync sfl plain, K = 2, the sequential
    engine: ``torch.autograd.grad``) against the same set-up on the
    batched engine (``vmap`` of ``torch.func.grad``) from the same data:
    the history and the final params bit for bit.  ``seq`` gives the
    clients plain token rows of that length (``fleet``), ``cut`` maps
    both packages' configs to smaller ones (fewer layers), ``over`` sets
    other FLConfig fields (``rounds``, ``local_iters``).  whisper-base (encdec)
    alone parts, by its remat: under plain autograd ``layers.remat`` is
    ``torch.utils.checkpoint``, under ``torch.func`` ``_Remat``, which sums
    the encoder output's gradient one decoder layer at a time.  Its
    history is held exactly and its params within ENCDEC_REMAT_REL; with
    ``_Remat`` under both engines, or with ``cfg.remat`` off, its runs are
    bit for bit too (the first is checked here).  Returns the params'
    worst lane over its leaf's max."""
    from repro_torch.models import layers as Lyr
    from torch_lm_cases import configs
    jcfg, tcfg = configs(arch)
    if cut is not None:
        jcfg, tcfg = cut(jcfg), cut(tcfg)
    data = fleet(tcfg, 2, seq=seq)
    kw = dict(mode="sfl", static_op=sfl_op(tcfg), **over)

    def run(engine):
        return run_port(jcfg, tcfg, dict(kw, engine=engine), data)

    def same_history(a, b, what):
        for key in ("ops", "round_time", "comm_time", "dropped",
                    "edge_time", "accuracy"):
            np.testing.assert_array_equal(a[key], b[key],
                                          err_msg=f"{what}: {key}")

    def bitwise(a, b):
        return all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(a["params"]), tree_leaves(b["params"])))
    batched = run("batched")
    sequential = (None if seq or cut or over else PLAIN_RUNS.get(arch)) \
        or run("sequential")
    same_history(batched, sequential, arch)
    if tcfg.family != "encdec":
        assert bitwise(batched, sequential), f"{arch}: params differ"
        return 0.0
    gap = max(_rel(y, x) for x, y in zip(tree_leaves(batched["params"]),
                                         tree_leaves(sequential["params"])))
    assert gap <= ENCDEC_REMAT_REL, f"{arch}: params {gap:.3g} apart"

    def remat_apply_always(enabled, fn, *args):
        if not (enabled and torch.is_grad_enabled()):
            return fn(*args)
        return Lyr.remat_apply(fn, *args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Lyr, "remat", remat_apply_always)
        a, b = run("batched"), run("sequential")
    same_history(a, b, f"{arch}, _Remat under both engines")
    assert bitwise(a, b), f"{arch}: params differ with _Remat in both"
    return gap


def sfl_op(tcfg):
    """The OP of the sync sfl runs: the middle of the family's grid."""
    return get_split_program(tcfg).native_op // 2 or 1


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: test workers run side by side, and a run's
    fp32 sums keep one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# =============================================================================
# the modes of one config (test_torch_lm_federated_{dense,ssm}.py): the
# batched engine with widths and two edges, the async runtime, and resume
# =============================================================================
WIDTHS = (1.0, 0.5, 0.25)


def check_batched_widths_edges(jcfg, tcfg, seq=None):
    """Sync sfl on the batched engine with widths (1.0, 0.5, 0.25) and two
    edges, K=3, plain fp32: against the reference's batched run."""
    kw = dict(mode="sfl", static_op=sfl_op(tcfg), engine="batched",
              client_widths=WIDTHS, num_edges=2)
    jh, th = run_pair(jcfg, tcfg, kw, K=3, seq=seq)
    return assert_same_run(th, jh, False, f"{tcfg.name} batched widths")


def check_async(jcfg, tcfg, seq=None):
    """The async runtime, one report a buffer and a staleness discount
    (the two clients' reports interleave), plain fp32."""
    kw = dict(mode="sfl", static_op=sfl_op(tcfg), rounds=3, buffer_size=1,
              staleness_discount=0.5)
    jh, th = run_pair(jcfg, tcfg, kw, asynchronous=True, seq=seq)
    assert th["staleness"].max() > 0
    return assert_same_run(th, jh, False, f"{tcfg.name} async",
                           keys=("ops", "round_time", "comm_time", "dropped",
                                 "edge_time", "virtual_time", "staleness",
                                 "agg_weight_sum"))


def check_resume(jcfg, tcfg, tmp_path, seq=None):
    """A sync run with top-k 0.5 error feedback (so the EF rows are in the
    files), checkpointed every round: the port's run against the
    reference's; the port resumed from its own round-1 file equal to its
    unbroken run bit for bit; the port resumed from the reference's
    round-1 file matching the reference's round 2; the port's file read by
    the reference's ``restore_tree`` bitwise as the port reads it."""
    import shutil

    from repro.checkpoint import restore_tree as j_restore_tree
    from repro_torch.checkpoint import restore_tree
    kw = dict(mode="sfl", static_op=sfl_op(tcfg), delta_density=0.5,
              checkpoint_every=1)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    data = fleet(tcfg, 2, seq=seq)
    jh, th = run_pair(jcfg, tcfg, dict(kw, checkpoint_dir=str(jdir)),
                      data=data, port_over=dict(checkpoint_dir=str(tdir)))
    gaps = [assert_same_run(th, jh, True, f"{tcfg.name} checkpointed")]

    def resume_from(src, name):
        d = tmp_path / name
        d.mkdir()
        shutil.copy(src / "ckpt_00000001.npz", d / "ckpt_00000001.npz")
        return run_port(jcfg, tcfg, dict(kw, checkpoint_dir=str(d)), data,
                        resume=True)

    own = resume_from(tdir, "own")
    assert len(own["accuracy"]) == 1
    for key in ("ops", "round_time", "comm_time", "dropped", "edge_time",
                "accuracy"):
        np.testing.assert_array_equal(own[key], th[key][1:], err_msg=key)
    for a, b in zip(tree_leaves(own["params"]), tree_leaves(th["params"])):
        assert torch.equal(a, b)
    suffix = {k: (v[1:] if k != "params" else v) for k, v in jh.items()}
    gaps.append(assert_same_run(
        resume_from(jdir, "from_jax"), suffix, True,
        f"{tcfg.name} resumed from the reference's file"))
    path = str(tdir / "ckpt_00000001.npz")
    ef = np.zeros((2, FlatLayout(th["params"]).padded), np.float32)
    mine = restore_tree(path, {"params": th["params"],
                               "delta_errors": torch.from_numpy(ef)})
    theirs = j_restore_tree(path, {"params": jh["params"],
                                   "delta_errors": ef})
    assert float(mine["delta_errors"].abs().max()) > 0
    for a, b in zip(tree_leaves(mine),
                    jax.tree_util.tree_leaves(theirs)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return gaps


def phase6_readings():
    """chip_smoke phase 6's lm16m set-up with the int8 cut, top-k 0.5 and
    int8 deltas on each engine, from the reference's initial params: the
    reference's run against the port's and the port's FAULTS."""
    from repro.configs.lm_small import LM16M as J_LM16M
    from repro_torch.configs.lm_small import LM16M
    from repro_torch.data import split_clients, token_dataset
    clients = split_clients(token_dataset(16, 32, LM16M.vocab_size, seed=0),
                            2)
    test = token_dataset(4, 32, LM16M.vocab_size, seed=9)
    init = reference_init(J_LM16M)
    out = {}
    for engine in ("sequential", "batched"):
        kw = dict(SMALL, **DISCRETE_KW, static_op=3, engine=engine)
        jh = j_run(J_LM16M, clients, test, JFLConfig(**kw))
        for name, fault in {"sound": {}, **FAULTS}.items():
            h = run_federated(LM16M, clients, test,
                              FLConfig(**{**kw, **fault}),
                              init_params=init, device="cpu")
            out[f"lm16m {engine}, {name}"] = (
                float(np.max(np.abs(h["accuracy"] - jh["accuracy"])
                             / np.abs(jh["accuracy"]))),) + \
                lane_readings(h["params"], jh["params"])
    return out


MOE_CUT_KW = dict(mode="sfl", quantize_transfer=True)


def moe_engine_runs(arch, kw=MOE_CUT_KW):
    """The port's batched and sequential runs of ``arch``'s smoke config
    under ``kw`` (sync sfl at the middle OP) from the same data;
    ``{engine: history}``."""
    from torch_lm_cases import configs
    jcfg, tcfg = configs(arch)
    data = fleet(tcfg, 2)
    return {engine: run_port(jcfg, tcfg, dict(kw, static_op=sfl_op(tcfg),
                                              engine=engine), data)
            for engine in ("batched", "sequential")}


def moe_engine_readings(arch, kw=MOE_CUT_KW):
    """``moe_engine_runs``: the gap between the two engines (the -CE
    metric relative, the worst lane of its leaf's max) and whether their
    final params are bitwise equal, as a printable line."""
    runs = moe_engine_runs(arch, kw)
    a, b = runs["batched"], runs["sequential"]
    metric = float(np.max(np.abs(a["accuracy"] - b["accuracy"])
                          / np.abs(b["accuracy"])))
    tl, sl = tree_leaves(a["params"]), tree_leaves(b["params"])
    worst = max(_rel(y, x) for x, y in zip(tl, sl))
    return [f"{arch} {sorted(kw)}: batched vs sequential metric "
            f"{metric:.3g} relative, worst lane {worst:.3g} of its leaf's "
            f"max, params bitwise "
            f"{all(torch.equal(x, y) for x, y in zip(tl, sl))}"]


def _rel(a, b):
    """The largest difference over the largest entry of ``a``."""
    return float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)


def moe_cut_step_readings(arch="arctic-480b", lr=0.1, steps=12):
    """One client's SGD steps through the int8 cut from the reference's
    initial params, its two batches in turn, each step's gradient taken
    by ``torch.autograd.grad`` (the sequential engine's) and by
    ``torch.func.grad`` (the batched engine's, without its vmap), each
    trajectory on its own params: step 1's loss, cut input and gradient,
    then each step's cut input, int8 codes, routing choices and kept
    assignments, as printable lines.  Since ``silu``'s backward is one
    kernel under both (``layers.silu``), every line reads bit for bit."""
    from repro_torch import convert
    from repro_torch.kernels import quant_transfer as qt
    from repro_torch.models import layers as Lyr
    from torch_lm_cases import configs
    jcfg, tcfg = configs(arch)
    prog = get_split_program(tcfg)
    op = sfl_op(tcfg)
    rows = fleet(tcfg, 2)[0][0]
    batches = [{k: torch.from_numpy(np.ascontiguousarray(v[2 * i:2 * i + 2]))
                for k, v in rows.items()} for i in range(2)]
    p0 = convert.lm_params_from_numpy(reference_init(jcfg), device="cpu")
    seen = {"cut": [], "topi": [], "keep": []}
    cut, top_k, dispatch = (qt._FakeQuantInt8.apply, Lyr._top_k,
                            Lyr.moe_dispatch)

    def loss(p, b):
        return prog.loss_through_cut(p, b, op, quantize=True)

    def grads(p, b, how):
        for v in seen.values():
            v.clear()
        if how == "autograd":
            q = tree_map(lambda v: v.clone().requires_grad_(), p)
            value = loss(q, b)
            return value.detach(), dict(zip(
                _names(q), torch.autograd.grad(value, tree_leaves(q))))
        g, value = torch.func.grad_and_value(loss)(p, b)
        return value, dict(zip(_names(p), tree_leaves(g)))

    def record(key, value):
        seen[key].append(value.detach().clone())
        return value

    lines = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(qt._FakeQuantInt8, "apply",
                   staticmethod(lambda x: cut(record("cut", x))))
        mp.setattr(Lyr, "_top_k", lambda probs, k: (
            lambda r: (r[0], record("topi", r[1])))(top_k(probs, k)))
        mp.setattr(Lyr, "moe_dispatch", lambda cfg, topi: (
            lambda r: (r[0], r[1], record("keep", r[2])))(
                dispatch(cfg, topi)))
        params = {"autograd": p0, "func": p0}
        for i in range(steps):
            got = {}
            for how in ("autograd", "func"):
                value, g = grads(params[how], batches[i % 2], how)
                got[how] = dict(loss=value, g=g,
                                **{k: list(v) for k, v in seen.items()})
                params[how] = tree_unflatten(params[how], [
                    v - lr * g[n] for n, v in
                    zip(_names(params[how]), tree_leaves(params[how]))])
            a, f = got["autograd"], got["func"]
            if i == 0:
                lines.append(
                    f"{arch} step 1: loss bitwise "
                    f"{bool(torch.equal(a['loss'], f['loss']))}, cut input "
                    f"bitwise {all(map(torch.equal, a['cut'], f['cut']))}")
                diff = {n: (int((a["g"][n] != f["g"][n]).sum()),
                            a["g"][n].numel(), _rel(a["g"][n], f["g"][n]))
                        for n in a["g"]}
                moved = {n: d for n, d in diff.items() if d[0]}
                lines.append(
                    f"{arch} step 1 gradient: {len(moved)} of {len(diff)} "
                    f"leaves differ: " + (", ".join(
                        f"{n} {c}/{t} lanes (at most {r:.2g} of its max)"
                        for n, (c, t, r) in sorted(moved.items()))
                        or "none"))
            x, y = a["cut"][0], f["cut"][0]

            def apart(key):
                return [int((u != v).sum()) for u, v in zip(a[key], f[key])]
            qa, sa = qt.quantize_rows_plain(x.reshape(-1, x.shape[-1]))
            qf, sf = qt.quantize_rows_plain(y.reshape(-1, y.shape[-1]))
            lines.append(
                f"{arch} step {i + 1}: cut input {int((x != y).sum())} of "
                f"{x.numel()} lanes differ, at most {_rel(x, y):.2g} of its "
                f"max; int8 codes moved {int((qa != qf).sum())}; routing "
                f"choices differing per MoE layer {apart('topi')} of "
                f"{a['topi'][0].numel()}; kept assignments differing "
                f"{apart('keep')}; loss {float(a['loss']):.7g} vs "
                f"{float(f['loss']):.7g}")
    return lines


def _names(tree, prefix=""):
    """Each leaf's path, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree)
                for n in _names(t, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


if __name__ == "__main__":
    # the readings that set the discrete-step bounds, on the CPU (~2 min):
    #   PYTHONPATH=src:tests python tests/torch_fl_cases.py
    from torch_lm_cases import ARCHS
    torch.set_num_threads(1)

    def show(rows):
        for name, (metric, worst, share) in rows.items():
            print(f"{name}: metric {metric:.3g} relative, worst lane "
                  f"{worst:.3g}, {share:.3g} of the lanes beyond {LANE_REL}",
                  flush=True)
    if sys.argv[1:] == ["--moe-cut"]:
        # arctic's runs with the int8 cut step by step on the port's two
        # engines' gradients, and both MoE configs' whole runs (~20 s):
        #   PYTHONPATH=src:tests python tests/torch_fl_cases.py --moe-cut
        for line in (moe_cut_step_readings()
                     + moe_engine_readings("arctic-480b")
                     + moe_engine_readings("mixtral-8x22b")):
            print(line, flush=True)
        sys.exit(0)
    show(phase6_readings())
    for arch in ARCHS:
        show({f"{arch}, {name}": r
              for name, r in discrete_readings(arch).items()})
