"""The port's step builders (``repro_torch.launch.steps``) against the JAX
reference's (``repro.launch.steps``), on the smoke configs of every
family (dense, MoE, VLM, SSM, hybrid, encdec), the port's seeded params
carried across to the reference by ``convert``, on the CPU.

* ``make_train_step`` with the config's own optimizer (``make_opt``), on
  the dense, MoE and SSM configs: the loss within 1e-6 relative
  (``test_torch_lm_loss.py``'s bound), every param after the step within
  1e-5 (``test_torch_train.py``'s, after a few AdamW steps);
* ``make_prefill_step`` / ``make_decode_step``: logits and caches within
  2e-5 absolute, 1e-5 relative (``test_torch_transformer.py``'s bound);
* ``make_local_sync_steps`` over 2 pods (one batch row each, the same
  start): each pod's loss and params as the train step's bounds, and the
  sync step equal to the reference's within 1e-5 and, in the port, to
  ``(p0 + p1) * 0.5`` bit for bit;
* the train step on ``meta`` stand-ins: the real run's output shapes and
  dtypes, nothing launched;
* the optimizers after the rate and bias corrections became 0-d fp32
  tensors (no ``float()``), bit for bit the Python-float update they
  replace.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_lm_cases import batch, jax_batch, torch_batch

from repro.configs import registry as JR
from repro.configs.base import ShapeConfig as JShape
from repro.launch import steps as JS
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import steps as S
from repro_torch.models import api
from repro_torch.optim import schedule
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.parallel.sharding import path_leaves
from repro_torch.tree import tree_leaves, tree_map

LOSS_REL, PARAM_ATOL = 1e-6, 1e-5
ATOL, RTOL = 2e-5, 1e-5
TARGET = 56
# one smoke config a family: dense, MoE, VLM, SSM, hybrid, encdec
FAMILIES = ("qwen3-0.6b", "mixtral-8x22b", "internvl2-2b", "mamba2-780m",
            "recurrentgemma-9b", "whisper-base")
# the train step's families (the VLM's, the hybrid's and encdec's train
# steps differ only in api.loss, whose value and gradient
# tests/test_torch_lm_loss.py holds against the reference; compiling the
# reference's step for each would double this file's time)
TRAIN_FAMILIES = ("qwen3-0.6b", "mixtral-8x22b", "mamba2-780m")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j_flat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_close(ttree, jtree, atol, rtol, what):
    t, j = path_leaves(ttree), _j_flat(jtree)
    assert sorted(t) == sorted(j), what
    for path, want in j.items():
        got = t[path].detach().numpy()
        assert got.shape == want.shape, (what, path)
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol,
                                   err_msg=f"{what}: {path}")


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """``arch``'s smoke config in both packages, the same params on both
    sides and a seeded batch of two rows."""
    jcfg, tcfg = JR.get_smoke_config(arch), TR.get_smoke_config(arch)
    jp, tp = _params(tcfg)
    return arch, jcfg, tcfg, jp, tp, batch(tcfg)


def _params(tcfg):
    """The port's params from a seed and the reference's copy (``convert``
    carries them across; the reference's own init would add seconds of
    threefry draws a config)."""
    tp = api.init(tcfg, 0, device="cpu")
    return jax.tree_util.tree_map(jnp.asarray,
                                  convert.lm_params_to_numpy(tp)), tp


@pytest.mark.parametrize("arch", TRAIN_FAMILIES)
def test_train_step_matches_reference(arch):
    _, jcfg, tcfg, jp, tp, b = _setup(arch)
    jopt, topt = JS.make_opt(jcfg), S.make_opt(tcfg)
    jl, jp2, jo2 = jax.jit(JS.make_train_step(jcfg, jopt))(
        jp, jopt.init(jp), jax_batch(b))
    tl, tp2, to2 = S.make_train_step(tcfg, topt)(tp, topt.init(tp),
                                                  torch_batch(b))
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    _assert_trees_close(tp2, jp2, PARAM_ATOL, 0, f"{arch} params")
    assert int(to2["step"]) == int(jo2["step"]) == 1
    # the step moved the params: the comparison is not of the start
    assert max(float((a - c).abs().max()) for a, c in
               zip(tree_leaves(tp2), tree_leaves(tp))) > 1e-5


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_steps_match_reference(arch):
    _, jcfg, tcfg, jp, tp, b = _setup(arch)
    jprefill = JS.make_prefill_step(jcfg, JShape("t", TARGET, 2, "prefill"))
    tprefill = S.make_prefill_step(tcfg, ShapeConfig("t", TARGET, 2,
                                                     "prefill"))
    jlog, jcache = jax.jit(jprefill)(jp, jax_batch(b))
    tlog, tcache = tprefill(tp, torch_batch(b))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=RTOL)
    _assert_trees_close(tcache, jcache, ATOL, RTOL, f"{arch} prefill cache")
    pos = b["tokens"].shape[1]
    token = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
    jlog, jcache = jax.jit(JS.make_decode_step(jcfg))(
        jp, jcache, jnp.asarray(token), jnp.asarray(pos, jnp.int32))
    tlog, tcache = S.make_decode_step(tcfg)(
        tp, tcache, torch.from_numpy(token), torch.tensor(pos))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=RTOL)
    _assert_trees_close(tcache, jcache, ATOL, RTOL, f"{arch} decode cache")


def _stack(tree, n, np_mod):
    return jax.tree_util.tree_map(lambda x: np_mod.stack([x] * n), tree)


@pytest.mark.parametrize("arch", ["qwen3-0.6b"])
def test_local_sync_steps_match_reference(arch):
    """Two pods from one start, each its own batch row: the vmapped
    local step (flash's vmap rule folds the pods into B; the SSD scan's
    runs a call a pod) and the FedAvg sync."""
    _, jcfg, tcfg, jp, tp, b = _setup(arch)   # row i: pod i's batch
    jopt, topt = JS.make_opt(jcfg), S.make_opt(tcfg)
    jlocal, jsync = JS.make_local_sync_steps(jcfg, jopt, 2)
    tlocal, tsync = S.make_local_sync_steps(tcfg, topt, 2)
    jpp = _stack(jp, 2, jnp)
    joo = _stack(jopt.init(jp), 2, jnp)
    tpp = tree_map(lambda x: torch.stack([x, x]), tp)
    too = tree_map(lambda x: torch.stack([x, x]), topt.init(tp))
    jb = {k: jnp.asarray(v[:, None]) for k, v in b.items()}
    tb = {k: torch.from_numpy(v[:, None]) for k, v in b.items()}
    jl, jpp2, _ = jax.jit(jlocal)(jpp, joo, jb)
    tl, tpp2, too2 = tlocal(tpp, too, tb)
    assert tl.shape == (2,) and int(too2["step"][1]) == 1
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0,
                               rtol=LOSS_REL)
    _assert_trees_close(tpp2, jpp2, PARAM_ATOL, 0, f"{arch} local step")
    # each pod is the train step on its own row
    for i in range(2):
        _, alone, _ = S.make_train_step(tcfg, topt)(
            tp, topt.init(tp), {k: v[i] for k, v in tb.items()})
        for x, y in zip(tree_leaves(tpp2), tree_leaves(alone)):
            torch.testing.assert_close(x[i], y, atol=PARAM_ATOL, rtol=0)
    # the pods parted, and the sync brings them together
    assert max(float((x[0] - x[1]).abs().max())
               for x in tree_leaves(tpp2)) > 0
    synced, jsynced = tsync(tpp2), jsync(jpp2)
    _assert_trees_close(synced, jsynced, PARAM_ATOL, 0, f"{arch} sync")
    for x, y in zip(tree_leaves(synced), tree_leaves(tpp2)):
        want = (y[0] + y[1]) * 0.5
        assert torch.equal(x[0], want) and torch.equal(x[1], want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_train_step_has_the_real_run_shapes(arch):
    _, _, tcfg, _, tp, b = _setup(arch)
    opt = S.make_opt(tcfg)
    real = S.make_train_step(tcfg, opt)(tp, opt.init(tp), torch_batch(b))
    mp = S.abstract_params(tcfg, torch.float32)
    mb = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                         device="meta") for k, v in b.items()}
    before = dict(LAUNCHES)
    abstract = S.make_train_step(tcfg, opt)(mp, S.abstract_opt_state(opt, mp),
                                            mb)
    assert dict(LAUNCHES) == before
    got, want = path_leaves(abstract), path_leaves(real)
    assert sorted(got) == sorted(want)
    for path, t in want.items():
        assert got[path].device.type == "meta", path
        assert (tuple(got[path].shape), got[path].dtype) == \
            (tuple(t.shape), t.dtype), path


# =============================================================================
# the optimizers: 0-d fp32 tensors where Python floats were
# =============================================================================
def _float_update(name, sched, params, grads, state):
    """The update as it read the rate and bias corrections before: Python
    floats from ``float()`` of the same fp32 tensors."""
    step = state["step"] + 1
    lr = float(sched(state["step"]))
    p32 = {k: v.float() for k, v in params.items()}
    g32 = {k: v.float() for k, v in grads.items()}
    if name == "sgd":
        mom = {k: 0.9 * state["mom"][k] + g32[k] for k in params}
        return ({k: (p32[k] - lr * mom[k]).to(params[k].dtype)
                 for k in params}, {"step": state["step"] + 1, "mom": mom})
    if name == "adamw":
        b1, b2, eps = 0.9, 0.999, 1e-8
        bc1 = float(1 - b1 ** step.to(torch.float32))
        bc2 = float(1 - b2 ** step.to(torch.float32))
        m = {k: b1 * state["m"][k] + (1 - b1) * g32[k] for k in params}
        v = {k: b2 * state["v"][k] + (1 - b2) * torch.square(g32[k])
             for k in params}
        return ({k: (p32[k] - lr * ((m[k] / bc1) / (torch.sqrt(v[k] / bc2)
                                                      + eps) + 0.0 * p32[k])
                     ).to(params[k].dtype) for k in params},
                {"step": step, "m": m, "v": v})
    eps = 1e-30
    beta2 = float(1.0 - step.to(torch.float32) ** -0.8)
    out, stats = {}, {}
    for k in params:
        g2 = torch.square(g32[k]) + eps
        s = state["stats"][k]
        vr = beta2 * s["vr"] + (1 - beta2) * g2.mean(dim=-1)
        vc = beta2 * s["vc"] + (1 - beta2) * g2.mean(dim=-2)
        denom = (vr[..., None] * vc[..., None, :]
                 / torch.clamp(vr.mean(dim=-1)[..., None, None], min=eps))
        u = g32[k] / torch.sqrt(torch.clamp(denom, min=eps))
        rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
        u = u / torch.clamp(rms / 1.0, min=1.0)
        out[k] = (p32[k] - lr * u).to(params[k].dtype)
        stats[k] = {"vr": vr, "vc": vc}
    return out, {"step": step, "stats": stats}


@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_optimizers_bitwise_the_python_float_update(name, dtype):
    rng = np.random.RandomState(3)
    sched = schedule.cosine(3e-3, total_steps=6, warmup_steps=2)
    opt = make_optimizer(name, sched, clip_norm=0.0) if name != "adafactor" \
        else make_optimizer(name, sched)
    params = {k: torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                  ).to(dtype)
              for k, shape in (("a", (5, 7)), ("b", (2, 3, 4)))}
    state = opt.init(params)
    old_p, old_s = params, opt.init(params)
    for _ in range(5):
        grads = {k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32)
                                     ).to(dtype) for k, v in params.items()}
        params, state = opt.update(params, grads, state)
        old_p, old_s = _float_update(name, sched, old_p, grads, old_s)
        for k in params:
            assert torch.equal(params[k], old_p[k]), (name, k)
    assert int(state["step"]) == 5
    # the scalars themselves: a 0-d fp32 tensor and its Python float give
    # the same bits in each fp32 kernel the updates use
    x = torch.from_numpy(rng.randn(1000).astype(np.float32))
    for s in torch.from_numpy(rng.rand(50).astype(np.float32)):
        for op in (torch.mul, torch.div, torch.add, torch.sub):
            assert torch.equal(op(x, s), op(x, float(s)))
        assert torch.equal(s * x, float(s) * x)
        assert torch.equal((1 - s) * x, (1 - float(s)) * x)
