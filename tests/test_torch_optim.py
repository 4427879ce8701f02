"""The port's optimizers and learning-rate schedules against the JAX
reference's (``repro/optim``): three steps from the same params and
gradients (numpy, seeded) give the same params within 1e-6 (observed: bit
for bit), and every schedule gives the same float32 rate at every step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim as topt
from repro_torch.tree import tree_leaves

ATOL = 1e-6


def _tree(rng):
    return {"actor": {"w0": rng.randn(6, 4), "b0": rng.randn(4)},
            "critic": {"w0": rng.randn(6, 1), "b0": rng.randn(1)},
            "layers": [{"w": rng.randn(3, 3, 2)}, {}, {"b": rng.randn(5)}]}


def _as(tree, fn, scale=1.0):
    if isinstance(tree, dict):
        return {k: _as(v, fn, scale) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as(v, fn, scale) for v in tree]
    return fn(np.asarray(tree * scale, np.float32))


SCHEDULES = {
    "constant": (lambda m: m.constant(3e-3)),
    "linear_warmup": (lambda m: m.linear_warmup(1e-2, 3)),
    "cosine": (lambda m: m.cosine(1e-2, 5, warmup_steps=1)),
    "wsd": (lambda m: m.wsd(1e-2, 4, warmup_frac=0.3, decay_frac=0.5)),
    "step_decay": (lambda m: m.step_decay(1e-2, [1, 2], [0.1, 0.01])),
}
# each optimizer with a schedule whose rate changes over the three steps,
# and AdamW as the PPO agent runs it (constant rate, clip 0.5)
OPTIMIZERS = {
    "sgd": (lambda m: m.sgd(SCHEDULES["step_decay"](m), momentum=0.9,
                            weight_decay=0.01)),
    "sgd-clip": (lambda m: m.sgd(SCHEDULES["wsd"](m), clip_norm=0.5)),
    "adamw": (lambda m: m.adamw(SCHEDULES["cosine"](m), weight_decay=0.1,
                                clip_norm=0.0)),
    "adamw-clip": (lambda m: m.adamw(SCHEDULES["linear_warmup"](m),
                                     weight_decay=0.0, clip_norm=0.5)),
    "adamw-ppo": (lambda m: m.adamw(SCHEDULES["constant"](m),
                                    weight_decay=0.0, clip_norm=0.5)),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_three_steps_match_reference(name):
    rng = np.random.RandomState(list(OPTIMIZERS).index(name))
    params = _tree(rng)
    # gradients large enough that the clip binds in the clipped cases
    grads = [_tree(rng) for _ in range(3)]
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    jp, tp = _as(params, jnp.asarray), _as(params, torch.from_numpy)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update(jp, _as(g, jnp.asarray, 3.0), js)
        tp, ts = to.update(tp, _as(g, torch.from_numpy, 3.0), ts)
    assert int(ts["step"]) == int(js["step"]) == 3
    jl, tl = jax.tree_util.tree_leaves(jp), tree_leaves(tp)
    assert len(jl) == len(tl) == 6
    for a, b in zip(jl, tl):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=ATOL)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.RandomState(3)
    g = _tree(rng)
    for max_norm in (0.1, 1e3):               # binding and not binding
        jc, jn = jopt.optimizers.clip_by_global_norm(_as(g, jnp.asarray),
                                                     max_norm)
        tc, tn = topt.clip_by_global_norm(_as(g, torch.from_numpy), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for a, b in zip(jax.tree_util.tree_leaves(jc), tree_leaves(tc)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=ATOL)


@pytest.mark.parametrize("sched", list(SCHEDULES))
def test_schedule_matches_reference_at_every_step(sched):
    js, ts = SCHEDULES[sched](jopt), SCHEDULES[sched](topt)
    for step in range(8):
        want = np.asarray(js(jnp.int32(step)))
        for arg in (step, torch.tensor(step, dtype=torch.int32)):
            got = ts(arg)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)

