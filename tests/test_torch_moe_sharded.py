"""The port's expert-parallel MoE block (``models.layers.moe_block`` under
``parallel.sharding.use_rules``: ``_moe_block_sharded``) against its local
block and the JAX reference's, on the reference test's cases: the
mixtral-8x22b and arctic-480b smoke configs with 4 and 8 experts, top-2,
capacity factor 8.0 (no assignment is dropped, so local and sharded
compute one function), ``S`` in {8, 1}, from the reference's seeded
weights.  Meshes are CPU places of one device: the reference test's
(2, 2), case A (``E % tp == 0``: a place's experts) at (1, 4) and (2, 4),
case B (``d_ff`` sliced: 4 experts over 8 places, 8 over 16) at (1, 8) and
(1, 16), FSDP (the ``d`` dim gathered over ``data``) at (2, 2), (2, 4)
and (4, 2).

* Sharded vs the reference's local block: within 1e-4, the reference
  test's bound (``tests/test_moe_sharded.py``); vs the port's local block:
  within 1e-5 (the same products in other shapes, and case B's ``d_ff``
  partial sums added over ``model``).
* Gradients (params and input, ``sum(c * out)`` for a seeded ``c``) of the
  sharded block against the local block's: within 1e-5 of each leaf's max.
* ``moe_int8_gather()``: the rowwise int8 gather's straight-through
  gradient equals the plain gather's bit for bit; the sharded output
  stays within ``INT8_GATHER_REL`` of the largest local value (rowwise
  int8 moves a weight by at most half a code step, 1/254 of its row's
  absmax; observed 0.57-1.2% at this size); and, in one subprocess with
  eight forced JAX host devices, the reference's sharded block under
  ``moe_int8_gather()`` agrees with the port's within 1e-5 (the same codes
  and scales; fp32 sums in other orders).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import layers as JL
from repro_torch.configs.base import MoEConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import layers as L
from repro_torch.parallel.sharding import (
    make_axis_rules,
    make_flat_mesh,
    use_rules,
)

INT8_GATHER_REL = 0.05
CASES = {"mixtral-8x22b": dict(num_experts=4, top_k=2),
         "arctic-480b": dict(num_experts=8, top_k=2, dense_residual=True)}
MESHES = [(2, 2), (1, 4), (2, 4), (1, 8), (1, 16), (4, 2)]
CPU16 = [torch.device("cpu")] * 16


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: test workers running side by side then do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    patch = CASES[arch]
    return (dataclasses.replace(get_smoke_config(arch), moe=MoEConfig(
                capacity_factor=8.0, **patch)),
            dataclasses.replace(j_smoke(arch), moe=JMoEConfig(
                capacity_factor=8.0, **patch)))


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """The reference's seeded weights and inputs (its test's key), in
    both packages."""
    arch = request.param
    cfg, jcfg = _cfgs(arch)
    key = jax.random.PRNGKey(0)
    jp = JL.init_moe(key, jcfg, jnp.float32)
    tp = jax.tree_util.tree_map(lambda v: torch.from_numpy(np.array(v)), jp)
    xs = {S: jax.random.normal(key, (4, S, jcfg.d_model)) * 0.5
          for S in (8, 1)}
    return dict(arch=arch, cfg=cfg, jcfg=jcfg, jp=jp, tp=tp, xs=xs)


def _sharded(cfg, p, x, shape, int8=False):
    mesh = make_flat_mesh(shape, devices=CPU16)
    with use_rules(make_axis_rules(mesh)), L.moe_int8_gather(int8):
        return L.moe_block(cfg, p, x)


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_matches_local_and_reference(case, shape):
    cfg = case["cfg"]
    # case A where the experts divide over model, else case B (d_ff)
    assert cfg.moe.num_experts % shape[1] == 0 or cfg.d_ff % shape[1] == 0
    for S, jx in case["xs"].items():
        x = torch.from_numpy(np.array(jx))
        jlocal = np.asarray(JL._moe_block_local(case["jcfg"], case["jp"],
                                                jx))
        local = L._moe_block_local(cfg, case["tp"], x)
        got = _sharded(cfg, case["tp"], x, shape)
        assert got.shape == x.shape
        np.testing.assert_allclose(got.numpy(), jlocal, rtol=0, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), local.numpy(), rtol=0,
                                   atol=1e-5)


def _grads(p, x, c, fn):
    leaves = {k: v for k, v in p.items() if k != "dense"}
    leaves.update({f"dense/{k}": v for k, v in p.get("dense", {}).items()})
    leaves = {k: v.clone().requires_grad_() for k, v in leaves.items()}
    q = {k: v for k, v in leaves.items() if "/" not in k}
    if "dense" in p:
        q["dense"] = {k.split("/")[1]: v for k, v in leaves.items()
                      if "/" in k}
    xx = x.clone().requires_grad_()
    (fn(q, xx) * c).sum().backward()
    return {**{k: v.grad for k, v in leaves.items()}, "x": xx.grad}


@pytest.mark.parametrize("shape", [(2, 2), (1, 8), (2, 4)])
def test_sharded_gradients_match_local(case, shape):
    cfg = case["cfg"]
    x = torch.from_numpy(np.array(case["xs"][8]))
    c = torch.from_numpy(np.random.RandomState(2).randn(*x.shape)
                         .astype(np.float32))
    want = _grads(case["tp"], x, c, lambda q, xx: L._moe_block_local(
        cfg, q, xx))
    got = _grads(case["tp"], x, c, lambda q, xx: _sharded(cfg, q, xx, shape))
    assert got.keys() == want.keys()
    for k in want:
        scale = max(1.0, float(want[k].abs().max()))
        assert float((got[k] - want[k]).abs().max()) <= 1e-5 * scale, k
        assert want[k].abs().max() > 0, k


def test_int8_gather_straight_through_gradient():
    """``_gather_w`` under int8: the forward is the rowwise int8 round
    trip of each shard, the gradient the plain gather's (each shard's
    slice of the summed cotangents), bit for bit."""
    rng = np.random.RandomState(3)
    w = torch.from_numpy(rng.randn(2, 8, 6).astype(np.float32))
    cts = [torch.from_numpy(rng.randn(2, 8, 6).astype(np.float32))
           for _ in range(2)]
    places = [torch.device("cpu")] * 2
    for axis in (1, 2):
        grads = []
        for int8 in (False, True):
            ww = w.clone().requires_grad_()
            shards = list(ww.chunk(2, dim=axis))
            outs = L._gather_w(shards, axis, places, int8)
            if not int8:
                for o in outs:
                    assert torch.equal(o, w)
            else:
                q_axis = 1 if axis == 2 else 2
                for o in outs:
                    for s, os_ in zip(shards, o.chunk(2, dim=axis)):
                        scale = (s.detach().abs().amax(q_axis, keepdim=True)
                                 .clamp_min(1e-12) / 127.0)
                        assert float((os_.detach() - s.detach()).abs()
                                     .div(scale).max()) <= 0.5 + 1e-6
            sum((o * c).sum() for o, c in zip(outs, cts)).backward()
            grads.append(ww.grad)
        assert torch.equal(grads[0], grads[1])
        assert torch.equal(grads[0], cts[0] + cts[1])


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)])
def test_int8_gather_stays_near_local(case, shape):
    cfg = case["cfg"]
    for S, jx in case["xs"].items():
        x = torch.from_numpy(np.array(jx))
        local = L._moe_block_local(cfg, case["tp"], x)
        got = _sharded(cfg, case["tp"], x, shape, int8=True)
        err = float((got - local).abs().max() / local.abs().max())
        assert 0 < err <= INT8_GATHER_REL, err


JAX_INT8 = """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_smoke_config
    from repro.configs.base import MoEConfig
    from repro.models import layers as L
    from repro.parallel.sharding import make_axis_rules, use_rules

    out = {}
    cases = [("mixtral-8x22b", dict(num_experts=4, top_k=2)),
             ("arctic-480b", dict(num_experts=8, top_k=2,
                                  dense_residual=True))]
    for arch, patch in cases:
        cfg = dataclasses.replace(get_smoke_config(arch), moe=MoEConfig(
            capacity_factor=8.0, **patch))
        key = jax.random.PRNGKey(0)
        p = L.init_moe(key, cfg, jnp.float32)
        for shape in ((2, 4),):
            mesh = jax.make_mesh(shape, ("data", "model"))
            fn = jax.jit(lambda p, x: L.moe_block(cfg, p, x))
            for S in (8, 1):
                x = jax.random.normal(key, (4, S, cfg.d_model)) * 0.5
                with use_rules(make_axis_rules(mesh)), L.moe_int8_gather():
                    out[f"{arch}/{shape[0]}x{shape[1]}/{S}"] = np.asarray(
                        fn(p, x))
    np.savez(sys.argv[1], **out)
    print("saved", len(out))
"""


def test_int8_gather_matches_reference_sharded(tmp_path):
    """The reference's ``_moe_block_sharded`` under ``moe_int8_gather()``
    on a (2, 4) JAX mesh of eight forced host devices (its numbers exist
    only there; FSDP over data, experts over model), against the port's on
    eight CPU places."""
    path = tmp_path / "jax_int8.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_INT8),
                          str(path)], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    want = np.load(path)
    assert len(want.files) == 4
    key = jax.random.PRNGKey(0)
    for arch in CASES:
        cfg, jcfg = _cfgs(arch)
        p = jax.tree_util.tree_map(lambda v: torch.from_numpy(np.array(v)),
                                   JL.init_moe(key, jcfg, jnp.float32))
        for shape in ((2, 4),):
            for S in (8, 1):
                x = torch.from_numpy(np.array(jax.random.normal(
                    key, (4, S, jcfg.d_model)) * 0.5))
                got = _sharded(cfg, p, x, shape, int8=True)
                np.testing.assert_allclose(
                    got.numpy(), want[f"{arch}/{shape[0]}x{shape[1]}/{S}"],
                    rtol=0, atol=1e-5)
