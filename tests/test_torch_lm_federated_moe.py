"""The MoE family on the port's batched fleet engine, against the JAX
package's batched run (``jit(vmap(...))``).

* ``moe_dispatch`` and ``_moe_capacity`` compare the routing choices with
  ``arange(E)`` and scatter and combine out of place, so they run under
  ``torch.func.vmap``; on random routings that drop assignments they give
  the eager one-hot / in-place version's ``C``, slots, keep flags and
  output bit for bit (``_dispatch_one_hot`` / ``_capacity_in_place``
  below keep that version).
* ``vmap(grad(...))`` of an MoE layer's loss, the router's aux loss
  included (and arctic's dense residual FFN), equals a loop of ``grad``
  over the clients bit for bit on the CPU, with each client's capacity
  counted from its own tokens.
* ``run_federated(engine="batched")`` over the mixtral-8x22b and
  arctic-480b smoke configs at their capacity factor 1.25 (so tokens are
  dropped) against the reference's batched run, from its initial params:
  plain fp32 within 1e-5 (metric, relative; every lane of its leaf's max)
  and with the int8 cut, top-k 0.5 and int8 deltas within the
  discrete-step bounds of ``tests/torch_fl_cases.py``; OPs, modelled times
  and drops exact.  On the CPU (torch 2.13) arctic's discrete run reads
  its -CE metric 3.06e-4 relative (bound 5e-4), its worst lane 0.099 of
  its leaf's max and 0.82% of its lanes beyond 1e-4; mixtral's 1.9e-5,
  0.016 and 0.32%.
* The batched engine's whole run equals the sequential engine's bit for
  bit, plain and with the int8 cut, top-k 0.5 and int8 deltas.  That
  holds because ``silu`` is ``layers.silu``, whose backward is aten's
  ``silu_backward`` under both engines: ``F.silu`` under
  ``torch.func.grad`` took the decomposed formula, which rounds apart by
  an ulp, an int8 code at the cut moved a few steps later, routing
  choices and capacity slots followed, and arctic's cut read 5.25e-4
  against the reference.  ``python tests/torch_fl_cases.py --moe-cut``
  prints each step of arctic's cut run on both engines' gradients.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as L
from repro_torch.tree import tree_leaves as tree_leaves
from torch_fl_cases import (DISCRETE_KW, assert_same_run, moe_engine_runs,
                            one_intra_op_thread, run_pair, sfl_op)
from torch_lm_cases import configs

_ = one_intra_op_thread
MOE_ARCHS = ["mixtral-8x22b", "arctic-480b"]


def _dispatch_one_hot(cfg, topi):
    """The eager dispatch the vmap-safe one replaced (``F.one_hot``)."""
    T, k = topi.shape
    E = cfg.moe.num_experts
    C = max(1, int(cfg.moe.capacity_factor * T * k / E))
    flat_e = topi.reshape(-1)
    assign = F.one_hot(flat_e, E)
    pos = (assign.cumsum(0) - assign).gather(1, flat_e[:, None])[:, 0]
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos, torch.full_like(flat_e, E * C))
    return C, slot, keep


def _capacity_in_place(cfg, p, xf, topw, topi):
    """The eager capacity path it replaced (in-place scatter and
    ``index_add_``)."""
    T, d = xf.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    C, slot, keep = _dispatch_one_hot(cfg, topi)
    token_idx = torch.arange(T * k) // k
    buf = torch.zeros((E * C + 1, d), dtype=xf.dtype)
    buf[slot] = xf[token_idx]
    h = buf[:E * C].view(E, C, d)
    mid = L._expert_act(cfg, torch.bmm(h, p["w_gate"])) * torch.bmm(
        h, p["w_up"])
    y = torch.bmm(mid, p["w_down"]).reshape(E * C, d)
    gathered = y[slot.clamp(max=E * C - 1)]
    contrib = torch.where(keep[:, None],
                          topw.reshape(-1).to(xf.dtype)[:, None] * gathered,
                          torch.zeros((), dtype=xf.dtype))
    return torch.zeros((T, d), dtype=xf.dtype).index_add_(0, token_idx,
                                                          contrib)


def _moe_params(cfg, seed):
    return L.init_moe(torch.Generator().manual_seed(seed), cfg,
                      torch.float32)


@pytest.mark.parametrize("arch,T,skew,cf", [
    ("mixtral-8x22b", 40, 2.0, 1.25),
    ("mixtral-8x22b", 37, 3.0, 1.25),     # skewed routing: many drops
    ("arctic-480b", 64, 2.0, 1.25),
    ("arctic-480b", 5, 0.0, 0.5),         # C = 1
])
def test_dispatch_matches_in_place_version(arch, T, skew, cf):
    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    p = _moe_params(cfg, 3)
    rng = np.random.RandomState(T)
    xf = torch.from_numpy(rng.randn(T, cfg.d_model).astype(np.float32))
    E = cfg.moe.num_experts
    logits = rng.randn(T, E) + skew * np.linspace(1.0, 0.0, E)
    probs = torch.softmax(torch.from_numpy(logits.astype(np.float32)), -1)
    topw, topi = L._top_k(probs, cfg.moe.top_k)
    topw = topw / topw.sum(-1, keepdim=True)
    C, slot, keep = L.moe_dispatch(cfg, topi)
    C0, slot0, keep0 = _dispatch_one_hot(cfg, topi)
    assert C == C0
    assert torch.equal(slot, slot0) and torch.equal(keep, keep0)
    assert not bool(keep.all()), "the case must drop assignments"
    got = L._moe_capacity(cfg, p, xf, topw, topi)
    want = _capacity_in_place(cfg, p, xf, topw, topi)
    assert float(want.abs().max()) > 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layer_under_vmap_grad(arch):
    """Per client a different token count's worth of routing: the loss of
    one MoE block plus 0.01 of the router's aux loss; the batched
    gradient (every leaf of the block) equals the loop's bit for bit."""
    cfg = get_smoke_config(arch)
    n, B, S = 3, 2, 12
    rng = np.random.RandomState(5)
    base = _moe_params(cfg, 7)
    names = sorted(k for k in base if k != "dense")
    stacked = {k: torch.stack([base[k] * (1 + 0.1 * c) for c in range(n)])
               for k in names}
    if "dense" in base:
        stacked["dense"] = {k: torch.stack([v] * n)
                            for k, v in base["dense"].items()}
    x = torch.from_numpy(rng.randn(n, B, S, cfg.d_model).astype(np.float32))

    def loss(p, x):
        y = L.moe_block(cfg, p, x)
        return (y * y).mean() + 0.01 * L.moe_aux_loss(cfg, p, x)

    grad = torch.func.grad(loss)
    batched = torch.func.vmap(grad)(stacked, x)
    for c in range(n):
        one = grad({k: (v[c] if k != "dense" else
                        {kk: vv[c] for kk, vv in v.items()})
                    for k, v in stacked.items()}, x[c])
        for k in names:
            assert float(one[k].abs().max()) > 0, k
            torch.testing.assert_close(batched[k][c], one[k], rtol=0, atol=0)
        for kk, g in one.get("dense", {}).items():
            torch.testing.assert_close(batched["dense"][kk][c], g, rtol=0,
                                       atol=0)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("discrete", [False, True],
                         ids=["plain", "discrete"])
def test_batched_run_matches_reference(arch, discrete):
    jcfg, tcfg = configs(arch)
    assert tcfg.moe.capacity_factor == 1.25
    kw = dict(DISCRETE_KW if discrete else dict(mode="sfl"),
              static_op=sfl_op(tcfg), engine="batched")
    jh, th = run_pair(jcfg, tcfg, kw)
    print(arch, assert_same_run(th, jh, discrete,
                                f"{arch} batched{' discrete' * discrete}"))


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("kw", [dict(mode="sfl"), DISCRETE_KW],
                         ids=["plain", "discrete"])
def test_batched_run_is_sequential_bitwise(arch, kw):
    """The batched engine (``vmap`` of ``torch.func.grad``, the MoE
    dispatch out of place, capacity per client) against the sequential
    one (``torch.autograd.grad``, eager), the port's own ``silu``: the
    whole history and the final params bit for bit."""
    runs = moe_engine_runs(arch, kw)
    a, b = runs["batched"], runs["sequential"]
    for key in ("ops", "round_time", "comm_time", "dropped", "accuracy"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for x, y in zip(tree_leaves(a["params"]), tree_leaves(b["params"])):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
