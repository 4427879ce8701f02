"""The port's mixture of experts against the JAX reference: the MoE block
(routing, capacity dispatch with drops, the exact decode path, arctic's
dense residual) and whole mixtral-8x22b and arctic-480b smoke models.

Params come from the reference's ``api.init`` and are carried across by
``convert``; inputs are numpy from a seed.  The block runs at the configs'
own capacity factor 1.25, where tokens are dropped: the port must drop the
same (token, choice) pairs, which the reference's own expressions
(``layers.py`` ``_moe_block_local``) give here from its ``lax.top_k``.
Decode against the full forward runs at capacity factor 8.0, as the
reference's ``test_decode_matches_full_forward`` does: a prefill that drops
nothing computes what decode computes.

Tolerances: 1e-5 on the block's output (O(1) values; the experts' fp32
sums run in another order in each framework), 2e-5 absolute (rtol 1e-5) on
the models' hidden states, logits and caches as in
tests/test_torch_transformer.py, and the reference's 2e-4 for decode
against the full forward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import registry as R
from repro.models import api as japi
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import arctic_480b, mixtral_8x22b
from repro_torch.models import api as tapi
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

ATOL, RTOL = 2e-5, 1e-5
BLOCK_ATOL = 1e-5
STEPWISE_TOL = 2e-4
SEQ, TARGET = 70, 80

_CONFIGS = {"mixtral-8x22b": mixtral_8x22b.smoke_config,
            "arctic-480b": arctic_480b.smoke_config}
# the reference's functions compiled once per config and shape (eager
# calls would trace and compile each layer scan anew)
_jforward = jax.jit(JT.forward, static_argnums=0)
_jprefill = jax.jit(JT.prefill, static_argnums=0,
                    static_argnames="target_seq")
_jdecode = jax.jit(JT.decode_step, static_argnums=0)
_jmoe = jax.jit(JL.moe_block, static_argnums=0)


def _with_cf(cfg, cf):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


@pytest.fixture(scope="module", params=list(_CONFIGS))
def setup(request):
    name = request.param
    jcfg, tcfg = R.get_smoke_config(name), _CONFIGS[name]()
    jp = jax.jit(japi.init, static_argnums=(0, 2))(
        jcfg, jax.random.PRNGKey(0), jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    tp = convert.lm_params_from_numpy(np_params, device="cpu")
    toks = np.random.RandomState(1).randint(
        0, tcfg.vocab_size, (2, SEQ)).astype(np.int32)
    return name, jcfg, tcfg, jp, tp, np_params, toks


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


def _layer0_moe(setup):
    _, jcfg, tcfg, jp, tp, _, _ = setup
    jm = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["moe"])
    tm = TT.layer_params(tp, 0)["moe"]
    return jcfg, tcfg, jm, tm


def _reference_keep(jcfg, jm, xf):
    """The reference's routing and drop mask for ``xf`` (T, d), by its
    own expressions."""
    E, k = jcfg.moe.num_experts, jcfg.moe.top_k
    T = xf.shape[0]
    probs = jax.nn.softmax((xf @ jm["router"]).astype(jnp.float32), axis=-1)
    topw, topi = lax.top_k(probs, k)
    C = max(1, int(jcfg.moe.capacity_factor * T * k / E))
    flat_e = topi.reshape(-1)
    assign = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos_all = jnp.cumsum(assign, axis=0) - assign
    pos = jnp.take_along_axis(pos_all, flat_e[:, None], axis=1)[:, 0]
    return (np.asarray(topw / jnp.sum(topw, -1, keepdims=True)),
            np.asarray(topi), C, np.asarray(pos < C))


def _hidden(shape, seed, shared=0.0):
    """Unit normal rows; ``shared`` adds one direction common to every
    row, which skews the routing as a layer's real hidden states do."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape) + shared * rng.randn(shape[-1])
    return x.astype(np.float32)


# =============================================================================
# the MoE block
# =============================================================================
def test_block_with_drops_matches(setup):
    """Capacity factor 1.25: the same routing, the same capacity, the same
    dropped (token, choice) pairs, and the output within 1e-5."""
    jcfg, tcfg, jm, tm = _layer0_moe(setup)
    x = _hidden((2, SEQ, tcfg.d_model), 2, shared=1.0)
    xf = x.reshape(-1, tcfg.d_model)
    want_w, want_i, want_c, want_keep = _reference_keep(jcfg, jm,
                                                        jnp.asarray(xf))
    topw, topi = TL.moe_route(tcfg, tm, torch.from_numpy(xf))
    C, slot, keep = TL.moe_dispatch(tcfg, topi)
    np.testing.assert_array_equal(topi.numpy(), want_i)
    _close(topw.numpy(), want_w, atol=1e-6, rtol=1e-6)
    assert C == want_c
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert (~keep).sum() > 0, "the case must drop assignments"
    E = tcfg.moe.num_experts
    assert int((slot == E * C).sum()) == int((~keep).sum())
    want = _jmoe(jcfg, jm, jnp.asarray(x))
    got = TL.moe_block(tcfg, tm, torch.from_numpy(x))
    _close(got.numpy(), want, atol=BLOCK_ATOL, rtol=0)


def test_block_decode_step_matches(setup):
    """S == 1: the reference's ``_moe_decode_exact`` (``ragged_dot``)
    against the port's per-expert products; no drops."""
    jcfg, tcfg, jm, tm = _layer0_moe(setup)
    x = _hidden((5, 1, tcfg.d_model), 3)
    want = _jmoe(jcfg, jm, jnp.asarray(x))
    got = TL.moe_block(tcfg, tm, torch.from_numpy(x))
    _close(got.numpy(), want, atol=BLOCK_ATOL, rtol=0)


def test_routing_ties_go_to_the_lower_expert(setup):
    """Two router columns made equal tie every token's probabilities:
    ``lax.top_k`` keeps the lower expert first, and so must the port; the
    block's output follows in both branches."""
    jcfg, tcfg, jm, tm = _layer0_moe(setup)
    router = np.array(jm["router"])
    router[:, 2] = router[:, 0]
    jm = {**jm, "router": jnp.asarray(router)}
    tm = {**tm, "router": torch.from_numpy(router)}
    for shape, seed in (((2, SEQ, tcfg.d_model), 4),
                        ((6, 1, tcfg.d_model), 5)):
        x = _hidden(shape, seed)
        xf = x.reshape(-1, tcfg.d_model)
        _, want_i, _, want_keep = _reference_keep(jcfg, jm, jnp.asarray(xf))
        _, topi = TL.moe_route(tcfg, tm, torch.from_numpy(xf))
        np.testing.assert_array_equal(topi.numpy(), want_i)
        if shape[1] > 1:
            _, _, keep = TL.moe_dispatch(tcfg, topi)
            np.testing.assert_array_equal(keep.numpy(), want_keep)
        want = _jmoe(jcfg, jm, jnp.asarray(x))
        got = TL.moe_block(tcfg, tm, torch.from_numpy(x))
        _close(got.numpy(), want, atol=BLOCK_ATOL, rtol=0)


@pytest.mark.parametrize("seq", [1, SEQ])
def test_dense_residual_adds_the_ffn(seq):
    """arctic: the dense FFN on the block's input is added in both
    branches, in the port as in the reference."""
    jcfg = R.get_smoke_config("arctic-480b")
    tcfg = arctic_480b.smoke_config()
    assert tcfg.moe.dense_residual
    jm = jax.jit(JL.init_moe, static_argnums=(1, 2))(
        jax.random.PRNGKey(3), jcfg, jnp.float32)
    tm = convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm), device="cpu")
    x = _hidden((3, seq, tcfg.d_model), 6)
    xt = torch.from_numpy(x)
    got = TL.moe_block(tcfg, tm, xt)
    plain = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, dense_residual=False))
    parts = TL.moe_block(plain, tm, xt) + TL.ffn(tm["dense"], xt,
                                                 tcfg.mlp_act)
    torch.testing.assert_close(got, parts, atol=0, rtol=0)
    _close(got.numpy(), _jmoe(jcfg, jm, jnp.asarray(x)),
           atol=BLOCK_ATOL, rtol=0)


def test_exact_path_equals_capacity_path_without_drops(setup):
    """At a capacity that drops nothing, the dispatch path and the exact
    decode path compute one function (what chip_smoke checks on a real
    mixtral layer)."""
    _, tcfg, _, tm = _layer0_moe(setup)
    cfg = _with_cf(tcfg, 8.0)
    xf = torch.from_numpy(_hidden((2 * SEQ, cfg.d_model), 7))
    topw, topi = TL.moe_route(cfg, tm, xf)
    assert bool(TL.moe_dispatch(cfg, topi)[2].all())
    torch.testing.assert_close(
        TL._moe_capacity(cfg, tm, xf, topw, topi),
        TL._moe_decode_exact(cfg, tm, xf, topw, topi), atol=1e-6, rtol=0)


# =============================================================================
# whole models
# =============================================================================
def test_forward_hidden_matches(setup):
    _, jcfg, tcfg, jp, tp, _, toks = setup
    jh, _ = _jforward(jcfg, jp, jnp.asarray(toks))
    th, _ = TT.forward(tcfg, tp, torch.from_numpy(toks))
    _close(th.numpy(), jh)


def test_prefill_logits_and_cache_match(setup):
    name, jcfg, tcfg, jp, tp, _, toks = setup
    jl, jc = _jprefill(jcfg, jp, jnp.asarray(toks), target_seq=TARGET)
    tl, tc = TT.prefill(tcfg, tp, torch.from_numpy(toks), target_seq=TARGET)
    # mixtral: every layer windowed (smoke window 32), a rolling buffer
    want_cl = 32 if name == "mixtral-8x22b" else TARGET
    assert tc["k"].shape == (tcfg.num_layers, 2, want_cl,
                             tcfg.num_kv_heads, tcfg.head_dim)
    _close(tl.numpy(), jl)
    for key in ("k", "v"):
        _close(tc[key].numpy(), jc[key])


@pytest.mark.parametrize("vector", [False, True])
def test_decode_step_matches(setup, vector):
    _, jcfg, tcfg, jp, tp, _, toks = setup
    _, jc = _jprefill(jcfg, jp, jnp.asarray(toks), target_seq=TARGET)
    _, tc = TT.prefill(tcfg, tp, torch.from_numpy(toks), target_seq=TARGET)
    tok = np.array([[3], [7]], np.int32)
    pos = np.array([SEQ, SEQ - 25], np.int32) if vector else SEQ
    for step in range(3):
        p = pos + step
        jl, jc = _jdecode(jcfg, jp, jc, jnp.asarray(tok),
                                jnp.asarray(p, jnp.int32))
        tl, tc = TT.decode_step(tcfg, tp, tc, torch.from_numpy(tok),
                                torch.as_tensor(p))
        _close(tl.numpy(), jl)
        for key in ("k", "v"):
            _close(tc[key].numpy(), jc[key])
        tok = (tok * 5 + step) % tcfg.vocab_size


def test_decode_matches_full_forward(setup):
    """The reference's check (tests/test_models.py) in the port, at
    capacity factor 8.0, through a wrapped rolling cache for mixtral: 40
    prompt tokens and 4 decode steps against a full forward over the same
    tokens, within 2e-4; and each step's logits equal the reference's."""
    _, jcfg, tcfg, jp, tp, _, toks = setup
    jcfg, tcfg = _with_cf(jcfg, 8.0), _with_cf(tcfg, 8.0)
    S, steps = 40, 4
    tokens = torch.from_numpy(toks[:, :S + steps])
    logits, cache = tapi.prefill(tcfg, tp, {"tokens": tokens[:, :S]},
                                 target_seq=S + steps)
    _, jc = _jprefill(jcfg, jp, jnp.asarray(toks[:, :S]),
                      target_seq=S + steps)
    for i in range(steps):
        step = toks[:, S + i:S + i + 1]
        logits, cache = tapi.decode(tcfg, tp, cache, torch.from_numpy(step),
                                    S + i)
        jl, jc = _jdecode(jcfg, jp, jc, jnp.asarray(step), jnp.int32(S + i))
        _close(logits.numpy(), jl)
        full, _ = tapi.prefill(tcfg, tp, {"tokens": tokens[:, :S + i + 1]},
                               target_seq=S + steps)
        err = float((logits - full).abs().max())
        assert err < STEPWISE_TOL, f"step {i}: decode/full mismatch {err}"


def test_convert_round_trip_is_bitwise(setup):
    _, _, _, _, tp, np_params, _ = setup
    assert set(np_params["layers"]["moe"]) >= {"router", "w_gate", "w_up",
                                               "w_down"}
    back = convert.lm_params_to_numpy(tp)
    flat_a = jax.tree_util.tree_leaves_with_path(np_params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_port_init_matches_reference_layout(setup):
    """Same tree, shapes and dtypes as the reference's init (experts
    ``(L, E, d, f)``, arctic's ``dense``), the same distributions, and the
    config's analytic count plus the norm weights."""
    _, _, tcfg, _, _, np_params, _ = setup
    tp = tapi.init(tcfg, seed=0, device="cpu")
    mine = jax.tree_util.tree_leaves_with_path(
        convert.lm_params_to_numpy(tp))
    ref = jax.tree_util.tree_leaves_with_path(np_params)
    assert [(p, a.shape, a.dtype) for p, a in mine] == \
        [(p, a.shape, a.dtype) for p, a in ref]
    moe = tp["layers"]["moe"]
    E, d, f = tcfg.moe.num_experts, tcfg.d_model, tcfg.d_ff
    assert moe["w_gate"].shape == (tcfg.num_layers, E, d, f)
    assert abs(float(moe["w_up"].std()) * np.sqrt(d) - 1.0) < 0.05
    assert abs(float(moe["w_down"].std()) * np.sqrt(f) - 1.0) < 0.05
    norms = tcfg.num_layers * 2 * d + d
    assert sum(a.size for _, a in mine) == tcfg.param_count() + norms
