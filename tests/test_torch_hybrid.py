"""The port's hybrid family (recurrentgemma-9b: RG-LRU blocks and local
attention, R, R, L) against the JAX reference.

Params and caches come from the reference's ``api.init`` / ``prefill`` and
are carried across by ``convert``; inputs are numpy from a seed.  The
reference's functions are jitted, as tests/test_torch_moe.py does.  The
smoke config has 3 layers (one group, no remainder) and window 32; a
5-layer variant adds the two remainder layers the full config has.

Tolerances, each with what was observed on the CPU:

* The RG-LRU scan.  ``associative_scan`` is ``lax.associative_scan``'s
  recursion: from the same (a, b) it equals the reference's scan run
  eagerly bit for bit.  Jitted, XLA fuses ``a2 * b1 + b2`` into one FMA,
  which moves the prefixes by at most 9.6e-7 (S = 1000 and 4096).
  ``rglru_scan`` against the jitted reference adds the coefficients'
  transcendental functions (exp, sigmoid, softplus: XLA's and PyTorch's
  differ by an ulp): 1.3e-7 at S = 1, 1.2e-6 at S = 100, 2.0e-6 at
  S = 1000; held to 1e-5 absolute and relative.
* ``rglru_step``: given the reference's coefficients, the update
  ``a * h + b`` is the reference's bit for bit (eager); the whole step
  within 1e-6 (1.2e-7 observed).
* Blocks, hidden states, logits and every cache leaf: 2e-5 absolute, rtol
  1e-5, as tests/test_torch_transformer.py (5.3e-6 observed on the
  hidden states).
* Decode against the full forward: the reference's own 2e-4.
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
from repro.models import hybrid as JH
from repro.serving.engine import reference_decode as j_reference_decode
from repro_torch import convert
from repro_torch.configs import recurrentgemma_9b
from repro_torch.kernels import LAUNCHES
from repro_torch.models import api as tapi
from repro_torch.models import hybrid as TH
from repro_torch.serving import ServeEngine, reference_decode
from repro_torch.tree import tree_map

ATOL, RTOL = 2e-5, 1e-5
SCAN_TOL = 1e-5
STEP_TOL = 1e-6
STEPWISE_TOL = 2e-4
WINDOW = 32                 # the smoke config's

_jforward = jax.jit(JH.forward, static_argnums=0)
_jprefill = jax.jit(JH.prefill, static_argnums=0,
                    static_argnames="target_seq")
_jdecode = jax.jit(JH.decode_step, static_argnums=0)
_jblock = jax.jit(JH.apply_block, static_argnums=(0, 1),
                  static_argnames="make_cache_len")
_jscan = jax.jit(JH.rglru_scan)


def _configs(layers=3):
    return (dataclasses.replace(R.get_smoke_config("recurrentgemma-9b"),
                                num_layers=layers),
            dataclasses.replace(recurrentgemma_9b.smoke_config(),
                                num_layers=layers))


def _setup(layers):
    jcfg, tcfg = _configs(layers)
    jp = jax.jit(japi.init, static_argnums=(0, 2))(
        jcfg, jax.random.PRNGKey(0), jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    tp = convert.lm_params_from_numpy(np_params, device="cpu")
    return jcfg, tcfg, jp, tp, np_params


@pytest.fixture(scope="module")
def model():
    return _setup(3)


@pytest.fixture(scope="module")
def model5():
    return _setup(5)


def _tokens(S, seed=1, B=2):
    return np.random.RandomState(seed).randint(0, 256, (B, S)).astype(
        np.int32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


def _close_tree(got, want):
    a = jax.tree_util.tree_leaves_with_path(convert.lm_params_to_numpy(got))
    b = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, want))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (_, x), (_, y) in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype
        _close(x, y)


def _slot(tree, s, g=0):
    """Group ``g`` of slot ``s`` of a stacked (params or cache) tree."""
    return jax.tree_util.tree_map(lambda a: a[g], tree[s])


def _rglru(model):
    _, _, jp, tp, _ = model
    jr = _slot(jp["layers"]["slots"], 0)["rglru"]
    return jr, tree_map(lambda t: t[0], tp["layers"]["slots"][0]["rglru"])


# =============================================================================
# the RG-LRU
# =============================================================================
def _combine(e1, e2):
    return e1[0] * e2[0], e2[0] * e1[1] + e2[1]


@pytest.mark.parametrize("S", [1, 2, 37, 100, 1000])
def test_associative_scan_is_the_reference_recursion(S):
    """From the same (a, b): bit for bit the reference's scan run eagerly
    (the same association order), within 1e-6 of it jitted (an FMA)."""
    rs = np.random.RandomState(S)
    a = rs.uniform(0.5, 1.0, (2, S, 8)).astype(np.float32)
    b = rs.randn(2, S, 8).astype(np.float32)
    with jax.disable_jit():
        _, eager = lax.associative_scan(_combine, (jnp.asarray(a),
                                                   jnp.asarray(b)), axis=1)
    _, fused = jax.jit(lambda a, b: lax.associative_scan(
        _combine, (a, b), axis=1))(a, b)
    _, got = TH.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(eager).view(np.uint32))
    _close(got.numpy(), fused, atol=1e-6, rtol=0)


@pytest.mark.parametrize("S", [1, 2, 37, 100, 1000])
def test_rglru_scan_matches_reference(model, S):
    jr, tr = _rglru(model)
    u = np.random.RandomState(S).randn(2, S, 64).astype(np.float32)
    got = TH.rglru_scan(tr, torch.from_numpy(u))
    assert got.shape == u.shape and got.dtype == torch.float32
    _close(got.numpy(), _jscan(jr, jnp.asarray(u)), SCAN_TOL, SCAN_TOL)


def test_rglru_step_matches_reference(model, monkeypatch):
    jr, tr = _rglru(model)
    rs = np.random.RandomState(2)
    u = rs.randn(2, 1, 64).astype(np.float32)
    h = rs.randn(2, 64).astype(np.float32)
    want_out, want_h = jax.jit(JH.rglru_step)(jr, jnp.asarray(u),
                                              jnp.asarray(h))
    out, new_h = TH.rglru_step(tr, torch.from_numpy(u), torch.from_numpy(h))
    assert out.shape == (2, 1, 64) and new_h.shape == (2, 64)
    _close(new_h.numpy(), want_h, STEP_TOL, 0)
    _close(out.numpy(), want_out, STEP_TOL, 0)
    # the update itself, from the reference's coefficients: exact
    a, b = JH._rglru_coeffs(jr, jnp.asarray(u[:, 0]))
    monkeypatch.setattr(TH, "_rglru_coeffs", lambda p, x: (
        torch.from_numpy(np.array(a)), torch.from_numpy(np.array(b))))
    with jax.disable_jit():
        _, want_h = JH.rglru_step(jr, jnp.asarray(u), jnp.asarray(h))
    _, new_h = TH.rglru_step(tr, torch.from_numpy(u), torch.from_numpy(h))
    np.testing.assert_array_equal(new_h.numpy().view(np.uint32),
                                  np.asarray(want_h).view(np.uint32))


def test_recurrent_mix_matches_reference(model):
    jcfg, tcfg, _, _, _ = model
    jr, tr = _rglru(model)
    rs = np.random.RandomState(3)
    x = rs.randn(2, 20, 64).astype(np.float32)
    want, _ = jax.jit(JH.recurrent_mix, static_argnums=0)(
        jcfg, jr, jnp.asarray(x))
    got, made = TH.recurrent_mix(tcfg, tr, torch.from_numpy(x))
    _close(got.numpy(), want)
    assert made["conv"].shape == (2, 3, 64) and made["state"].shape == (2, 64)
    cache = {"conv": rs.randn(2, 3, 64).astype(np.float32),
             "state": rs.randn(2, 64).astype(np.float32)}
    x1 = x[:, :1]
    want, want_c = jax.jit(JH.recurrent_mix, static_argnums=0)(
        jcfg, jr, jnp.asarray(x1), jax.tree_util.tree_map(jnp.asarray, cache))
    got, got_c = TH.recurrent_mix(tcfg, tr, torch.from_numpy(x1),
                                  convert.lm_params_from_numpy(cache, "cpu"))
    _close(got.numpy(), want)
    _close_tree(got_c, want_c)


@pytest.mark.parametrize("kind,slot", [("R", 0), ("L", 2)])
def test_apply_block_matches_reference(model, kind, slot):
    """One block over a sequence, and one decode step through its cache
    (the L block's rolling buffer wrapped: position 40 of a 32-slot
    cache)."""
    jcfg, tcfg, jp, tp, _ = model
    jb = _slot(jp["layers"]["slots"], slot)
    tb = tree_map(lambda t: t[0], tp["layers"]["slots"][slot])
    rs = np.random.RandomState(4)
    x = rs.randn(2, 20, 64).astype(np.float32)
    pos = np.arange(20, dtype=np.int32)
    want, _ = _jblock(jcfg, kind, jb, jnp.asarray(x), jnp.asarray(pos))
    got, _ = TH.apply_block(tcfg, kind, tb, torch.from_numpy(x),
                            torch.from_numpy(pos))
    _close(got.numpy(), want)
    jc = japi.init_cache(jcfg, 2, 100, jnp.float32)["slots"][slot]
    jc = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rs.randn(*a.shape[1:]).astype(np.float32)), jc)
    tc = convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jc), "cpu")
    x1, p1 = x[:, :1], np.int32(40)
    want, want_c = _jblock(jcfg, kind, jb, jnp.asarray(x1),
                           jnp.asarray(p1)[None], jc, jnp.asarray(p1))
    got, got_c = TH.apply_block(tcfg, kind, tb, torch.from_numpy(x1),
                                torch.tensor([40]), tc, 40)
    _close(got.numpy(), want)
    _close_tree(got_c, want_c)
    _close_tree(tc, want_c)                 # updated in place


# =============================================================================
# the model
# =============================================================================
def test_port_init_matches_reference_layout(model):
    """Same tree (lists of slots, the remainder list), shapes and dtypes
    as the reference's init, the same deterministic leaves and the same
    distributions (other random bits)."""
    _, tcfg, _, _, np_params = model
    mine = convert.lm_params_to_numpy(tapi.init(tcfg, seed=0, device="cpu"))
    flat_m = jax.tree_util.tree_leaves_with_path(mine)
    flat_r = jax.tree_util.tree_leaves_with_path(np_params)
    assert [(p, a.shape, a.dtype) for p, a in flat_m] == \
        [(p, a.shape, a.dtype) for p, a in flat_r]
    assert isinstance(mine["layers"]["slots"], list)
    assert isinstance(mine["rem"], list)
    r = mine["layers"]["slots"][0]["rglru"]
    a = np.exp(-8.0 * np.log1p(np.exp(r["lam"])))   # a at r = 1
    assert a.min() > 0.9 - 1e-6 and a.max() < 0.999 + 1e-6
    assert not r["conv_b"].any() and not mine["final_norm"].any()
    assert abs(r["conv_w"].std() / 0.1 - 1.0) < 0.15
    assert abs(r["w_r"].std() * np.sqrt(64) - 1.0) < 0.05
    assert abs(mine["embed"].std() / 0.02 - 1.0) < 0.05


def test_init_with_remainder_layers_matches_layout(model5):
    _, tcfg, _, _, np_params = model5
    mine = convert.lm_params_to_numpy(tapi.init(tcfg, seed=1, device="cpu"))
    flat_m = jax.tree_util.tree_leaves_with_path(mine)
    flat_r = jax.tree_util.tree_leaves_with_path(np_params)
    assert [(p, a.shape) for p, a in flat_m] == \
        [(p, a.shape) for p, a in flat_r]
    assert [sorted(d) for d in mine["rem"]] == [
        ["ffn", "ln1", "ln2", "rglru"]] * 2


def test_convert_round_trip_is_bitwise(model):
    jcfg, _, jp, _, np_params = model
    _, jcache = _jprefill(jcfg, jp, jnp.asarray(_tokens(40)), target_seq=50)
    jcache = jax.tree_util.tree_map(np.asarray, jcache)
    for tree in (np_params, jcache):
        port = convert.lm_params_from_numpy(tree, device="cpu")
        back = convert.lm_params_to_numpy(port)
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(tree)
        for a, b in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(back)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32))
    port = convert.lm_params_from_numpy(jcache, device="cpu")
    assert isinstance(port["slots"], tuple) and isinstance(port["rem"], list)


@pytest.mark.parametrize("S", [10, 70])
def test_forward_hidden_matches(model, S):
    jcfg, tcfg, jp, tp, _ = model
    toks = _tokens(S)
    want, _ = _jforward(jcfg, jp, jnp.asarray(toks))
    got, cache = TH.forward(tcfg, tp, torch.from_numpy(toks))
    assert cache is None
    _close(got.numpy(), want)


@pytest.mark.parametrize("layers,S,target", [
    (3, 10, 20),      # below the window: CL = 20
    (3, 40, 50),      # above it: CL = 32, the rolling placement wraps
    (3, 70, None),    # wraps twice over; target_seq defaults to S
    (5, 45, 60),      # the remainder layers
])
def test_prefill_matches(model, model5, layers, S, target):
    """Logits and every cache leaf (tuple of slots, remainder list)."""
    jcfg, tcfg, jp, tp, _ = model if layers == 3 else model5
    toks = _tokens(S)
    jl, jc = _jprefill(jcfg, jp, jnp.asarray(toks), target_seq=target)
    tl, tc = tapi.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                          target_seq=target)
    assert tl.dtype == torch.float32 and tl.shape == (2, tcfg.vocab_size)
    _close(tl.numpy(), jl)
    _close_tree(tc, jc)
    assert tc["slots"][2]["k"].shape[2] == min(target or S, WINDOW)


@pytest.mark.parametrize("layers,S", [(3, 20), (3, 40), (5, 30)])
def test_decode_steps_match(model, model5, layers, S):
    """Scalar positions; the cache passes the window (S + 3 > 32) where
    S = 30 or 40."""
    jcfg, tcfg, jp, tp, _ = model if layers == 3 else model5
    toks = _tokens(S)
    _, jc = _jprefill(jcfg, jp, jnp.asarray(toks), target_seq=S + 8)
    _, tc = tapi.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                         target_seq=S + 8)
    tok = np.array([[3], [7]], np.int32)
    for step in range(4):
        jl, jc = _jdecode(jcfg, jp, jc, jnp.asarray(tok), jnp.int32(S + step))
        tl, tc = tapi.decode(tcfg, tp, tc, torch.from_numpy(tok), S + step)
        _close(tl.numpy(), jl)
        _close_tree(tc, jc)
        tok = (tok * 5 + step) % tcfg.vocab_size


def _stack_rows(caches):
    """One cache of the rows of ``caches`` (each prefilled alone): slot
    leaves are (groups, B, ...), remainder leaves (B, ...)."""
    first = caches[0]
    return {"slots": tuple({k: torch.cat([c["slots"][s][k] for c in caches],
                                         dim=1) for k in slot}
                           for s, slot in enumerate(first["slots"])),
            "rem": [{k: torch.cat([c["rem"][i][k] for c in caches], dim=0)
                     for k in layer} for i, layer in enumerate(first["rem"])]}


@pytest.mark.parametrize("layers", [3, 5])
def test_decode_with_per_row_positions(model, model5, layers):
    """A (B,) vector of positions: each row at its own position, as the
    dense transformer's decode takes it.  The reference's hybrid
    ``decode_step`` reads a (B,) vector as a sequence of B positions and
    fails for B > 1 (ROADMAP queue 3), so each row is held against the
    reference decoding that row alone at its scalar position; row 1 passes
    the window (35 + 3 > 32)."""
    jcfg, tcfg, jp, tp, _ = model if layers == 3 else model5
    lens = (20, 35)
    target = max(lens) + 4
    prompts = [_tokens(L, seed=10 + L, B=1) for L in lens]
    tc = _stack_rows([tapi.prefill(tcfg, tp, {"tokens": torch.from_numpy(t)},
                                   target_seq=target)[1] for t in prompts])
    jcs = [_jprefill(jcfg, jp, jnp.asarray(t), target_seq=target)[1]
           for t in prompts]
    tok = np.array([[3], [7]], np.int32)
    pos = np.array(lens, np.int64)
    for step in range(3):
        tl, tc = tapi.decode(tcfg, tp, tc, torch.from_numpy(tok),
                             torch.from_numpy(pos + step))
        for r in range(2):
            jl, jcs[r] = _jdecode(jcfg, jp, jcs[r], jnp.asarray(tok[r:r + 1]),
                                  jnp.int32(pos[r] + step))
            _close(tl[r:r + 1].numpy(), jl)
        tok = (tok * 5 + step) % tcfg.vocab_size


@pytest.mark.parametrize("S,gen", [(10, 8), (28, 12)])
def test_decode_matches_full_forward(model, S, gen):
    """Prefill, then decode fed the next tokens: each step's logits equal
    a prefill over the whole sequence so far within 2e-4 (the reference's
    bound); 28 + 12 passes the 32-slot window, so decode runs through the
    wrapped rolling cache."""
    _, tcfg, _, tp, _ = model
    seq = torch.from_numpy(_tokens(S + gen, seed=7))
    logits, cache = TH.prefill(tcfg, tp, seq[:, :S], target_seq=S + gen)
    for i in range(S, S + gen):
        logits, cache = TH.decode_step(tcfg, tp, cache, seq[:, i:i + 1], i)
        full, _ = TH.prefill(tcfg, tp, seq[:, :i + 1])
        assert float((logits - full).abs().max()) < STEPWISE_TOL


def test_prefill_equals_token_by_token_decode(model):
    """The prefill's logits and caches against feeding the prompt through
    ``decode_step`` one token at a time from ``init_cache`` zeros: the
    log-depth scan's state against ``rglru_step``, the conv window against
    the rolled one, the rolling KV placement against decode's writes."""
    _, tcfg, _, tp, _ = model
    toks = torch.from_numpy(_tokens(45, seed=4))
    logits, cache = TH.prefill(tcfg, tp, toks)
    step_cache = TH.init_cache(tcfg, 2, 45, torch.float32, "cpu")
    for i in range(toks.shape[1]):
        step_logits, step_cache = TH.decode_step(tcfg, tp, step_cache,
                                                 toks[:, i:i + 1], i)
    assert float((step_logits - logits).abs().max()) < STEPWISE_TOL
    for a, b in zip(jax.tree_util.tree_leaves(
            convert.lm_params_to_numpy(step_cache)),
            jax.tree_util.tree_leaves(convert.lm_params_to_numpy(cache))):
        assert float(np.abs(a - b).max()) < STEPWISE_TOL


@pytest.mark.parametrize("L", [3, 16, 40])
def test_reference_decode_tokens_match(model, L):
    jcfg, tcfg, jp, tp, _ = model
    prompt = _tokens(L, seed=L, B=1)[0]
    before = dict(LAUNCHES)
    assert reference_decode(tcfg, tp, prompt, 6) == \
        j_reference_decode(jcfg, jp, prompt, 6)
    assert LAUNCHES == before                 # CPU: the plain versions


def test_short_prompt_names_the_minimum(model):
    _, tcfg, _, tp, _ = model
    with pytest.raises(ValueError, match="conv_width - 1 = 3"):
        TH.prefill(tcfg, tp, torch.zeros((1, 2), dtype=torch.long))
    logits, _ = TH.prefill(tcfg, tp, torch.zeros((1, 3), dtype=torch.long))
    assert torch.isfinite(logits).all()
    hidden, _ = TH.forward(tcfg, tp, torch.zeros((1, 2), dtype=torch.long))
    assert hidden.shape == (1, 2, tcfg.d_model)


def test_family_dispatch_and_refusals(model):
    """``api`` dispatches recurrentgemma to ``hybrid``, whose training loss
    (``tests/test_torch_lm_loss.py`` holds it against the reference) is
    ``api.loss``; the engine refuses the family, as the reference's."""
    _, tcfg, _, tp, _ = model
    assert tapi.get_model(tcfg) is TH
    toks = torch.from_numpy(_tokens(8))
    batch = {"tokens": toks, "labels": toks}
    with torch.no_grad():
        assert torch.equal(tapi.loss(tcfg, tp, batch),
                           TH.loss_fn(tcfg, tp, batch))
    with pytest.raises(NotImplementedError, match="families"):
        ServeEngine(tcfg, tp)


def test_init_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: init(device=None) would use it")
    cfg = recurrentgemma_9b.smoke_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.init_cache(cfg, 1, 8, torch.float32)


def test_full_width_param_count():
    """recurrentgemma-9b's params, counted from the reference init's shapes
    (no arrays made): 9,396,195,328 (35.0 GiB in fp32), which is
    ``param_count()`` plus the norms less one lru width per R layer
    (``param_count`` charges an R layer ``w * (conv_width + 3)`` for its
    conv weight and bias and Λ, which hold ``w * (conv_width + 2)``):
    the count chip_smoke checks the port's init against."""
    cfg = recurrentgemma_9b.CONFIG
    shapes = jax.eval_shape(
        lambda k: JH.init(R.get_config("recurrentgemma-9b"), k, jnp.float32),
        jax.random.PRNGKey(0))
    n = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert n == 9_396_195_328
    r_layers = sum(cfg.layer_kind(i) == "R" for i in range(cfg.num_layers))
    assert r_layers == 26
    norms = (2 * cfg.num_layers + 1) * cfg.d_model
    assert cfg.param_count() + norms - r_layers * cfg.rglru.lru_width == n
