"""The port's mamba2 (SSM) family and its SSD scan against the JAX reference.

Inputs are made with numpy from a seed and fed to both packages; model
params come from the reference's ``api.init`` and are carried across by
``convert``.  On the CPU the port's ``ssd_scan`` takes its plain version,
held against the reference's Pallas kernel (interpret mode), its chunked
oracle ``ref.ssd_ref`` (y and final state), the sequential recurrence and
``ssd_chunked(init_state=...)``, over the reference's own sweep
``SSD_CASES`` (tests/test_kernels.py), at that sweep's tolerance: 5e-4
absolute and relative (fp32 sums and the in-chunk cumsum run in another
order).  The model (smoke config: 2 layers, d_model 64, chunk 16) is held
at 2e-5 absolute (rtol 1e-5), as tests/test_torch_transformer.py; the
port's prefill against its own token-by-token decode at 2e-4, the
reference's bound (tests/test_models.py).  The ``cuda`` cases run the
hand-written kernel against the plain version and skip where no card is
visible.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import SSD_CASES

from repro.configs import registry as R
from repro.kernels.ssd_scan.ops import ssd_scan as j_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_ref, ssd_sequential
from repro.models import api as japi
from repro.models import ssm as JS
from repro.serving.engine import reference_decode as j_reference_decode
from repro_torch import convert
from repro_torch.configs import mamba2_780m
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import ssd_scan as ts
from repro_torch.models import api as tapi
from repro_torch.models import ssm as TS
from repro_torch.serving import ServeEngine, reference_decode

SSD_TOL = 5e-4
ATOL, RTOL = 2e-5, 1e-5


def _ssd_inputs(B, S, H, P, N, seed, init=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(B, S, H))).astype(np.float32)
    A = (-np.exp(rng.randn(H) * 0.5)).astype(np.float32)
    Bm = rng.randn(B, S, N).astype(np.float32)
    Cm = rng.randn(B, S, N).astype(np.float32)
    s0 = rng.randn(B, H, P, N).astype(np.float32) if init else None
    return x, dt, A, Bm, Cm, s0


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


# =============================================================================
# the SSD scan
# =============================================================================
@pytest.mark.parametrize("B,S,H,P,N,chunk,dtype", SSD_CASES)
def test_ssd_scan_matches_reference(B, S, H, P, N, chunk, dtype):
    x, dt, A, Bm, Cm, _ = _ssd_inputs(B, S, H, P, N, seed=S + H + N)
    jargs = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    before = dict(LAUNCHES)
    y, state = ts.ssd_scan(*_t(x, dt, A, Bm, Cm), chunk)
    assert LAUNCHES == before                 # CPU: the plain version
    assert y.shape == x.shape and state.shape == (B, H, P, N)
    y_ref, s_ref = ssd_ref(*jargs, chunk)
    y_seq, s_seq = ssd_sequential(*jargs)
    y_pal = j_ssd_scan(*jargs, chunk=chunk)
    for want in (y_ref, y_seq, y_pal):
        _close(y.numpy(), want, SSD_TOL)
    for want in (s_ref, s_seq):
        _close(state.numpy(), want, SSD_TOL)
    y_tseq, s_tseq = ts.ssd_sequential(*_t(x, dt, A, Bm, Cm))
    _close(y_tseq.numpy(), y_seq, SSD_TOL)
    _close(s_tseq.numpy(), s_seq, SSD_TOL)


@pytest.mark.parametrize("B,S,H,P,N,chunk,dtype", SSD_CASES)
def test_ssd_scan_init_state_matches_ssd_chunked(B, S, H, P, N, chunk,
                                                 dtype):
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(B, S, H, P, N, seed=7 + S, init=True)
    want_y, want_s = JS.ssd_chunked(*(jnp.asarray(a) for a in
                                      (x, dt, A, Bm, Cm)), chunk,
                                    init_state=jnp.asarray(s0))
    y, state = ts.ssd_scan(*_t(x, dt, A, Bm, Cm), chunk,
                           init_state=torch.from_numpy(s0))
    _close(y.numpy(), want_y, SSD_TOL)
    _close(state.numpy(), want_s, SSD_TOL)


def test_ssd_scan_large_decay_stays_finite():
    """dt up to ~6 and A down to -16 take the in-chunk cumsum below -1000,
    so exp(cum_i - cum_j) above the diagonal overflows to inf: the masked
    form must stay finite and equal the reference's."""
    B, S, H, P, N, chunk = 1, 80, 3, 8, 16, 32
    x, dt, A, Bm, Cm, _ = _ssd_inputs(B, S, H, P, N, seed=5)
    dt = (dt * 3.0).astype(np.float32)
    A = -np.asarray([1.0, 4.0, 16.0], np.float32)
    cum = np.cumsum(dt[0, :chunk] * A, axis=0)
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(cum[:, None, :] - cum[None, :, :])).any()
    y, state = ts.ssd_scan(*_t(x, dt, A, Bm, Cm), chunk)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    want_y, want_s = JS.ssd_chunked(*(jnp.asarray(a) for a in
                                      (x, dt, A, Bm, Cm)), chunk)
    _close(y.numpy(), want_y, SSD_TOL)
    _close(state.numpy(), want_s, SSD_TOL)


@pytest.mark.parametrize("change,match", [
    ("dtype", "float32"), ("dt", "needs"), ("A", "needs"),
    ("init", "needs")])
def test_ssd_scan_rejects_bad_inputs(change, match):
    x, dt, A, Bm, Cm, s0 = _t(*_ssd_inputs(1, 16, 2, 4, 8, seed=1,
                                           init=True))
    if change == "dtype":
        x = x.double()
    elif change == "dt":
        dt = dt[:, :8]
    elif change == "A":
        A = A[:1]
    else:
        s0 = s0.transpose(2, 3)
    with pytest.raises(ValueError, match=match):
        ts.ssd_scan(x, dt, A, Bm, Cm, 8, init_state=s0)


# =============================================================================
# the model
# =============================================================================
@pytest.fixture(scope="module")
def model():
    jcfg = R.get_smoke_config("mamba2-780m")
    tcfg = mamba2_780m.smoke_config()
    jp = japi.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    tp = convert.lm_params_from_numpy(np_params, device="cpu")
    return jcfg, tcfg, jp, tp, np_params


def _tokens(S, seed=1, B=2):
    return np.random.RandomState(seed).randint(0, 256, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("S", [37, 48])
def test_forward_and_prefill_match(model, S):
    """S=37 is ragged against the smoke chunk of 16, S=48 is not."""
    jcfg, tcfg, jp, tp, _ = model
    toks = _tokens(S)
    jh, _ = JS.forward(jcfg, jp, jnp.asarray(toks))
    th, cache = TS.forward(tcfg, tp, torch.from_numpy(toks))
    assert cache is None
    _close(th.numpy(), jh, ATOL)
    jl, jc = japi.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tapi.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tl.shape == (2, tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    for key in ("conv", "state"):
        assert tc[key].shape == jc[key].shape
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("S", [37, 48])
def test_decode_steps_match(model, S):
    jcfg, tcfg, jp, tp, _ = model
    toks = _tokens(S)
    _, jc = japi.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    _, tc = tapi.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    tok = np.array([[3], [7]], np.int32)
    for step in range(3):
        jl, jc = japi.decode(jcfg, jp, jc, jnp.asarray(tok),
                             jnp.int32(S + step))
        tl, tc = tapi.decode(tcfg, tp, tc, torch.from_numpy(tok), S + step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=RTOL)
        for key in ("conv", "state"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       atol=ATOL, rtol=RTOL)
        tok = (tok * 5 + step) % tcfg.vocab_size


@pytest.mark.parametrize("L", [3, 16, 37])
def test_reference_decode_tokens_match(model, L):
    jcfg, tcfg, jp, tp, _ = model
    prompt = _tokens(L, seed=L, B=1)[0]
    assert reference_decode(tcfg, tp, prompt, 6) == \
        j_reference_decode(jcfg, jp, prompt, 6)


def test_prefill_equals_token_by_token_decode(model):
    """The prefill's logits and caches against feeding the prompt through
    ``decode_step`` one token at a time from ``init_cache`` zeros (the
    scan's final state against the recurrence, the conv cache against the
    rolled window)."""
    _, tcfg, _, tp, _ = model
    toks = torch.from_numpy(_tokens(37, seed=4))
    logits, cache = TS.prefill(tcfg, tp, toks)
    step_cache = TS.init_cache(tcfg, 2, 37, torch.float32, "cpu")
    for i in range(toks.shape[1]):
        step_logits, step_cache = TS.decode_step(tcfg, tp, step_cache,
                                                 toks[:, i:i + 1], i)
    for got, want in ((step_logits, logits),
                      (step_cache["conv"], cache["conv"]),
                      (step_cache["state"], cache["state"])):
        assert float((got - want).abs().max()) < 2e-4


def test_short_prompt_names_the_minimum(model):
    _, tcfg, _, tp, _ = model
    with pytest.raises(ValueError, match="conv_width - 1 = 3"):
        TS.prefill(tcfg, tp, torch.zeros((1, 2), dtype=torch.long))
    logits, _ = TS.prefill(tcfg, tp, torch.zeros((1, 3), dtype=torch.long))
    assert torch.isfinite(logits).all()


def test_convert_round_trip_is_bitwise(model):
    jcfg, _, jp, tp, np_params = model
    _, jcache = japi.prefill(jcfg, jp, {"tokens": jnp.asarray(_tokens(20))})
    for tree in (np_params, jax.tree_util.tree_map(np.asarray, jcache)):
        back = convert.lm_params_to_numpy(
            convert.lm_params_from_numpy(tree, device="cpu"))
        flat_a = jax.tree_util.tree_leaves_with_path(tree)
        flat_b = jax.tree_util.tree_leaves_with_path(back)
        assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
        for (_, a), (_, b) in zip(flat_a, flat_b):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32))
    assert convert.lm_params_to_numpy(tp).keys() == np_params.keys()


def test_port_init_matches_reference_layout(model):
    """Same tree, shapes and dtypes as the reference's init, the same
    deterministic leaves (A_log, D, zero norms and conv bias) and the same
    distributions (other random bits)."""
    _, tcfg, _, _, np_params = model
    tp = tapi.init(tcfg, seed=0, device="cpu")
    mine = convert.lm_params_to_numpy(tp)
    flat_m = jax.tree_util.tree_leaves_with_path(mine)
    flat_r = jax.tree_util.tree_leaves_with_path(np_params)
    assert [(p, a.shape, a.dtype) for p, a in flat_m] == \
        [(p, a.shape, a.dtype) for p, a in flat_r]
    lm, lr = mine["layers"], np_params["layers"]
    np.testing.assert_allclose(lm["A_log"], lr["A_log"], atol=1e-6)
    np.testing.assert_array_equal(lm["D"], lr["D"])
    assert not lm["conv_b"].any() and not lm["gate_ln"].any()
    dt = np.log1p(np.exp(lm["dt_bias"]))        # softplus inverts dt_bias
    assert dt.min() >= 1e-3 * 0.999 and dt.max() <= 1e-1 * 1.001
    assert abs(lm["conv_w"].std() / 0.1 - 1.0) < 0.1
    assert abs(lm["in_proj"].std() * np.sqrt(tcfg.d_model) - 1.0) < 0.05


@pytest.mark.parametrize("name", ["full", "smoke"])
def test_configs_equal_reference(name):
    if name == "full":
        ref, cfg = R.get_config("mamba2-780m"), mamba2_780m.CONFIG
    else:
        ref, cfg = (R.get_smoke_config("mamba2-780m"),
                    mamba2_780m.smoke_config())
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.param_count() == ref.param_count()
    assert TS.dims(cfg) == JS.dims(ref)


def test_full_width_param_count():
    """mamba2-780m's params, counted from the reference init's shapes (no
    arrays made): 857,379,072, which the port's ``dims`` reproduce."""
    cfg = mamba2_780m.CONFIG
    shapes = jax.eval_shape(
        lambda k: JS.init(R.get_config("mamba2-780m"), k, jnp.float32),
        jax.random.PRNGKey(0))
    n = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert n == 857_379_072
    d_inner, nheads, conv_dim, proj_dim, N = TS.dims(cfg)
    assert (d_inner, nheads, conv_dim, proj_dim, N) == (3072, 48, 3328, 6448,
                                                        128)
    d, W = cfg.d_model, cfg.ssm.conv_width
    per_layer = (d + d * proj_dim + (W + 1) * conv_dim + 3 * nheads
                 + d_inner + d_inner * d)
    assert cfg.num_layers * per_layer + 2 * cfg.vocab_size * d + d == n


def test_family_dispatch_and_refusals(model):
    _, tcfg, _, tp, _ = model
    assert tapi.get_model(tcfg) is TS
    with pytest.raises(NotImplementedError, match="LM training"):
        TS.loss_fn(tcfg, tp, None)
    with pytest.raises(NotImplementedError, match="families"):
        ServeEngine(tcfg, tp)


def test_init_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: init(device=None) would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.init(mamba2_780m.smoke_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.init_cache(mamba2_780m.smoke_config(), 1, 8, torch.float32)


# =============================================================================
# the kernel on the card
# =============================================================================
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N,chunk,init", [
    case[:6] + (False,) for case in SSD_CASES] + [
    (2, 96, 4, 16, 16, 32, True),       # entering state, ragged
    (1, 1000, 48, 64, 128, 128, False),  # mamba2-780m widths, ragged
    (1, 70, 3, 40, 12, 64, True),        # P not a multiple of 32, N of 4
])
def test_kernel_matches_plain_on_card(cuda_device, B, S, H, P, N, chunk,
                                      init):
    x, dt, A, Bm, Cm, s0 = (None if a is None else
                            torch.from_numpy(a).to(cuda_device)
                            for a in _ssd_inputs(B, S, H, P, N, seed=S + P,
                                                 init=init))
    before = LAUNCHES["ssd_scan"]
    y, state = ts.ssd_scan(x, dt, A, Bm, Cm, chunk, init_state=s0)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] == before + 1
    want_y, want_s = ts.ssd_scan_plain(x, dt, A, Bm, Cm, chunk, s0)
    torch.testing.assert_close(y, want_y, atol=SSD_TOL, rtol=SSD_TOL)
    torch.testing.assert_close(state, want_s, atol=SSD_TOL, rtol=SSD_TOL)
