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
# the kernel's four passes and 3xTF32 arithmetic, emulated on the CPU
# =============================================================================
def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: fp32 rounded to 10 mantissa bits, to nearest
    with ties away from zero (the low 13 bits cleared); copied from
    tests/test_torch_attention.py."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    return ((bits + 0x1000) & ~0x1FFF).to(torch.int32).view(torch.float32)


def _dot_parts(eq: str, a: torch.Tensor, b: torch.Tensor, tf32: int):
    """A product in the arithmetic ``tf32`` names, as (small, large) sums.
    3: the kernel's 3xTF32, hi = tf32(x), lo = tf32(x - hi), the small
    products lo.hi + hi.lo summed apart from hi.hi (its two accumulators);
    products of two TF32 values are exact in fp32, so only the sums round.
    1: one TF32 product hi.hi.  0: the fp32 product."""
    if not tf32:
        return 0.0, torch.einsum(eq, a, b)
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    if tf32 == 1:
        return 0.0, torch.einsum(eq, ah, bh)
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl),
            torch.einsum(eq, ah, bh))


def _dot(eq: str, a: torch.Tensor, b: torch.Tensor,
         tf32: int) -> torch.Tensor:
    small, large = _dot_parts(eq, a, b, tf32)
    return small + large


def _ssd_passes(x, dt, A, Bm, Cm, chunk, init_state=None, tf32=3):
    """The four passes of ``csrc/ssd_scan.cu`` in plain PyTorch: the chunk
    scores C.B^T once per (batch, chunk); per head the in-order cumsum of
    the rounded dt * A and the chunk states (w o x)^T.B with w_j =
    exp(cum_last - cum_j) dt_j; the state pass S <- exp(cum_last) S +
    states[c] from ``init_state``; the chunk scan, its decay evaluated only
    at j <= i, (e o C).S_enter^T and G.x summed into the same two
    accumulators, e_i = exp(cum_i).  Test code: no path of the package runs
    it."""
    F = torch.nn.functional
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    xc = F.pad(x, (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, Q, H, P)
    dtc = F.pad(dt, (0, 0, 0, pad)).reshape(Bsz, nc, Q, H)
    Bc = F.pad(Bm, (0, 0, 0, pad)).reshape(Bsz, nc, Q, N)
    Cc = F.pad(Cm, (0, 0, 0, pad)).reshape(Bsz, nc, Q, N)
    # 1. chunk scores
    scores = _dot("bcin,bcjn->bcij", Cc, Bc, tf32)
    # 2. cum in order, weights, chunk states
    dtA = dtc * A
    run, cums = torch.zeros_like(dtA[:, :, 0]), []
    for r in range(Q):
        run = run + dtA[:, :, r]
        cums.append(run)
    cum = torch.stack(cums, dim=2)                       # (B, nc, Q, H)
    w = torch.exp(cum[:, :, -1:] - cum) * dtc
    states = _dot("bcjhp,bcjn->bchpn", xc * w[..., None], Bc, tf32)
    # 3. the state pass
    s = init_state if init_state is not None else torch.zeros(Bsz, H, P, N)
    entering = []
    for c in range(nc):
        entering.append(s)
        s = torch.exp(cum[:, c, -1])[..., None, None] * s + states[:, c]
    # 4. the chunk scan
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()[None, None, :, :,
                                                        None]
    diff = torch.where(causal, cum[:, :, :, None] - cum[:, :, None], 0.0)
    G = torch.where(causal, scores[..., None] * torch.exp(diff)
                    * dtc[:, :, None], 0.0)
    Ce = torch.exp(cum)[..., None] * Cc[:, :, :, None]   # (B, nc, Q, H, N)
    small_e, large_e = _dot_parts("bcihn,bchpn->bcihp", Ce,
                                  torch.stack(entering, dim=1), tf32)
    small_i, large_i = _dot_parts("bcijh,bcjhp->bcihp", G, xc, tf32)
    y = (small_e + small_i) + (large_e + large_i)
    return y.reshape(Bsz, nc * Q, H, P)[:, :S], s


# mamba2-780m's widths with H cut to 4, ragged (300) and whole chunks
# (384); one case with a small dt (the real layers' range), where the
# entering state reaches far into the sequence; N=12, P=40 with a chunk of
# 40 (not a multiple of the 16-row tiles): B, S, H, P, N, chunk, init,
# dt scale
SSD_PASS_CASES = [
    (1, 300, 4, 64, 128, 128, False, 1.0),
    (1, 300, 4, 64, 128, 128, True, 1.0),
    (1, 384, 4, 64, 128, 128, False, 1.0),
    (1, 384, 4, 64, 128, 128, True, 1.0),
    (1, 384, 4, 64, 128, 128, True, 0.02),
    (2, 70, 3, 40, 12, 40, True, 1.0),
]
SSD_REL = 1e-5   # relative bound: max abs error <= SSD_REL * max |want|


@pytest.mark.parametrize("tf32", [0, 3], ids=["fp32", "3xtf32"])
@pytest.mark.parametrize("B,S,H,P,N,chunk,init,dt_scale", SSD_PASS_CASES)
def test_kernel_passes_match_reference(B, S, H, P, N, chunk, init,
                                       dt_scale, tf32):
    """The kernel's design, before any chip time: its four passes, in fp32
    and in the 3xTF32 split, against the reference's ``ssd_ref`` (no
    entering state) or ``ssd_chunked(init_state=...)``, at SSD_TOL and
    within SSD_REL of the largest reference value, on y and on the
    state."""
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(B, S, H, P, N, seed=S + N, init=init)
    dt = (dt * dt_scale).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    if init:
        want_y, want_s = JS.ssd_chunked(*jargs, chunk,
                                        init_state=jnp.asarray(s0))
    else:
        want_y, want_s = ssd_ref(*jargs, chunk)
    y, state = _ssd_passes(*_t(x, dt, A, Bm, Cm), chunk, *_t(s0), tf32=tf32)
    for got, want in ((y, want_y), (state, want_s)):
        want = np.asarray(want)
        _close(got.numpy(), want, SSD_TOL)
        err = np.abs(got.numpy() - want).max()
        assert err <= SSD_REL * np.abs(want).max(), (err,
                                                      np.abs(want).max())


def test_single_tf32_product_breaks_relative_bound():
    """The split is needed: the passes with one TF32 product (hi.hi) miss
    the relative bound by far on mamba2's widths."""
    x, dt, A, Bm, Cm, _ = _ssd_inputs(1, 300, 4, 64, 128, seed=3)
    args = _t(x, dt, A, Bm, Cm)
    want, _ = ts.ssd_scan_plain(*args, 128)
    y, _ = _ssd_passes(*args, 128, tf32=1)
    err = float((y - want).abs().max())
    assert err > 10 * SSD_REL * float(want.abs().max())


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
    (1, 4096, 8, 64, 128, 128, False),   # many chunks (32)
    (2, 1000, 4, 64, 128, 128, True),    # B > 1, ragged, entering state
    (2, 50, 4, 64, 128, 128, True),      # S < chunk: one chunk of 50
    (1, 300, 4, 64, 128, 40, True),      # Q = 40: not a multiple of 16
    (1, 200, 2, 130, 20, 64, False),     # P over two 64-column slices
    (1, 200, 3, 65, 16, 64, True),       # odd P over 64: odd row starts
    (2, 37, 3, 5, 3, 7, True),           # odd P and N, chunks of 7 rows
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


@pytest.mark.cuda
def test_kernel_takes_strided_views_on_card(cuda_device):
    """x, Bm and Cm as the model passes them: views of one projection with
    a row stride of their own, which the kernel reads in place."""
    B, S, H, P, N, chunk = 2, 300, 4, 64, 128, 128
    x, dt, A, Bm, Cm, s0 = (torch.from_numpy(a).to(cuda_device)
                            for a in _ssd_inputs(B, S, H, P, N, seed=11,
                                                 init=True))
    row = torch.cat([x.reshape(B, S, H * P), Bm, Cm,
                     torch.zeros(B, S, 4, device=cuda_device)], dim=-1)
    xv = row[..., :H * P].reshape(B, S, H, P)
    Bv, Cv = row[..., H * P:H * P + N], row[..., H * P + N:H * P + 2 * N]
    assert not xv.is_contiguous() and not Bv.is_contiguous()
    y, state = ts.ssd_scan(xv, dt, A, Bv, Cv, chunk, init_state=s0)
    torch.cuda.synchronize()
    want_y, want_s = ts.ssd_scan_plain(x, dt, A, Bm, Cm, chunk, s0)
    torch.testing.assert_close(y, want_y, atol=SSD_TOL, rtol=SSD_TOL)
    torch.testing.assert_close(state, want_s, atol=SSD_TOL, rtol=SSD_TOL)
