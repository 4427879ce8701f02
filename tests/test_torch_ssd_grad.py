"""The gradient of the port's SSD scan against the JAX reference.

The reference has no backward kernel: JAX differentiates its jnp
``ssd_chunked`` (``repro/models/ssm.py``).  The port's ``_SSDScan`` (the
forward, then ``ssd_scan_bwd``) and ``ssd_scan_bwd_plain``, the passes of
the CUDA backward (``csrc/ssd_scan.cu``) in torch ops, are held against
``jax.vjp`` of ``ssd_chunked`` over the reference's sweep ``SSD_CASES``
(tests/test_kernels.py), with and without an entering state and a
final-state cotangent, and a ragged chunk of 7 rows.  On the CPU the
Function runs the plain versions; chip_smoke and
tests/test_torch_ssd_grad_card.py hold the kernel against
``ssd_scan_bwd_plain`` on the card.

Tolerance: every gradient (dx, ddt, dA, dBm, dCm, dinit) within 1e-5 *
max(1, max|want|), the bound the chip holds the kernel to: fp32 sums in
other orders (observed below 3e-6, dA included: its sum over B S terms a
head cancels little at these sizes).

Past the overflow (in-chunk decay spans above ~88, mamba2-780m's A range
with dt up to 0.1 and chunks of 128) the reference's chunked gradient is
NaN: its ``where`` after ``exp`` gives inf * 0 above the diagonal
(ROADMAP queue 3).  There the port is held against ``jax.vjp`` of
``ref.ssd_sequential``, the recurrence itself, at the same bound.

The kernel's own arithmetic differs from the plain passes: every product
runs 3xTF32 on the tensor cores, each output tile summed over at most 256
terms (the heads' part of dB and dC as partials of head groups, added in
order), and it takes cum in order: ``_ssd_bwd_passes`` emulates that and
is held to the same bound at mamba2-780m's widths (H cut to 4 and 5),
and one TF32 product in place of three breaks it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import SSD_CASES
from tf32_emulation import tf32_dot

from repro.configs import registry as R
from repro.kernels.ssd_scan.ref import ssd_sequential
from repro.models import ssm as JS
from repro_torch import convert
from repro_torch.configs import mamba2_780m
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import ssd_scan as ts
from repro_torch.models import ssm as TS

REL = 1e-5
# dA, one sum a head over B S rows of cancelling d cum terms: its fp32
# evaluation against float64 (test_plain_fp32_against_float64), and the
# card's kernel against the plain backward (test_torch_ssd_grad_card.py,
# chip_smoke's SSD_BWD_DA_REL)
DA_REL = 1e-4
NAMES = ("dx", "ddt", "dA", "dBm", "dCm", "dinit")
# B, S, H, P, N, chunk, init_state, dfinal: the reference's sweep with a
# zero entering state and y's cotangent alone, then with both, and chunks
# of 7 rows with a ragged last one
CASES = ([c[:6] + (False, False) for c in SSD_CASES]
         + [c[:6] + (True, True) for c in SSD_CASES]
         + [(2, 37, 3, 5, 3, 7, True, True)])


def _inputs(B, S, H, P, N, seed, dt_range=None, A=None):
    """x, dt, A, Bm, Cm, the entering state, dy and dfinal as numpy; dt a
    softplus of normals (the reference's test) or uniform in dt_range."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, H, P).astype(np.float32)
    if dt_range is None:
        dt = np.log1p(np.exp(rng.randn(B, S, H))).astype(np.float32)
    else:
        dt = rng.uniform(*dt_range, (B, S, H)).astype(np.float32)
    if A is None:
        A = -np.exp(rng.randn(H) * 0.5)
    Bm, Cm = (rng.randn(B, S, N).astype(np.float32) for _ in range(2))
    s0 = rng.randn(B, H, P, N).astype(np.float32)
    dy = rng.randn(B, S, H, P).astype(np.float32)
    dfinal = rng.randn(B, H, P, N).astype(np.float32)
    return x, dt, np.asarray(A, np.float32), Bm, Cm, s0, dy, dfinal


@functools.lru_cache(maxsize=None)
def _jitted_vjp(kind: str, chunk: int = 0):
    """``(args, cotangents) -> gradients`` of the reference's
    ``ssd_chunked`` ("chunked", "chunked_init": with an entering state) or
    ``ssd_sequential``, jitted once (and compiled once a shape)."""
    if kind == "sequential":
        fn = ssd_sequential
    elif kind == "chunked":
        def fn(*a):
            return JS.ssd_chunked(*a, chunk)
    else:
        def fn(x_, dt_, A_, B_, C_, s_):
            return JS.ssd_chunked(x_, dt_, A_, B_, C_, chunk, init_state=s_)

    def run(args, cts):
        return jax.vjp(fn, *args)[1](cts)
    return jax.jit(run)


def _vjp(kind, chunk, args, dy, dfinal):
    """The reference's gradients (``_jitted_vjp``) as numpy, under the
    cotangents dy and dfinal (zeros for None)."""
    args = tuple(jnp.asarray(a) for a in args)
    B, _, H, P = args[0].shape
    final = np.zeros((B, H, P, args[3].shape[-1]), np.float32) \
        if dfinal is None else dfinal
    grads = _jitted_vjp(kind, chunk)(args, (jnp.asarray(dy),
                                            jnp.asarray(final)))
    return [np.asarray(g) for g in grads]


@functools.lru_cache(maxsize=None)
def _reference(B, S, H, P, N, chunk, init, dfin):
    """A case's inputs and ``jax.vjp`` of ``ssd_chunked``: (x, dt, A, Bm,
    Cm, init or None, dy, dfinal or None) and (dx, ddt, dA, dBm, dCm[,
    dinit]).  Without an entering state the reference takes a zero one
    (``ssd_chunked``'s own default), so one compile serves a shape."""
    x, dt, A, Bm, Cm, s0, dy, dfinal = _inputs(B, S, H, P, N, seed=S + H + N)
    s0 = s0 if init else np.zeros_like(s0)
    dfinal = dfinal if dfin else None
    want = _vjp("chunked_init", chunk, (x, dt, A, Bm, Cm, s0), dy, dfinal)
    return ((x, dt, A, Bm, Cm, s0 if init else None, dy, dfinal),
            want if init else want[:5])


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _assert_rel(got, want, what):
    want = np.asarray(want)
    assert got is not None and tuple(got.shape) == want.shape, what
    got = got.detach().numpy()
    assert np.isfinite(got).all(), f"{what}: not finite"
    bound = REL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max abs err {err} beyond {bound}"


def _autograd(x, dt, A, Bm, Cm, s0, dy, dfinal, chunk):
    """The gradients of ``ts.ssd_scan`` (through ``_SSDScan``) under the
    cotangents, by ``torch.autograd.grad``."""
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, dt, A, Bm, Cm)]
    init = None if s0 is None else torch.from_numpy(s0).requires_grad_()
    y, final = ts.ssd_scan(*leaves, chunk, init_state=init)
    assert y.grad_fn is not None
    outs, cts = [y], [torch.from_numpy(dy)]
    if dfinal is not None:
        outs.append(final)
        cts.append(torch.from_numpy(dfinal))
    return torch.autograd.grad(outs, leaves + ([init] if init is not None
                                               else []), cts)


@pytest.mark.parametrize("B,S,H,P,N,chunk,init,dfin", CASES)
def test_ssd_gradient_matches_reference(B, S, H, P, N, chunk, init, dfin):
    """``ssd_scan_bwd_plain`` and autograd through ``_SSDScan`` against
    ``jax.vjp`` of the reference's ``ssd_chunked``, without a launch."""
    (x, dt, A, Bm, Cm, s0, dy, dfinal), want = _reference(
        B, S, H, P, N, chunk, init, dfin)
    before = dict(LAUNCHES)
    plain = ts.ssd_scan_bwd_plain(*map(_t, (x, dt, A, Bm, Cm)), chunk,
                                  _t(s0), _t(dy), _t(dfinal))
    assert (plain[5] is None) == (not init)
    wrapped = ts.ssd_scan_bwd(*map(_t, (x, dt, A, Bm, Cm)), chunk, _t(s0),
                              _t(dy), _t(dfinal))
    grads = _autograd(x, dt, A, Bm, Cm, s0, dy, dfinal, chunk)
    assert LAUNCHES == before                 # CPU: the plain versions
    for name, p, g, a, w in zip(NAMES, plain, grads, wrapped, want):
        _assert_rel(p, w, f"plain {name}")
        _assert_rel(g, w, f"autograd {name}")
        assert torch.equal(a, p), name        # the wrapper is the plain bwd


@pytest.fixture(scope="module")
def overflow():
    """mamba2-780m's A range (1 to 16) with dt up to 0.1 over chunks of
    128 rows, H cut to 4: the in-chunk decay span reaches ~1500, so
    exp(cum_i - cum_j) above the diagonal overflows to inf."""
    B, S, H, P, N, Q = 1, 256, 4, 16, 16, 128
    args = _inputs(B, S, H, P, N, seed=3, dt_range=(0.05, 0.1),
                   A=-np.linspace(1.0, 16.0, H))
    x, dt, A, Bm, Cm, _, dy, _ = args
    span = -np.cumsum(dt[0, :Q] * A, axis=0)[-1]
    assert span.max() > 88.7                  # exp(88.7) overflows fp32
    chunked = _vjp("chunked", Q, (x, dt, A, Bm, Cm), dy, None)
    sequential = _vjp("sequential", 0, (x, dt, A, Bm, Cm), dy, None)
    return args, Q, chunked, sequential


def test_reference_chunked_gradient_is_nan_past_the_overflow(overflow):
    """The queue-3 entry: jax.vjp of the reference's ssd_chunked is NaN in
    dt and A there, while its sequential recurrence's is finite."""
    _, _, chunked, sequential = overflow
    nan = [name for name, g in zip(NAMES, chunked) if np.isnan(g).any()]
    assert nan == ["ddt", "dA"]
    assert all(np.isfinite(g).all() for g in sequential)


def test_port_gradient_is_finite_past_the_overflow(overflow):
    """The port's plain backward and autograd through ``_SSDScan`` and
    through ``ssd_scan_plain`` (its decay masked before exp) stay finite
    and equal ``jax.vjp`` of ``ref.ssd_sequential``."""
    (x, dt, A, Bm, Cm, _, dy, _), Q, _, want = overflow
    plain = ts.ssd_scan_bwd_plain(*map(_t, (x, dt, A, Bm, Cm)), Q, None,
                                  _t(dy))
    grads = _autograd(x, dt, A, Bm, Cm, None, dy, None, Q)
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, dt, A, Bm, Cm)]
    y, _ = ts.ssd_scan_plain(*leaves, Q)
    through = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    for name, p, g, a, w in zip(NAMES, plain, grads, through, want):
        _assert_rel(p, w, f"plain {name}")
        _assert_rel(g, w, f"autograd {name}")
        _assert_rel(a, w, f"through ssd_scan_plain {name}")


@pytest.mark.parametrize("B,S,H,P,N,chunk", [c[:6] for c in SSD_CASES]
                         + [(1, 300, 4, 64, 128, 128)])
def test_plain_fp32_against_float64(B, S, H, P, N, chunk):
    """The basis of chip_smoke's bounds on the kernel against the plain
    backward: the plain passes themselves, in fp32 against float64 on the
    same inputs (dt a softplus of normals, as phase 3 draws it), keep dx,
    ddt, dBm, dCm and dinit within REL of their largest value, while dA,
    one sum a head over B S rows of d cum terms that cancel, takes 1e-4
    (up to ~3.5e-5 seen where a head's dA cancels to a few units against
    rows of ~1e2)."""
    args = _inputs(B, S, H, P, N, seed=5 * S + N)
    f32 = ts.ssd_scan_bwd_plain(*map(_t, args[:5]), chunk, *map(_t, args[5:]))
    f64 = ts.ssd_scan_bwd_plain(*(torch.from_numpy(a).double()
                                  for a in args[:5]), chunk,
                                *(torch.from_numpy(a).double()
                                  for a in args[5:]))
    for name, a, w in zip(NAMES, f32, f64):
        err = float((a.double() - w).abs().max())
        scale = max(1.0, float(w.abs().max()))
        assert err <= (DA_REL if name == "dA" else REL) * scale, (name, err)


# =============================================================================
# the kernel's passes, emulated on the CPU
# =============================================================================
# the kernel's k-chunks: B3 sums dM over P in chunks of 64 terms, B5 cuts
# the heads' k-range into chunks of at most 64 terms of one head and sums
# GROUP_CHUNKS of them a CTA (csrc/ssd_scan.cu kPB, kGroupChunks)
CHUNK_TERMS, GROUP_CHUNKS = 64, 4


def _ssd_bwd_passes(x, dt, A, Bm, Cm, chunk, init_state, dy, dfinal,
                    split_b3=True, split_b5=True):
    """The CUDA backward's passes in plain PyTorch, every product through
    ``tf32_dot`` (3xTF32; ``split_b3`` / ``split_b5`` False: B3's or B5's
    products as one TF32 product): the forward's passes again (C.B^T and
    the chunk states, cum in order, the state pass with exp(cum_last)); B1,
    D_c = (e o dy)^T . C; B2, the reversed state pass; B3, dM = dy.x^T
    (each P chunk of 64 terms fresh, into a running sum), M = CB o (L o dt),
    this head's dCB = (L o dt) o dM and R = CB o L o dM, whose row sums of R
    dt and column sums are taken in double, dx = M^T.dy + w o (B.G^T), d cum
    in double and its reversed prefix sum, the chunk's dA term; B4, dCB
    summed over heads in order; B5, dC and dB as partials (group 0 the
    scores' part, each later group GROUP_CHUNKS k-chunks of the heads'
    state parts in one product) summed in order; B6, dA over the chunks in
    double.  Test code: no path of the package runs it."""
    F = torch.nn.functional
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S

    def rows(t):
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(Bsz, nc, Q, *t.shape[2:])
    xc, dtc, Bc, Cc, dyc = map(rows, (x, dt, Bm, Cm, dy))

    def dot(eq, a, b, split=True):
        return tf32_dot(eq, a, b, split)
    dtA = dtc * A
    run, cums = torch.zeros_like(dtA[:, :, 0]), []
    for r in range(Q):
        run = run + dtA[:, :, r]
        cums.append(run)
    cum = torch.stack(cums, dim=2)                     # (B, nc, Q, H)
    last = cum[:, :, -1:]
    CB = dot("bcin,bcjn->bcij", Cc, Bc)[..., None]
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()[None, None, :, :,
                                                       None]
    L = torch.where(causal, torch.exp(torch.where(
        causal, cum[:, :, :, None] - cum[:, :, None], 0.0)), 0.0)
    w = torch.exp(last - cum) * dtc
    e = torch.exp(cum)
    gamma = torch.exp(last[:, :, 0])
    states = dot("bcjhp,bcjn->bchpn", xc * w[..., None], Bc)
    s = init_state if init_state is not None else torch.zeros(Bsz, H, P, N)
    entering = []
    for c in range(nc):
        entering.append(s)
        s = gamma[:, c, :, None, None] * s + states[:, c]
    S_in = torch.stack(entering, dim=1)
    D = dot("bcihp,bcin->bchpn", dyc * e[..., None], Cc)        # B1
    g = dfinal if dfinal is not None else torch.zeros(Bsz, H, P, N)
    leaving = [None] * nc
    for c in reversed(range(nc)):                               # B2
        leaving[c] = g
        g = gamma[:, c, :, None, None] * g + D[:, c]
    G = torch.stack(leaving, dim=1)
    dM = torch.zeros(Bsz, nc, Q, Q, H)                          # B3
    for p0 in range(0, P, CHUNK_TERMS):
        dM = dM + dot("bcihp,bcjhp->bcijh", dyc[..., p0:p0 + CHUNK_TERMS],
                      xc[..., p0:p0 + CHUNK_TERMS], split_b3)
    a = L * dtc[:, :, None]                                     # L o dt
    M = CB * a
    dcbh = a * dM                                               # a head's dCB
    R = CB * L * dM
    row = (R.double() * dtc[:, :, None].double()).sum(3)        # (B, nc, i, H)
    col = R.double().sum(2)                                     # (B, nc, j, H)
    U = dot("bcjn,bchpn->bcjhp", Bc, G, split_b3)
    dx = dot("bcijh,bcihp->bcjhp", M, dyc, split_b3) + w[..., None] * U
    dw = (xc * U).sum(-1)
    de = (dyc * dot("bcin,bchpn->bcihp", Cc, S_in, split_b3)).sum(-1)
    dcum = (row - dtc.double() * col - (w * dw).double()
            + (e * de).double())
    dcum[:, :, -1] += (w * dw).double().sum(2) + (
        gamma * (G * S_in).sum((-2, -1))).double()
    da = dcum.flip(2).cumsum(2).flip(2)
    ddt = col.float() + torch.exp(last - cum) * dw + A * da.float()
    dap = (da * dtc.double()).sum(2).float()                    # (B, nc, H)
    dcb = dcbh[..., 0]
    for h in range(1, H):                                       # B4
        dcb = dcb + dcbh[..., h]
    dC = dot("bcij,bcjn->bcin", dcb, Bc, split_b5)              # B5
    dB = dot("bcij,bcin->bcjn", dcb, Cc, split_b5)
    chunks = [(h, p0) for h in range(H) for p0 in range(0, P, CHUNK_TERMS)]
    for g0 in range(0, len(chunks), GROUP_CHUNKS):
        ks = [(h, p) for h, p0 in chunks[g0:g0 + GROUP_CHUNKS]
              for p in range(p0, min(P, p0 + CHUNK_TERMS))]
        hs, ps = (torch.tensor(v) for v in zip(*ks))
        dC = dC + dot("bcik,bckn->bcin", e[..., hs] * dyc[..., hs, ps],
                      S_in[:, :, hs, ps], split_b5)
        dB = dB + dot("bcjk,bckn->bcjn", w[..., hs] * xc[..., hs, ps],
                      G[:, :, hs, ps], split_b5)
    dA = dap.double().reshape(-1, H).sum(0).float()             # B6

    def out(t):
        return t.reshape(Bsz, nc * Q, *t.shape[3:])[:, :S]
    return (out(dx), out(ddt), dA, out(dB), out(dC),
            g if init_state is not None else None)


# mamba2-780m's widths and A range with H cut to 4: a ragged chunk (300)
# with the real layers' dt range (up to 0.1: decay spans past the
# overflow, so the sequential reference is the yardstick), and whole
# chunks (384) with an entering state and dt up to 0.02 (spans below the
# overflow, so the chunked reference takes the state); five heads (two B5
# groups, the second of one head); a chunk of 40 (not a multiple of the
# 16-row tiles) and P over 64 with odd widths, dt a softplus of normals:
# B, S, H, P, N, chunk, init, dfinal, dt range
PASS_CASES = [
    (1, 300, 4, 64, 128, 128, False, False, (0.001, 0.1)),
    (1, 384, 4, 64, 128, 128, True, True, (0.001, 0.02)),
    (1, 256, 5, 64, 128, 128, True, False, (0.001, 0.02)),
    (2, 70, 3, 40, 12, 40, True, True, None),
    (1, 100, 2, 65, 20, 64, True, False, None),
]


def _pass_case(B, S, H, P, N, chunk, init, dfin, dt_range):
    """A PASS_CASES case's inputs (torch, or None) and ``jax.vjp`` of the
    reference (``ssd_chunked`` with an entering state, ``ssd_sequential``
    without)."""
    x, dt, A, Bm, Cm, s0, dy, dfinal = _inputs(
        B, S, H, P, N, seed=S + P, dt_range=dt_range,
        A=-np.linspace(1.0, 16.0, H) if N == 128 else None)
    s0 = s0 if init else None
    dfinal = dfinal if dfin else None
    if init:
        want = _vjp("chunked_init", chunk, (x, dt, A, Bm, Cm, s0), dy, dfinal)
    else:
        want = _vjp("sequential", 0, (x, dt, A, Bm, Cm), dy, None)
    assert all(np.isfinite(w).all() for w in want)
    return [_t(a) for a in (x, dt, A, Bm, Cm, s0, dy, dfinal)], want


@pytest.mark.parametrize("B,S,H,P,N,chunk,init,dfin,dt_range", PASS_CASES)
def test_kernel_passes_match_reference(B, S, H, P, N, chunk, init, dfin,
                                       dt_range):
    """The backward kernel's design before any chip time: its passes, every
    product in 3xTF32, against ``jax.vjp`` of the reference within REL of
    each gradient's largest value."""
    args, want = _pass_case(B, S, H, P, N, chunk, init, dfin, dt_range)
    got = _ssd_bwd_passes(*args[:5], chunk, *args[5:])
    for name, g, w in zip(NAMES, got, want):
        _assert_rel(g, w, name)


@pytest.mark.parametrize("one_tf32", ["B3", "B5"])
def test_one_tf32_product_breaks_the_bound(one_tf32):
    """Why the kernel takes three products: with B3's or B5's products as
    one TF32 product (10-bit mantissas), some gradient misses REL by more
    than 10x at mamba2's widths."""
    case = PASS_CASES[1]
    args, want = _pass_case(*case)
    got = _ssd_bwd_passes(*args[:5], case[5], *args[5:],
                          split_b3=one_tf32 != "B3",
                          split_b5=one_tf32 != "B5")
    worst = max(float(np.abs(g.numpy() - w).max())
                / (REL * max(1.0, float(np.abs(w).max())))
                for g, w in zip(got, want))
    assert worst > 10, worst


# =============================================================================
# a full-width mamba2-780m layer
# =============================================================================
# one layer at mamba2-780m's widths (d_model 1536, 48 heads of 64, state
# 128, chunk 128) over 256 tokens: every leaf's gradient within 1e-4 of its
# largest reference value, the bound chip_smoke holds a training step's
# gradients to (fp32 sums over 256 tokens and widths of 1536 to 6448 in
# other orders; observed below 1e-5)
LAYER_TOKENS, LAYER_REL = 256, 1e-4


@pytest.fixture(scope="module")
def full_layer():
    """One layer's params from the port's ``init_layer`` (the reference's
    distributions: dt in [1e-3, 1e-1], A from -1 to -16), carried to the
    reference as numpy; the layer's input and its output's cotangent
    seeded normals."""
    jcfg, cfg = R.get_config("mamba2-780m"), mamba2_780m.CONFIG
    layer = TS.init_layer(cfg, torch.Generator().manual_seed(0),
                          torch.float32)
    np_layer = {k: t.numpy() for k, t in layer.items()}
    rng = np.random.RandomState(0)
    x = rng.randn(1, LAYER_TOKENS, cfg.d_model).astype(np.float32)
    ct = rng.randn(1, LAYER_TOKENS, cfg.d_model).astype(np.float32)
    want = jax.jit(jax.grad(lambda p: jnp.sum(
        JS.block(jcfg, p, jnp.asarray(x)) * ct)))(
            {k: jnp.asarray(v) for k, v in np_layer.items()})
    want = {k: np.asarray(v) for k, v in want.items()}
    tp = {k: t.requires_grad_() for k, t in convert.lm_params_from_numpy(
        np_layer, device="cpu").items()}
    out = TS.block(cfg, tp, torch.from_numpy(x))[0]
    got = dict(zip(tp, torch.autograd.grad((out * torch.from_numpy(ct))
                                           .sum(), list(tp.values()))))
    return cfg, got, want


def test_full_width_layer_gradient_is_finite(full_layer):
    """The port's gradient of one full-width layer is finite in every
    leaf; the reference's is NaN in A_log, dt_bias, in_proj and ln (its
    chunked scan past the overflow, ROADMAP queue 3)."""
    cfg, got, want = full_layer
    assert got.keys() == want.keys()
    for name, g in got.items():
        assert torch.isfinite(g).all() and bool((g != 0).any()), name
    nan = sorted(k for k, w in want.items() if np.isnan(w).any())
    assert nan == ["A_log", "dt_bias", "in_proj", "ln"]


def test_full_width_layer_matches_reference_where_finite(full_layer):
    """The leaves the reference's gradient keeps finite (D, the conv, the
    gate norm, out_proj) against ``jax.grad`` of its ``block``."""
    _, got, want = full_layer
    finite = sorted(k for k, w in want.items() if np.isfinite(w).all())
    assert finite == ["D", "conv_b", "conv_w", "gate_ln", "out_proj"]
    for name in finite:
        w = want[name]
        err = float(np.abs(got[name].numpy() - w).max())
        assert err <= LAYER_REL * float(np.abs(w).max()), (name, err)


# =============================================================================
# the wrapper
# =============================================================================
@pytest.mark.parametrize("change,match", [
    ("dy", "do not match"), ("dfinal", "do not match"),
    ("dtype", "float32")])
def test_ssd_scan_bwd_rejects_bad_inputs(change, match):
    x, dt, A, Bm, Cm, s0, dy, dfinal = map(_t, _inputs(1, 16, 2, 4, 8,
                                                       seed=1))
    if change == "dy":
        dy = dy[:, :8]
    elif change == "dfinal":
        dfinal = dfinal.transpose(2, 3)
    else:
        dy = dy.double()
    with pytest.raises(ValueError, match=match):
        ts.ssd_scan_bwd(x, dt, A, Bm, Cm, 8, s0, dy, dfinal)


def test_no_gradient_without_grad_mode():
    """Under ``no_grad`` (serving) the forward takes no Function."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a).requires_grad_() for a in
                        _inputs(1, 16, 2, 4, 8, seed=2)[:5])
    with torch.no_grad():
        y, final = ts.ssd_scan(x, dt, A, Bm, Cm, 8)
    assert y.grad_fn is None and final.grad_fn is None
    y, final = ts.ssd_scan(x, dt, A, Bm, Cm, 8)
    assert type(y.grad_fn).__name__ == "_SSDScanBackward"
