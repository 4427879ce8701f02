"""The gradient of the port's flash attention against the JAX reference.

The reference has no backward kernel: it differentiates its jnp attention.
So the port's ``_FlashAttention`` (the forward with its rows' log-sum-exp,
the backward ``flash_attention_bwd``) is held against ``jax.vjp`` of the
reference's oracle ``ref.attention_ref`` over the reference's sweep
``FLASH_CASES`` (tests/test_kernels.py; its fp32 cases: a gradient is fp32
only) plus a case whose rows past 15 see no key.  On the CPU the Function
runs ``attention_plain_lse`` and ``attention_bwd_plain``, the formulas of
the CUDA kernels (``csrc/flash_attention.cu``), which chip_smoke holds
against these plain versions on the card.

Tolerance: dq, dk, dv within 1e-5 * max(1, max|want|), the bound the chip
holds the kernels to; fp32 sums in other orders (observed below 2e-6).

The kernels' arithmetic, every product in the 3xTF32 split on the tensor
cores, each gradient tile's product summed apart and then added, is
emulated here in plain PyTorch (``_attention_bwd_tf32``) and held to the
same bound; a single TF32 product breaks it.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import FLASH_CASES
from tf32_emulation import tf32_dot

from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import flash_attention as tf

REL = 1e-5
# a row range that sees no key: 40 rows over 12 keys, window 4
EMPTY_ROWS = (1, 40, 12, 4, 2, 16, True, 4, 0.0, jnp.float32)
CASES = [c for c in FLASH_CASES if c[-1] == jnp.float32] + [EMPTY_ROWS]


def _inputs(B, Sq, Sk, H, KV, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, H, D).astype(np.float32),
            rng.randn(B, Sk, KV, D).astype(np.float32),
            rng.randn(B, Sk, KV, D).astype(np.float32),
            rng.randn(B, Sq, H, D).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _reference(B, Sq, Sk, H, KV, D, causal, window, cap):
    """A case's seeded inputs (q, k, v, do), the reference's output and its
    ``jax.vjp`` gradients dq, dk, dv, as numpy; computed once a case for
    the tests that hold the port and the kernels' emulation against it."""
    q, k, v, do = _inputs(B, Sq, Sk, H, KV, D, seed=Sq + Sk + D)
    ref_out, vjp = jax.vjp(
        lambda a, b, c: attention_ref(a, b, c, causal=causal, window=window,
                                      softcap=cap),
        *(jnp.asarray(a) for a in (q, k, v)))
    return ((q, k, v, do), np.asarray(ref_out),
            tuple(np.asarray(w) for w in vjp(jnp.asarray(do))))


def _port_grads(q, k, v, do, causal, window, cap):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tf.flash_attention(tq, tk, tv, causal=causal, window=window,
                             softcap=cap)
    return out, torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))


def _assert_rel(got, want, what):
    want = np.asarray(want)
    bound = REL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max abs err {err} beyond {bound}"


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,cap,dtype", CASES)
def test_flash_gradient_matches_reference(B, Sq, Sk, H, KV, D, causal,
                                          window, cap, dtype):
    (q, k, v, do), ref_out, want = _reference(B, Sq, Sk, H, KV, D, causal,
                                              window, cap)
    before = dict(LAUNCHES)
    out, got = _port_grads(q, k, v, do, causal, window, cap)
    assert LAUNCHES == before                    # CPU: the plain versions
    assert out.grad_fn is not None
    _assert_rel(out.detach().numpy(), ref_out, "out")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.isfinite(g).all(), name
        _assert_rel(g.numpy(), w, name)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,cap,dtype",
                         [CASES[2], CASES[3], CASES[4], EMPTY_ROWS])
def test_each_backward_kernel_wrapper_takes_its_plain_part(
        B, Sq, Sk, H, KV, D, causal, window, cap, dtype):
    """On the CPU the dq wrapper gives dq and delta = rowsum(do * o), and
    the dk/dv wrapper, fed that delta, gives dk and dv: each against the
    reference's gradient (same bound), without a launch."""
    q, k, v, do = _inputs(B, Sq, Sk, H, KV, D, seed=Sq * 3 + D)
    _, vjp = jax.vjp(
        lambda a, b, c: attention_ref(a, b, c, causal=causal, window=window,
                                      softcap=cap),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = tf.flash_attention_lse(tq, tk, tv, causal, window, cap)
    before = dict(LAUNCHES)
    dq, delta = tf.flash_attention_bwd_dq(tq, tk, tv, o, lse, tdo, causal,
                                          window, cap)
    dk, dv = tf.flash_attention_bwd_dkdv(tq, tk, tv, lse, delta, tdo, causal,
                                         window, cap)
    assert LAUNCHES == before
    assert delta.shape == (B, H, Sq) and delta.dtype == torch.float32
    torch.testing.assert_close(delta, (tdo * o).sum(-1).transpose(1, 2),
                               rtol=0, atol=0)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert torch.isfinite(g).all(), name
        _assert_rel(g.numpy(), w, name)
    whole = tf.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal, window,
                                   cap)
    for g, w in zip((dq, dk, dv), whole):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_rows_that_see_no_key_get_zero_gradients():
    B, Sq, Sk, H, KV, D, causal, window, cap, _ = EMPTY_ROWS
    q, k, v, do = _inputs(B, Sq, Sk, H, KV, D, seed=5)
    out, (dq, dk, dv) = _port_grads(q, k, v, do, causal, window, cap)
    empty = ~tf.visible_mask(Sq, Sk, causal, window).any(dim=1)
    assert int(empty.sum()) == Sq - (Sk + window - 1)
    assert (out[:, empty] == 0).all() and (dq[:, empty] == 0).all()
    assert all(torch.isfinite(g).all() for g in (dq, dk, dv))
    # the lse the forward keeps is +inf there, and the plain backward takes
    # it as is: every P of those rows is exp(-inf) = 0
    o, lse = tf.flash_attention_lse(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=causal, window=window)
    assert torch.isinf(lse[:, :, empty]).all() and (lse[:, :, empty] > 0).all()
    assert torch.isfinite(lse[:, :, ~empty]).all()


def test_lse_is_the_plain_logsumexp():
    q, k, v, _ = _inputs(2, 70, 70, 4, 2, 16, seed=3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = tf.flash_attention_lse(tq, tk, tv, True, 32, 50.0)
    assert lse.shape == (2, 4, 70) and lse.dtype == torch.float32
    s = tf._scores(tq, tk, True, 32, 50.0)          # (B, KV, G, Sq, Sk)
    want = torch.logsumexp(s, dim=-1).reshape(2, 4, 70)
    torch.testing.assert_close(lse, want, rtol=0, atol=0)
    torch.testing.assert_close(out, tf.attention_plain(tq, tk, tv, True, 32,
                                                       50.0), rtol=0, atol=0)


def test_gradient_is_fp32_only_and_no_grad_takes_the_forward_alone():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 2, 1, 16, 0))
    with pytest.raises(ValueError, match="float32"):
        tf.flash_attention(q.bfloat16().requires_grad_(), k.bfloat16(),
                           v.bfloat16())
    with torch.no_grad():
        out = tf.flash_attention(q.requires_grad_(), k, v)
    assert out.grad_fn is None
    torch.testing.assert_close(out, tf.attention_plain(q.detach(), k, v),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="match q"):
        tf.flash_attention_bwd(q, k, v, q, torch.zeros(1, 2, 7), q)


# =============================================================================
# the kernels' 3xTF32 arithmetic, emulated on the CPU
# =============================================================================
def _streamed_rows(D: int) -> int:
    """The kernels' streamed tile (``Bwd<DP>::BC`` of
    ``csrc/flash_attention.cu``): 16 rows at D > 128, else 32."""
    return 16 if D > 128 else 32


def _attention_bwd_tf32(q, k, v, do, causal, window, cap, split=True):
    """dq, dk, dv by the products the kernels compute, each in TF32
    arithmetic (``split``: 3xTF32, else one TF32 product): S = Q K^T and
    dP = dO V^T over D; P = exp(s - lse) and dS = P (dP - delta) times the
    softcap's factor in fp32; then dQ += dS K over each key tile, and
    dV += P^T dO, dK += dS^T Q over each query tile of each head of the
    GQA group in order, every tile's product summed apart and added to the
    fp32 gradient.  lse and delta come from the plain fp32 forward."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G, bc = H // KV, _streamed_rows(D)
    scale = 1.0 / math.sqrt(D)
    o, lse = tf.attention_plain_lse(q, k, v, causal, window, cap)
    qg = q.reshape(B, Sq, KV, G, D)
    dog = do.reshape(B, Sq, KV, G, D)
    delta = (dog * o.reshape(B, Sq, KV, G, D)).sum(-1)     # (B, Sq, KV, G)
    raw = tf32_dot("bqkgd,bskd->bkgqs", qg, k, split) * scale
    dcap = torch.ones(())
    if cap > 0:
        t = torch.tanh(raw / cap)
        raw, dcap = cap * t, 1.0 - t * t
    lse5 = lse.reshape(B, KV, G, Sq)[..., None]
    mask = tf.visible_mask(Sq, Sk, causal, window)
    p = torch.where(mask, torch.exp(raw - lse5), 0.0)
    dp = tf32_dot("bqkgd,bskd->bkgqs", dog, v, split)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) * dcap
    dq = torch.zeros(B, Sq, KV, G, D)
    for k0 in range(0, Sk, bc):
        dq += tf32_dot("bkgqs,bskd->bqkgd", ds[..., k0:k0 + bc],
                       k[:, k0:k0 + bc], split)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for g in range(G):
        for q0 in range(0, Sq, bc):
            rows = slice(q0, q0 + bc)
            dv += tf32_dot("bkqs,bqkd->bskd", p[:, :, g, rows],
                           dog[:, rows, :, g], split)
            dk += tf32_dot("bkqs,bqkd->bskd", ds[:, :, g, rows],
                           qg[:, rows, :, g], split)
    return dq.reshape(B, Sq, H, D) * scale, dk * scale, dv


def _bwd_tf32_errors(B, Sq, Sk, H, KV, D, causal, window, cap, split):
    """The emulation's max abs error in dq, dk, dv against ``jax.vjp`` of
    ``attention_ref``, and each bound 1e-5 * max(1, max|want|)."""
    inputs, _, want = _reference(B, Sq, Sk, H, KV, D, causal, window, cap)
    got = _attention_bwd_tf32(*(torch.from_numpy(a) for a in inputs),
                              causal, window, cap, split)
    out = []
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        out.append((float(np.abs(g.numpy() - w).max()),
                    REL * max(1.0, float(np.abs(w).max()))))
    return out


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,cap,dtype", CASES)
def test_3xtf32_backward_within_tolerance(B, Sq, Sk, H, KV, D, causal,
                                          window, cap, dtype):
    """The kernels' 3xTF32 products, summed tile by tile, keep dq, dk and dv
    within the reference's bound of ``jax.vjp`` of ``attention_ref``."""
    for name, (err, bound) in zip(("dq", "dk", "dv"), _bwd_tf32_errors(
            B, Sq, Sk, H, KV, D, causal, window, cap, split=True)):
        assert err <= bound, f"{name}: max abs err {err} beyond {bound}"


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,cap,dtype", CASES)
def test_single_tf32_backward_breaks_tolerance(B, Sq, Sk, H, KV, D, causal,
                                               window, cap, dtype):
    """Why every product splits: one TF32 product per operand pair puts
    some gradient beyond ten times the bound on every case."""
    errs = _bwd_tf32_errors(B, Sq, Sk, H, KV, D, causal, window, cap,
                            split=False)
    assert max(err / bound for err, bound in errs) > 10, errs


@pytest.mark.cuda
def test_backward_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the backward kernels run on the card "
                    "(chip_smoke.py phase 3 drills them)")
    for B, Sq, Sk, H, KV, D, causal, window, cap, _ in CASES:
        q, k, v, do = (torch.from_numpy(a).cuda() for a in
                       _inputs(B, Sq, Sk, H, KV, D, seed=1))
        o, lse = tf.flash_attention_lse(q, k, v, causal, window, cap)
        got = tf.flash_attention_bwd(q, k, v, o, lse, do, causal, window,
                                     cap)
        want = tf.attention_bwd_plain(q, k, v, o, lse, do, causal, window,
                                      cap)
        for g, w in zip(got, want):
            _assert_rel(g.cpu().numpy(), w.cpu().numpy(), "bwd")
        # no atomics: a second call gives the same bits
        again = tf.flash_attention_bwd(q, k, v, o, lse, do, causal, window,
                                       cap)
        assert all(torch.equal(g, a) for g, a in zip(got, again))
