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
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import FLASH_CASES

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
    q, k, v, do = _inputs(B, Sq, Sk, H, KV, D, seed=Sq + Sk + D)
    ref_out, vjp = jax.vjp(
        lambda a, b, c: attention_ref(a, b, c, causal=causal, window=window,
                                      softcap=cap),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
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
