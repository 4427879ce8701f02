"""The port's flash attention against the JAX reference.

Inputs are made with numpy from a seed and fed to both packages.  On the
CPU the port's ``flash_attention`` takes its plain version, which is held
against the reference's oracle ``ref.attention_ref`` and its Pallas kernel
run in interpret mode, over the reference's own sweep ``FLASH_CASES``
(tests/test_kernels.py), at the tolerances that sweep holds the TPU kernel
to: 1e-5 in fp32, 2e-2 in bf16.  ``attention_plain`` is also held against
the model's own prefill attention (``layers.attention_scores_mask`` +
``layers.multi_head_attention``): the function the kernel replaces on the
serving path.  The kernel's arithmetic, the 3xTF32 split on the tensor
cores, is emulated here in plain PyTorch (``_attention_tf32``) and held to
the same tolerances.  The ``cuda`` cases run the hand-written kernel against
the plain version and skip where no card is visible.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import FLASH_CASES

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import layers as JL
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import flash_attention as tf

_TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _qkv(B, Sq, Sk, H, KV, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, H, D).astype(np.float32),
            rng.randn(B, Sk, KV, D).astype(np.float32),
            rng.randn(B, Sk, KV, D).astype(np.float32))


def _tol(dtype):
    return 1e-5 if dtype == jnp.float32 else 2e-2


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,cap,dtype",
                         FLASH_CASES)
def test_flash_attention_matches_reference(B, Sq, Sk, H, KV, D, causal,
                                           window, cap, dtype):
    q, k, v = _qkv(B, Sq, Sk, H, KV, D, seed=Sq + H + D)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    ref = attention_ref(jq, jk, jv, causal=causal, window=window,
                        softcap=cap)
    pallas = j_flash(jq, jk, jv, causal=causal, window=window, softcap=cap,
                     block_q=64, block_k=64, interpret=True)
    tdt = _TORCH_DTYPE[dtype]
    before = LAUNCHES["flash_attention"]
    out = tf.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                             causal=causal, window=window, softcap=cap)
    assert LAUNCHES["flash_attention"] == before    # CPU: the plain version
    assert out.dtype == tdt and out.shape == (B, Sq, H, D)
    got = out.float().numpy()
    tol = _tol(dtype)
    for want in (ref, pallas):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("S,H,KV,D,window,cap", [
    (70, 4, 2, 16, 0, 50.0),      # gemma2 smoke, global layer
    (70, 4, 2, 16, 32, 50.0),     # gemma2 smoke, local layer (window 32)
    (48, 4, 2, 16, 0, 0.0),       # qwen3 smoke (no cap)
    (96, 8, 4, 64, 40, 30.0),
])
def test_plain_matches_model_prefill_attention(S, H, KV, D, window, cap):
    """The function the kernel replaces in ``attention_block``'s prefill
    branch: a causal (+ window) mask from position 0 and the model's
    grouped-query attention."""
    q, k, v = _qkv(2, S, S, H, KV, D, seed=S + D)
    pos = jnp.arange(S, dtype=jnp.int32)
    mask = JL.attention_scores_mask(pos, pos, causal=True, window=window)
    want = JL.multi_head_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), mask, cap)
    got = tf.attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=True, window=window, softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# the shapes the hybrid and encdec families send the kernel: whisper-base's
# encoder (bidirectional over its 1500 frames at D = 64; 1500 is not a
# multiple of the kernel's 32-key tile) and its cross-attention (a short
# prompt over the 1500 frames), and recurrentgemma-9b's local layer (16
# query heads over one KV head of 256, a window shorter than the sequence)
FAMILY_CASES = [
    (1, 1500, 1500, 8, 8, 64, False, 0, 0.0, jnp.float32),
    (2, 12, 1500, 8, 8, 64, False, 0, 0.0, jnp.float32),
    (1, 300, 300, 16, 1, 256, True, 128, 0.0, jnp.float32),
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,cap,dtype",
                         FAMILY_CASES)
def test_family_shapes_match_reference(B, Sq, Sk, H, KV, D, causal, window,
                                       cap, dtype):
    """The plain path at the hybrid and encdec shapes against the
    reference's oracle, within 1e-5."""
    q, k, v = _qkv(B, Sq, Sk, H, KV, D, seed=Sk + H + D)
    want = attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                         causal=causal, window=window, softcap=cap)
    got = tf.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=causal, window=window, softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_rows_that_see_no_key_are_zero():
    """Sq > Sk under a causal window: the last rows see no key and come out
    0 (``ref.attention_ref``'s rule, which the kernel keeps)."""
    q, k, v = _qkv(1, 40, 8, 2, 1, 16, seed=3)
    got = tf.attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=True, window=4)
    want = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, window=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert not got[0, 12:].any()


@pytest.mark.parametrize("q_shape,k_shape,dtype,match", [
    ((1, 8, 4, 16), (1, 8, 3, 16), torch.float32, "multiple of KV"),
    ((1, 8, 4, 16), (1, 8, 2, 8), torch.float32, "do not match"),
    ((8, 4, 16), (1, 8, 2, 16), torch.float32, "takes q"),
    ((1, 8, 4, 16), (1, 8, 2, 16), torch.float16, "float32 or bfloat16"),
])
def test_flash_attention_rejects_bad_inputs(q_shape, k_shape, dtype, match):
    q = torch.zeros(q_shape, dtype=dtype)
    k = torch.zeros(k_shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        tf.flash_attention(q, k, k.clone())


# =============================================================================
# the kernel's 3xTF32 arithmetic, emulated on the CPU
# =============================================================================
def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: fp32 rounded to 10 mantissa bits, to nearest
    with ties away from zero (the low 13 bits cleared).  Adding half an
    ulp to the sign-magnitude bits rounds the magnitude for either sign."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    return ((bits + 0x1000) & ~0x1FFF).to(torch.int32).view(torch.float32)


def _dot(eq: str, a: torch.Tensor, b: torch.Tensor,
         split: bool) -> torch.Tensor:
    """An fp32-accumulated product of TF32 operands.  ``split``: the 3xTF32
    form, lo.hi + hi.lo before hi.hi, with hi = tf32(x) and
    lo = tf32(x - hi); otherwise one TF32 product hi.hi.  Products of two
    TF32 values are exact in fp32, so only the sums round, as in the
    tensor cores' fp32 accumulation."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    if not split:
        return torch.einsum(eq, ah, bh)
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _attention_tf32(q, k, v, causal, window, cap, split=True):
    """The kernel's function with both products in TF32 arithmetic: S from
    the split q and k, the unnormalized probabilities p = exp(s - max)
    split again for P.V, and the division by max(sum p, 1e-30) last."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, Sq, KV, H // KV, D)
    s = _dot("bqkgd,bskd->bkgqs", qg, k.float(), split) / math.sqrt(D)
    if cap > 0:
        s = cap * torch.tanh(s / cap)
    mask = tf.visible_mask(Sq, k.shape[1], causal, window)
    s = s.masked_fill(~mask, -1e30)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)),
                    torch.zeros(()))
    o = _dot("bkgqs,bskd->bkgqd", p, v.float(), split)
    o = o / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


# the kernel's sweep: the reference's cases, gemma2-2b's head shape (D =
# 256, GQA 8 over 4) with its softcap, global and with a window, and the
# hybrid and encdec shapes
TF32_CASES = FLASH_CASES + [
    (1, 600, 600, 8, 4, 256, True, 0, 50.0, jnp.float32),
    (1, 600, 600, 8, 4, 256, True, 256, 50.0, jnp.float32)] + FAMILY_CASES


def _tf32_error(B, Sq, Sk, H, KV, D, causal, window, cap, dtype, split):
    tdt = _TORCH_DTYPE[dtype]
    q, k, v = (torch.from_numpy(a).to(tdt)
               for a in _qkv(B, Sq, Sk, H, KV, D, seed=Sq + H + D))
    got = _attention_tf32(q, k, v, causal, window, cap, split)
    want = tf.attention_plain(q, k, v, causal, window, cap)
    assert got.dtype == want.dtype and got.shape == want.shape
    return got.float(), want.float()


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,cap,dtype",
                         TF32_CASES)
def test_3xtf32_split_within_tolerance(B, Sq, Sk, H, KV, D, causal, window,
                                       cap, dtype):
    """The kernel's 3xTF32 products keep attention within the reference's
    tolerance of the plain fp32 version: 1e-5 in fp32, 2e-2 in bf16."""
    got, want = _tf32_error(B, Sq, Sk, H, KV, D, causal, window, cap, dtype,
                            split=True)
    tol = _tol(dtype)
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,cap,dtype",
                         [c for c in TF32_CASES if c[-1] == jnp.float32])
def test_single_tf32_product_breaks_tolerance(B, Sq, Sk, H, KV, D, causal,
                                              window, cap, dtype):
    """Why the kernel splits: one TF32 product per operand pair (10-bit
    mantissas) puts fp32 attention beyond 1e-5 on every case of the sweep
    (about 1e-3), while the split stays within it."""
    got, want = _tf32_error(B, Sq, Sk, H, KV, D, causal, window, cap, dtype,
                            split=False)
    err = float((got - want).abs().max())
    assert err > 10 * _tol(dtype), err


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,cap,dtype",
                         FLASH_CASES + [
                             (1, 600, 600, 8, 4, 256, True, 0, 50.0,
                              jnp.float32),
                             (1, 600, 600, 8, 4, 256, True, 256, 50.0,
                              jnp.float32),
                             (1, 77, 77, 4, 2, 40, True, 0, 0.0,
                              jnp.float32),
                             (1, 300, 300, 8, 4, 256, True, 0, 50.0,
                              jnp.bfloat16),
                             (1, 50, 50, 2, 1, 13, True, 0, 0.0,
                              jnp.float32)] + FAMILY_CASES)
def test_kernel_matches_plain_on_card(cuda_device, B, Sq, Sk, H, KV, D,
                                      causal, window, cap, dtype):
    tdt = _TORCH_DTYPE[dtype]
    q, k, v = (torch.from_numpy(a).to(tdt).to(cuda_device)
               for a in _qkv(B, Sq, Sk, H, KV, D, seed=Sq + H + D))
    before = LAUNCHES["flash_attention"]
    out = tf.flash_attention(q, k, v, causal=causal, window=window,
                             softcap=cap)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    want = tf.attention_plain(q, k, v, causal, window, cap)
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
