"""The port's flash attention against the JAX reference.

Inputs are made with numpy from a seed and fed to both packages.  On the
CPU the port's ``flash_attention`` takes its plain version, which is held
against the reference's oracle ``ref.attention_ref`` and its Pallas kernel
run in interpret mode, over the reference's own sweep ``FLASH_CASES``
(tests/test_kernels.py), at the tolerances that sweep holds the TPU kernel
to: 1e-5 in fp32, 2e-2 in bf16.  ``attention_plain`` is also held against
the model's own prefill attention (``layers.attention_scores_mask`` +
``layers.multi_head_attention``): the function the kernel replaces on the
serving path.  The ``cuda`` cases run the hand-written kernel against the
plain version and skip where no card is visible.
"""
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
                              jnp.float32)])
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
