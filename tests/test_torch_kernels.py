"""The port's kernels against the JAX reference's Pallas kernels.

Inputs are made with numpy from a seed and go through both.  The reference
runs its Pallas bodies in interpret mode (``interpret=True``) and, for
top-k, also its vectorized twin ``_topk_blocks_ref``.  Every comparison is
exact: int8 codes, fp32 scales, dequantized values and top-k outputs are
equal bit for bit.  The ``cuda`` cases run the hand-written kernels and
skip where no card is visible.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant_transfer import ops as jq
from repro.kernels.topk_compress import ops as jt
from repro.kernels.topk_compress.topk_compress import topk_compress_pallas
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import quant_transfer as tq
from repro_torch.kernels import topk_compress as tt


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device(request.param)


def _np(t):
    return t.detach().cpu().numpy()


# =============================================================================
# int8 quantize / dequantize
# =============================================================================
def _tie_rows(C: int) -> np.ndarray:
    """Rows whose x / scale lands exactly on .5, where rint (half to even)
    and roundf (half away from zero) disagree; scale 3 has an inexact
    reciprocal, so a quantizer multiplying by 1 / scale may land off the
    tie."""
    rows = []
    for scale in (1.0, 2.0, 3.0):
        r = np.zeros(C, np.float32)
        r[0] = 127.0 * scale                      # absmax -> this scale
        halves = (np.arange(1, C) % 9 - 4.5) * scale
        r[1:] = halves
        rows.append(r)
    return np.stack(rows)


def _quant_inputs(R: int, C: int, seed: int) -> np.ndarray:
    x = np.random.RandomState(seed).randn(R, C).astype(np.float32) * 3.0
    x[:3] = _tie_rows(C)
    x[3] = 0.0                                    # all-zero row
    return x


@pytest.mark.parametrize("R,C", [(300, 32), (256, 64), (7, 1024)])
def test_quantize_dequantize_equal_reference(R, C, device):
    x = _quant_inputs(R, C, seed=R + C)
    q_ref, s_ref = jq.quantize(jnp.asarray(x), interpret=True)
    d_ref = jq.dequantize(q_ref, s_ref, interpret=True)
    before = dict(LAUNCHES)
    q, s = tq.quantize(torch.from_numpy(x).to(device))
    d = tq.dequantize(q, s)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(_np(q), np.asarray(q_ref))
    np.testing.assert_array_equal(_np(s).view(np.int32),
                                  np.asarray(s_ref).view(np.int32))
    np.testing.assert_array_equal(_np(d).view(np.int32),
                                  np.asarray(d_ref).view(np.int32))
    launched = device.type == "cuda"
    assert LAUNCHES["quantize"] - before["quantize"] == int(launched)
    assert LAUNCHES["dequantize"] - before["dequantize"] == int(launched)


def test_quantize_ties_round_half_to_even():
    q, s = tq.quantize_rows(torch.from_numpy(_tie_rows(10)))
    np.testing.assert_array_equal(_np(s), [1.0, 2.0, 3.0])
    # x / scale = -4.5 .. 3.5 in steps of 1: half to even
    np.testing.assert_array_equal(_np(q)[:, 1:9],
                                  np.tile([-4, -2, -2, 0, 0, 2, 2, 4], (3, 1)))


def test_quantize_rows_follow_the_last_axis(device):
    """A channels-last activation quantizes B*H*W rows of C, like the
    reference's reshape(-1, shape[-1])."""
    x = np.random.RandomState(5).randn(2, 4, 4, 8).astype(np.float32)
    q_ref, s_ref = jq.quantize(jnp.asarray(x), interpret=True)
    q, s = tq.quantize(torch.from_numpy(x).to(device))
    assert tuple(s.shape) == (2, 4, 4)
    np.testing.assert_array_equal(_np(q), np.asarray(q_ref))
    np.testing.assert_array_equal(_np(s), np.asarray(s_ref))
    fq_ref = jq.fake_quant_int8(jnp.asarray(x))
    fq = tq.fake_quant_int8(torch.from_numpy(x).to(device))
    np.testing.assert_array_equal(_np(fq), np.asarray(fq_ref))


def test_fake_quant_gradient_is_identity(device):
    x = torch.from_numpy(np.random.RandomState(1).randn(64, 32)
                         .astype(np.float32)).to(device).requires_grad_()
    (tq.fake_quant_int8(x) * 3.0).sum().backward()
    np.testing.assert_array_equal(_np(x.grad), np.full((64, 32), 3.0))


def test_wrappers_check_their_inputs():
    with pytest.raises(ValueError):
        tq.quantize_rows(torch.zeros(4, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        tq.quantize_rows(torch.zeros(4, 8)[:, ::2])          # not contiguous
    with pytest.raises(ValueError):
        tq.dequantize_rows(torch.zeros(4, 4, dtype=torch.int8),
                           torch.zeros(3))
    with pytest.raises(ValueError):
        tt.topk_compress_flat(torch.zeros(1, 1000), np.zeros((1, 2)), 1024)
    with pytest.raises(ValueError):                         # no kernel there
        tq.quantize_rows(torch.zeros(4, 4, device="meta"))


# =============================================================================
# block top-k
# =============================================================================
def test_density_block_meta_and_keep_count_equal_reference():
    for n, block, d in [(100, 1024, 0.05), (1500, 1024, 0.02),
                        (4096, 512, 0.1), (593_920, 1024, 0.1), (7, 4, 1.0)]:
        np.testing.assert_array_equal(tt.density_block_meta(n, block, d),
                                      jt.density_block_meta(n, block, d))
    for d, v in [(0.01, 100), (0.3, 10), (0.1, 1024), (1.0, 476), (0.5, 1)]:
        assert tt.keep_count(d, v) == jt.keep_count(d, v)


def _assert_topk_equal(x: np.ndarray, meta: np.ndarray, block: int, device):
    nb = x.size // block
    kmax = int(meta[:, 1].max())
    ref = np.asarray(jt._topk_blocks_ref(jnp.asarray(x.reshape(nb, block)),
                                         jnp.asarray(meta), kmax)).reshape(-1)
    pal = np.asarray(topk_compress_pallas(
        jnp.asarray(x), jnp.asarray(meta), kmax=kmax, block=block,
        interpret=True))
    np.testing.assert_array_equal(pal.view(np.int32), ref.view(np.int32))
    out = tt.topk_compress_flat(torch.from_numpy(x[None]).to(device),
                                torch.from_numpy(meta).to(device), block)
    np.testing.assert_array_equal(_np(out)[0].view(np.int32),
                                  ref.view(np.int32))
    # exactly k survivors per block (no zero inputs are drawn)
    kept = (_np(out)[0].reshape(nb, block) != 0).sum(axis=1)
    np.testing.assert_array_equal(kept, meta[:, 1])


@pytest.mark.parametrize("density", [0.02, 0.25, 1.0])
def test_topk_equal_reference_masked_tail(density, device):
    """1500 true lanes in two 1024-lane blocks: the tail's 548 padding lanes
    (filled with large values here) must never be selected."""
    rng = np.random.RandomState(7)
    x = rng.randn(2048).astype(np.float32)
    x[1500:] = 100.0
    meta = tt.density_block_meta(1500, 1024, density)
    _assert_topk_equal(x, meta, 1024, device)


def test_topk_equal_reference_ties(device):
    """Duplicated magnitudes straddle the k-th threshold: the earlier lane
    wins, and exactly k survive."""
    t = np.asarray([5.0, -3.0, 3.0, 3.0, -5.0, 1.0, 0.5, 0.25] * 16,
                   np.float32)
    _assert_topk_equal(t, np.asarray([[128, 3]], np.int32), 128, device)
    # heavy ties: small integers, several budgets
    x = np.random.RandomState(3).randint(-3, 4, 4096).astype(np.float32)
    x[x == 0] = 1.0
    meta = np.asarray([[512, k] for k in (1, 7, 100, 300, 511, 512, 64, 2)],
                      np.int32)
    _assert_topk_equal(x, meta, 512, device)


def test_topk_density_from_true_size(device):
    """A 100-element leaf at density 0.05 keeps 5 entries, not
    int(0.05 * 1024)."""
    x = np.zeros(1024, np.float32)
    x[:100] = np.random.RandomState(1).randn(100)
    meta = tt.density_block_meta(100, 1024, 0.05)
    assert meta.tolist() == [[100, 5]]
    _assert_topk_equal(x, meta, 1024, device)


def test_topk_flat_rows_equal_reference(device):
    """Several client rows sharing one layout's meta, as the server step
    calls it, against the reference's topk_compress_flat."""
    rng = np.random.RandomState(11)
    sizes = [864, 32, 32, 32, 32, 18432, 64, 10]       # leaves of a layout
    meta = np.concatenate([tt.density_block_meta(n, 1024, 0.1)
                           for n in sizes])
    buf = np.zeros((3, 1024 * len(meta)), np.float32)
    off = 0
    for n, m in zip(sizes, np.split(meta, np.cumsum(
            [len(tt.density_block_meta(n, 1024, 0.1)) for n in sizes])[:-1])):
        buf[:, off:off + n] = rng.randn(3, n)
        off += 1024 * len(m)
    ref = np.asarray(jt.topk_compress_flat(jnp.asarray(buf), meta,
                                           int(meta[:, 1].max())))
    out = tt.topk_compress_flat(torch.from_numpy(buf).to(device),
                                torch.from_numpy(meta).to(device))
    np.testing.assert_array_equal(_np(out), ref)
