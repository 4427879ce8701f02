"""The SSD scan's hand-written backward against its plain version on the
card (``cuda``-marked: every test skips where no card is visible).  This
file imports no JAX, so it runs on a machine with the card and without
JAX::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd_grad_card.py

Bounds, as chip_smoke's: dx, ddt, dBm, dCm and dinit within 1e-5 *
max(1, max|want|); dA, one sum a head over B S rows of cancelling d cum
terms, within 1e-4 * max(1, max|want|) (tests/test_torch_ssd_grad.py
test_plain_fp32_against_float64 shows fp32's own share of it); two calls
bitwise equal (no atomics).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import ssd_scan as ts

REL, DA_REL = 1e-5, 1e-4
NAMES = ("dx", "ddt", "dA", "dBm", "dCm", "dinit")
# B, S, H, P, N, chunk, init_state, dfinal: the reference's sweep
# (tests/test_kernels.py SSD_CASES, copied: this file imports no JAX) with
# neither and with both, a ragged chunk of 7 rows, mamba2-780m's widths
# (ragged) and the kernel's tiling edges: five heads leave the backward's
# last group of heads (four a group at P = 64) with one
CASES = [
    (2, 64, 4, 16, 16, 16, False, False),
    (1, 128, 2, 32, 32, 32, False, False),
    (2, 96, 4, 16, 16, 32, False, False),
    (1, 64, 2, 16, 16, 64, False, False),
    (2, 64, 4, 16, 16, 16, True, True),
    (1, 128, 2, 32, 32, 32, True, True),
    (2, 96, 4, 16, 16, 32, True, True),
    (1, 64, 2, 16, 16, 64, True, True),
    (2, 37, 3, 5, 3, 7, True, True),
    (1, 1000, 48, 64, 128, 128, False, False),   # mamba2-780m, ragged
    (2, 1000, 4, 64, 128, 128, True, True),      # B > 1, ragged
    (1, 50, 4, 64, 128, 128, True, True),        # S < chunk
    (1, 300, 4, 64, 128, 40, True, False),       # Q = 40
    (1, 200, 3, 65, 16, 64, True, True),         # odd P over 64
    (1, 200, 2, 130, 20, 64, False, True),       # P over two slices
    (1, 300, 5, 64, 128, 128, True, True),       # a ragged head group
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _inputs(B, S, H, P, N, seed, dev):
    """x, dt (a softplus of normals), A, Bm, Cm, the entering state, dy and
    dfinal, drawn with numpy and put on ``dev``."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, H, P)
    dt = np.log1p(np.exp(rng.randn(B, S, H)))
    A = -np.exp(rng.randn(H) * 0.5)
    Bm, Cm = rng.randn(B, S, N), rng.randn(B, S, N)
    s0, dy, dfinal = (rng.randn(B, H, P, N), rng.randn(B, S, H, P),
                      rng.randn(B, H, P, N))
    return [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in (x, dt, A, Bm, Cm, s0, dy, dfinal)]


def _assert_rel(got, want, name):
    assert got.shape == want.shape and bool(torch.isfinite(got).all()), name
    bound = (DA_REL if name == "dA" else REL) * max(
        1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= bound, f"{name}: max abs err {err} beyond {bound}"


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N,chunk,init,dfin", CASES)
def test_kernel_matches_plain_on_card(cuda_device, B, S, H, P, N, chunk,
                                      init, dfin):
    """Each gradient of the hand-written backward against
    ``ssd_scan_bwd_plain`` on the same card inputs; two calls give the same
    bits; one launch counted a call."""
    x, dt, A, Bm, Cm, s0, dy, dfinal = _inputs(B, S, H, P, N, S + P,
                                               cuda_device)
    s0 = s0 if init else None
    dfinal = dfinal if dfin else None
    before = LAUNCHES["ssd_scan_bwd"]
    got = ts.ssd_scan_bwd(x, dt, A, Bm, Cm, chunk, s0, dy, dfinal)
    again = ts.ssd_scan_bwd(x, dt, A, Bm, Cm, chunk, s0, dy, dfinal)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan_bwd"] == before + 2
    want = ts.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, chunk, s0, dy, dfinal)
    for name, g, a, w in zip(NAMES, got, again, want):
        if w is None:
            assert g is None, name
            continue
        assert torch.equal(g, a), name
        _assert_rel(g, w, name)


@pytest.mark.cuda
def test_kernel_gradient_through_strided_views_on_card(cuda_device):
    """x, Bm and Cm as views of one projection, as the model passes them:
    autograd through ``_SSDScan`` on the card launches the backward once
    and gives the projection's gradient that the plain backward gives."""
    B, S, H, P, N, chunk = 2, 300, 4, 64, 128, 128
    x, dt, A, Bm, Cm, _, dy, _ = _inputs(B, S, H, P, N, 11, cuda_device)
    row = torch.cat([x.reshape(B, S, H * P), Bm, Cm], dim=-1)
    row.requires_grad_()
    xv = row[..., :H * P].reshape(B, S, H, P)
    Bv, Cv = row[..., H * P:H * P + N], row[..., H * P + N:]
    before = dict(LAUNCHES)
    y, _ = ts.ssd_scan(xv, dt, A, Bv, Cv, chunk)
    (got,) = torch.autograd.grad(y, row, dy)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] == before["ssd_scan"] + 1
    assert LAUNCHES["ssd_scan_bwd"] == before["ssd_scan_bwd"] + 1
    dx, _, _, dB, dC, _ = ts.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, chunk,
                                                None, dy)
    want = torch.cat([dx.reshape(B, S, H * P), dB, dC], dim=-1)
    _assert_rel(got, want, "d projection")
