"""The port's kernels against the JAX reference's Pallas kernels.

Inputs are made with numpy from a seed and go through both.  The reference
runs its Pallas bodies in interpret mode (``interpret=True``) and, for
top-k, also its vectorized twin ``_topk_blocks_ref``.  Every comparison is
exact: int8 codes, fp32 scales, dequantized values and top-k outputs are
equal bit for bit.  The ``cuda`` cases run the hand-written kernels and
skip where no card is visible.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant_transfer import ops as jq
from repro.kernels.topk_compress import ops as jt
from repro.kernels.topk_compress.topk_compress import topk_compress_pallas
from repro_torch.kernels import LAUNCHES, _build
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
    x[:3] = _tie_rows(C)[:R]
    x[3:4] = 0.0                                  # all-zero row
    return x


# every path the kernels' plans (``_row_plan``) split on: C of 1, 3, 13 and
# 37 (scalar, 4 a thread: 1 to 16 threads a row), 4 (a float4 a row), 32 and
# 64 (float4 groups of 8 and 16 lanes), 1024 (a CTA of 256 threads a row),
# 4096 (a CTA a row, 4 float4 a thread), 8200 and 2053 (above the register
# limit: the row read twice, in float4s and in scalars); R of 1 and R that
# no CTA's rows divide (300 rows of 16 a CTA)
QUANT_SHAPES = [(300, 32), (256, 64), (7, 1024), (1, 1), (5, 3), (1, 4),
                (33, 13), (300, 37), (1, 64), (3, 4096), (2, 8200),
                (2, 2053)]


@pytest.mark.parametrize("R,C", QUANT_SHAPES)
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


def _plan_columns(plan, C: int) -> np.ndarray:
    """The columns a plan's threads touch, one entry per touch: thread t,
    pass p, vector k, lane w of the vector, as the kernels index them."""
    n = C // plan.width
    passes = -(-n // (plan.group * plan.vecs))
    p, k, t = np.meshgrid(np.arange(passes), np.arange(plan.vecs),
                          np.arange(plan.group), indexing="ij")
    vec = ((p * plan.vecs + k) * plan.group + t).ravel()
    vec = vec[vec < n]
    return (vec[:, None] * plan.width + np.arange(plan.width)).ravel()


@pytest.mark.parametrize("which", ["quantize", "dequantize"])
def test_quant_plans_cover_every_column_once_within_limits(which):
    plan_of = tq._quant_plan if which == "quantize" else tq._dequant_plan
    # registers a thread holds per pass: fp32 values, or 4 codes a register;
    # a vector's load needs its own size of alignment
    per_reg = 1 if which == "quantize" else 4
    elem_bytes = 4 if which == "quantize" else 1
    for C in [*range(1, 3001), 4096, 8192, 8196, 8200, 20000, 65536]:
        for ptr in (0, 4, 1) if which == "dequantize" else (0, 4):
            plan = plan_of(C, ptr)
            g, w, v, threads = plan
            assert C % w == 0 and ptr % (w * elem_bytes) == 0, plan
            assert g & (g - 1) == 0 and v in (1, 2, 4, 8), plan
            assert threads % 32 == 0 and 32 <= threads <= tq.MAX_GROUP, plan
            assert (g <= 32 and threads % g == 0) or g == threads, plan
            assert v * w <= 32 * per_reg, plan
            cols = _plan_columns(plan, C)
            assert len(cols) == C, (C, plan)
            np.testing.assert_array_equal(np.sort(cols), np.arange(C))
            # up to the register limit the row is read once
            if C <= (8192 if w >= 4 else 2048):
                assert g * v * w >= C, (C, plan)
    # the main path's shapes: float4 groups of 8 and 16 lanes at the cut,
    # a CTA a row on the delta wire
    for plan_of in (tq._quant_plan, tq._dequant_plan):
        assert plan_of(32, 0) == (8, 4, 1, 128)
        assert plan_of(64, 0) == (16, 4, 1, 128)
        assert plan_of(1024, 0) == (256, 4, 1, 256)


@pytest.mark.cuda
def test_quantize_misaligned_view_equals_plain():
    """A contiguous view 4 bytes off a 16-byte boundary takes quantize's
    scalar path (``_quant_plan`` width 1), codes 1 byte off dequantize's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    for R, C in [(300, 32), (580, 1024), (3, 4096)]:
        x = torch.from_numpy(_quant_inputs(R, C, seed=C)).reshape(-1)
        buf = torch.zeros(R * C + 1, device="cuda")
        buf[1:] = x.cuda()
        view = buf[1:1 + R * C].view(R, C)
        assert view.data_ptr() % 16 == 4
        q, s = tq.quantize_rows(view)
        qp, sp = tq.quantize_rows_plain(view)
        assert torch.equal(q, qp)
        assert torch.equal(s.view(torch.int32), sp.view(torch.int32))
        qbuf = torch.zeros(R * C + 1, dtype=torch.int8, device="cuda")
        qbuf[1:] = q.reshape(-1)
        qview = qbuf[1:].view(R, C)
        assert torch.equal(tq.dequantize_rows(qview, s).view(torch.int32),
                           tq.dequantize_rows_plain(qview, s)
                           .view(torch.int32))


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
    # a meta tensor (the dry runs' stand-in) takes the plain version for
    # its shapes and launches nothing; a device with no kernel and no plain
    # version raises
    before = dict(LAUNCHES)
    q, scale = tq.quantize_rows(torch.zeros(4, 4, device="meta"))
    assert (q.device.type, q.dtype, tuple(q.shape), tuple(scale.shape)) == \
        ("meta", torch.int8, (4, 4), (4,))
    assert dict(LAUNCHES) == before
    with pytest.raises(ValueError, match="no kernel"):
        _build.wants_kernel(SimpleNamespace(device=torch.device("xpu")),
                            "quantize_rows")


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


# =============================================================================
# the radix select of csrc/topk_compress.cu, modelled in numpy
# =============================================================================
def _radix_select_model(xb: np.ndarray, meta: np.ndarray) -> np.ndarray:
    """The CUDA kernel's algorithm step by step, over all blocks at once:
    uint32 magnitude keys; 4 MSB-first passes of 8-bit digit histograms
    over the valid lanes matching the prefix, the bin found by 32 "lanes"
    of 8 bins each (a suffix sum over the lanes, then the lane's own bins
    from the top); then the tie rank as the kernel builds it (a count per
    thread of 4 lanes, an inclusive scan within each warp of 32 threads,
    the warp totals before it).  Returns the kept values, 0 elsewhere."""
    nb, block = xb.shape
    rows = np.arange(nb)
    valid = np.minimum(meta[:, 0].astype(np.int64), block)
    k = meta[:, 1].astype(np.int64)
    lane = np.arange(block)[None]
    ok = lane < valid[:, None]
    key = xb.view(np.uint32) & np.uint32(0x7fffffff)
    prefix = np.zeros(nb, np.uint32)
    rem = k.copy()
    for shift in (24, 16, 8, 0):
        digit = (key >> np.uint32(shift)) & np.uint32(0xff)
        match = ok.copy()
        if shift < 24:
            match &= (key >> np.uint32(shift + 8)) == prefix[:, None]
        hist = np.zeros((nb, 256), np.int64)
        np.add.at(hist, (np.broadcast_to(rows[:, None], key.shape)[match],
                         digit[match]), 1)
        per_lane = hist.reshape(nb, 32, 8)
        sums = per_lane.sum(axis=2)                         # (nb, 32)
        incl = np.cumsum(sums[:, ::-1], axis=1)[:, ::-1]    # lanes >= l
        above = incl - sums
        owner = (above < rem[:, None]) & (rem[:, None] <= incl)
        new_prefix, new_rem = prefix.copy(), rem.copy()
        for b in range(nb):
            if k[b] <= 0 or k[b] >= valid[b]:
                continue                 # the kernel's short cuts
            (l,) = np.flatnonzero(owner[b])      # exactly one lane
            a = above[b, l]
            for j in range(7, -1, -1):
                c = per_lane[b, l, j]
                if a + c >= rem[b]:
                    new_prefix[b] = (int(prefix[b]) << 8) | (l * 8 + j)
                    new_rem[b] = rem[b] - a
                    break
                a += c
        prefix, rem = new_prefix, new_rem
    kth, quota = prefix[:, None], rem[:, None]
    eq = ok & (key == kth)
    pad = (-block) % 4
    per_thread = np.pad(eq, ((0, 0), (0, pad))).reshape(nb, -1, 4).sum(2)
    nthreads = -(-per_thread.shape[1] // 32) * 32
    per_thread = np.pad(per_thread, ((0, 0), (0, nthreads -
                                              per_thread.shape[1])))
    warps = per_thread.reshape(nb, -1, 32)
    warp_incl = np.cumsum(warps, axis=2)
    warp_tot = warp_incl[:, :, -1]
    before = np.cumsum(warp_tot, axis=1) - warp_tot
    thread_excl = (warp_incl - warps + before[:, :, None]).reshape(nb, -1)
    lane_in_thread = np.cumsum(np.pad(eq, ((0, 0), (0, pad))).reshape(
        nb, -1, 4), axis=2) - np.pad(eq, ((0, 0), (0, pad))).reshape(
        nb, -1, 4)
    eq_rank = (thread_excl[:, :lane_in_thread.shape[1], None]
               + lane_in_thread).reshape(nb, -1)[:, :block]
    keep = ok & ((key > kth) | (eq & (eq_rank < quota)))
    keep |= ok & (k[:, None] >= valid[:, None])
    keep &= (k[:, None] > 0) & (valid[:, None] > 0)
    return np.where(keep, xb, np.float32(0))


def _model_equals_reference(x: np.ndarray, meta: np.ndarray, block: int):
    nb = x.size // block
    xb = x.reshape(nb, block)
    ref = np.asarray(jt._topk_blocks_ref(jnp.asarray(xb), jnp.asarray(meta),
                                         int(meta[:, 1].max())))
    got = _radix_select_model(xb, meta)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    plain = tt.topk_blocks_plain(torch.from_numpy(xb),
                                 torch.from_numpy(meta)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), plain.view(np.int32))
    return got


def _vgg5_row(seed: int, density: float):
    from repro_torch.configs.vgg import VGG5
    from repro_torch.fl.flatbuf import FlatLayout
    from repro_torch.models.vgg import init
    layout = FlatLayout(init(VGG5, torch.Generator().manual_seed(seed),
                             device="cpu"))
    x = np.random.RandomState(seed).randn(layout.padded).astype(np.float32)
    return x, layout.block_meta(density).astype(np.int32)


@pytest.mark.parametrize("case", ["ties", "heavy ties k=1..512",
                                  "masked tail", "density from true size",
                                  "density 1.0", "VGG-5 row",
                                  "equal exponents", "zeros and infinities",
                                  "block 100", "block 99"])
def test_radix_select_model_equals_reference(case):
    """The kernel's radix select (digit histograms over uint32 magnitude
    keys, the prefix and remaining k, the lane-order tie scan) is bit for
    bit the reference's ``_topk_blocks_ref`` and the plain version."""
    rng = np.random.RandomState(17)
    if case == "ties":
        x = np.asarray([5.0, -3.0, 3.0, 3.0, -5.0, 1.0, 0.5, 0.25] * 16,
                       np.float32)
        meta, block = np.asarray([[128, k] for k in (3,)], np.int32), 128
    elif case == "heavy ties k=1..512":
        x = rng.randint(-3, 4, 512 * 512).astype(np.float32)
        x[x == 0] = 1.0
        meta = np.asarray([[512, k] for k in range(1, 513)], np.int32)
        block = 512
    elif case == "masked tail":
        x = rng.randn(2048).astype(np.float32)
        x[1500:] = 100.0
        meta, block = tt.density_block_meta(1500, 1024, 0.02), 1024
    elif case == "density from true size":
        x = np.zeros(1024, np.float32)
        x[:100] = rng.randn(100)
        meta, block = tt.density_block_meta(100, 1024, 0.05), 1024
    elif case == "density 1.0":
        x = rng.randn(3000).astype(np.float32)
        x = np.pad(x, (0, 72))
        meta, block = tt.density_block_meta(3000, 1024, 1.0), 1024
    elif case == "VGG-5 row":
        x, meta = _vgg5_row(0, 0.1)
        block = 1024
    elif case == "equal exponents":
        # magnitudes in [1, 2): every key shares its top 9 bits, so the
        # passes at bits 24 and 16 each leave one bin
        x = (1.0 + rng.rand(4096)).astype(np.float32)
        x[::3] *= -1
        meta = np.asarray([[1024, k] for k in (1, 100, 700, 1023)], np.int32)
        block = 1024
    elif case == "zeros and infinities":
        x = rng.randn(1024).astype(np.float32)
        x[:300] = 0.0
        x[300:310] = -0.0
        x[500:503] = np.inf
        x[900] = -np.inf
        x = np.tile(x, 3)
        meta = np.asarray([[1024, 2], [1024, 720], [1000, 990]], np.int32)
        block = 1024
    elif case == "block 100":  # a block of 25 threads, one warp
        x = rng.randn(700).astype(np.float32)
        meta = np.asarray([[100, k] for k in (1, 10, 33, 50, 99, 100, 5)],
                          np.int32)
        block = 100
    else:                      # not a multiple of 4: the last thread's
        x = rng.randn(693).astype(np.float32)   # last lane lies past it
        meta = np.asarray([[99, k] for k in (1, 10, 33, 50, 98, 99, 5)],
                          np.int32)
        block = 99
    got = _model_equals_reference(x, meta, block)
    kept = (got != 0).sum(axis=1)
    if case != "zeros and infinities":       # kept zeros count as dropped
        np.testing.assert_array_equal(kept, np.minimum(meta[:, 1],
                                                       meta[:, 0]))


def test_topk_odd_block_sizes_equal_reference(device):
    """Blocks smaller than 1024 lanes: 100 and 36 lanes (multiples of 4,
    the float4 path, 25 and 9 threads rounded up to one warp) and 99 and
    37 lanes (not multiples of 4: the kernel's scalar path, where the last
    thread's last lanes fall past the block)."""
    rng = np.random.RandomState(23)
    for block, ks in [(100, (1, 10, 33, 50, 99, 100, 5)), (36, (1, 7, 35)),
                      (99, (1, 10, 33, 50, 98, 99, 5)), (37, (1, 7, 36))]:
        x = rng.randn(block * len(ks)).astype(np.float32)
        meta = np.asarray([[block, k] for k in ks], np.int32)
        ref = np.asarray(jt._topk_blocks_ref(
            jnp.asarray(x.reshape(len(ks), block)), jnp.asarray(meta),
            max(ks))).reshape(-1)
        # one row per block: rows share meta, so give each row its own
        for b, k in enumerate(ks):
            row = x[b * block:(b + 1) * block][None]
            out = tt.topk_compress_flat(torch.from_numpy(row).to(device),
                                        torch.tensor([[block, k]]).to(
                                            device), block)
            np.testing.assert_array_equal(
                _np(out)[0].view(np.int32),
                ref[b * block:(b + 1) * block].view(np.int32))
