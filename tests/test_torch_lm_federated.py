"""``run_federated`` over every LM family in the port against the JAX
package's, and the kernels' Functions under ``torch.func``.

* The transformer families' smoke configs (gemma2, qwen3, mixtral,
  internvl2 of ``tests/torch_lm_cases.py`` ``ARCHS``; the others are in
  ``tests/test_torch_lm_federated_recurrent.py``) in sync sfl at the
  middle OP with the int8 cut, top-k 0.5 error feedback and int8 deltas,
  2 clients, 2 rounds of 2 local iterations, from the reference's initial
  params (``torch_fl_cases.check_sync_discrete``): OPs, modelled round
  and comm times, drops and ``edge_time`` exact; the -CE eval metric and
  the final params within the discrete-step bounds of
  ``tests/torch_fl_cases.py`` (the int8 codes and top-k keeps that fp32
  rounding sends the other way: a few lanes beyond 1e-4 of their leaf's
  max, every other within it).
* The same runs in plain fp32 (``check_sync_plain``): the metric within
  1e-5 relative and every lane within 1e-5 of its leaf's max.
* The discrete-step bounds refuse qwen3's port runs that train wrongly
  (``torch_fl_cases.FAULTS``: training off, one local iteration of two),
  qwen3 being the family whose sound run comes nearest them.
* ``vmap(grad(...))`` through ``_FlashAttention`` and ``_SSDScan`` (the
  batched engine's step) equals a loop of ``grad`` over the clients, bit
  for bit on the CPU, where both run the plain versions; the SSD scan
  also with an ``A`` shared by the clients (not vmapped).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tf
from repro_torch.kernels import ssd_scan as ts
from torch_fl_cases import (DISCRETE_METRIC_REL, DISCRETE_PARAMS_REL,
                            DISCRETE_TREE_SHARE, check_sync_discrete,
                            check_sync_plain, discrete_readings,
                            one_intra_op_thread)

_ = one_intra_op_thread
ARCHS = ["gemma2-2b", "qwen3-0.6b", "mixtral-8x22b", "internvl2-2b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_sync_sfl_int8_topk_matches_reference(arch):
    check_sync_discrete(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_sync_sfl_plain_matches_reference(arch):
    check_sync_plain(arch)


def test_discrete_bounds_refuse_faulty_training():
    readings = discrete_readings("qwen3-0.6b")
    bounds = (DISCRETE_METRIC_REL, DISCRETE_PARAMS_REL, DISCRETE_TREE_SHARE)
    for name, got in readings.items():
        print(name, got)
        if name == "sound":
            assert all(g <= b for g, b in zip(got, bounds)), got
        else:
            assert all(g > b for g, b in zip(got, bounds)), (name, got)


def _client_grads(loss, params, inputs):
    """vmap(grad) over the clients, and a loop of grad."""
    batched = torch.func.vmap(torch.func.grad(loss))(params, *inputs)
    looped = torch.stack([torch.func.grad(loss)(params[i],
                                                *(x[i] for x in inputs))
                          for i in range(params.shape[0])])
    return batched, looped


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 30.0)])
def test_flash_attention_under_vmap_grad(window, softcap):
    rng = np.random.RandomState(0)
    C, B, S, H, KV, D = 3, 2, 24, 4, 2, 16
    q, k, v = (torch.from_numpy(rng.randn(C, B, S, n, D).astype(np.float32))
               for n in (H, KV, KV))
    w = torch.from_numpy(rng.randn(C, D, D).astype(np.float32) / 4)

    def loss(w, q, k, v):
        o = tf.flash_attention(q @ w, k @ w, v, causal=True, window=window,
                               softcap=softcap)
        return (o * o).sum()

    batched, looped = _client_grads(loss, w, (q, k, v))
    assert float(looped.abs().max()) > 0
    torch.testing.assert_close(batched, looped, rtol=0, atol=0)


@pytest.mark.parametrize("shared_a", [False, True])
def test_ssd_scan_under_vmap_grad(shared_a):
    rng = np.random.RandomState(1)
    C, B, S, H, P, N = 3, 2, 40, 4, 8, 16

    def arr(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.randn(*shape))
                                .astype(np.float32))

    x, Bm, Cm = arr(C, B, S, H, P), arr(C, B, S, N), arr(C, B, S, N)
    dt = torch.nn.functional.softplus(arr(C, B, S, H))
    A = -torch.exp(arr(C, H, scale=0.3))
    init = arr(C, B, H, P, N)
    if shared_a:
        A = A[:1].expand(C, H)

    def loss(x, dt, A, Bm, Cm, init):
        y, final = ts.ssd_scan(x, dt, A, Bm, Cm, 16, init)
        return (y * y).sum() + (final * final).sum()

    args = (x, dt, A, Bm, Cm, init)
    grad = torch.func.grad(loss, argnums=tuple(range(6)))
    in_dims = (0, 0, None if shared_a else 0, 0, 0, 0)
    batched = torch.func.vmap(grad, in_dims=in_dims)(
        *(a[0] if shared_a and i == 2 else a for i, a in enumerate(args)))
    looped = [grad(*(a[c] for a in args)) for c in range(C)]
    for i, b in enumerate(batched):
        want = torch.stack([g[i] for g in looped])
        assert float(want.abs().max()) > 0, i
        torch.testing.assert_close(b, want, rtol=0, atol=0)
