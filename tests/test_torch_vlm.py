"""The port's VLM variant (internvl2-2b's smoke config) against the JAX
reference: the patch frontend stub (precomputed patch embeddings projected
by ``patch_proj`` and put before the tokens), prefill logits and caches,
and decode at positions after the patches.

Params come from the reference's ``api.init`` through ``convert``; tokens
and patches are numpy from a seed.  Tolerances as in
tests/test_torch_transformer.py (2e-5 absolute, rtol 1e-5: fp32 sums in
another order), and the reference's 2e-4 for decode against the full
forward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as R
from repro.models import api as japi
from repro.models import transformer as JT
from repro.serving import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import internvl2_2b
from repro_torch.models import api as tapi
from repro_torch.models import transformer as TT
from repro_torch.serving import ServeEngine

ATOL, RTOL = 2e-5, 1e-5
STEPWISE_TOL = 2e-4
SEQ = 40

_jprefill = jax.jit(JT.prefill, static_argnums=0,
                    static_argnames="target_seq")
_jdecode = jax.jit(JT.decode_step, static_argnums=0)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = R.get_smoke_config("internvl2-2b"), \
        internvl2_2b.smoke_config()
    jp = jax.jit(japi.init, static_argnums=(0, 2))(
        jcfg, jax.random.PRNGKey(0), jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    tp = convert.lm_params_from_numpy(np_params, device="cpu")
    rng = np.random.RandomState(1)
    toks = rng.randint(0, tcfg.vocab_size, (2, SEQ + 4)).astype(np.int32)
    patches = (0.1 * rng.randn(2, tcfg.num_patches, tcfg.d_model)).astype(
        np.float32)
    return jcfg, tcfg, jp, tp, np_params, toks, patches


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=RTOL)


def test_embed_inputs_puts_projected_patches_first(setup):
    jcfg, tcfg, jp, tp, _, toks, patches = setup
    got = TT.embed_inputs(tcfg, tp, torch.from_numpy(toks),
                          torch.from_numpy(patches))
    want = JT.embed_inputs(jcfg, jp, jnp.asarray(toks), jnp.asarray(patches))
    assert got.shape == (2, tcfg.num_patches + SEQ + 4, tcfg.d_model)
    _close(got.numpy(), want)
    # the text part is the plain token embedding
    torch.testing.assert_close(got[:, tcfg.num_patches:],
                               tp["embed"][torch.from_numpy(toks)],
                               atol=0, rtol=0)


def test_prefill_logits_and_cache_match(setup):
    jcfg, tcfg, jp, tp, _, toks, patches = setup
    target = tcfg.num_patches + SEQ + 4
    jl, jc = _jprefill(jcfg, jp, jnp.asarray(toks[:, :SEQ]),
                       jnp.asarray(patches), target_seq=target)
    tl, tc = tapi.prefill(tcfg, tp, {"tokens": torch.from_numpy(
        toks[:, :SEQ]), "patches": torch.from_numpy(patches)},
        target_seq=target)
    assert tc["k"].shape == (tcfg.num_layers, 2, target, tcfg.num_kv_heads,
                             tcfg.head_dim)
    _close(tl.numpy(), jl)
    for key in ("k", "v"):
        _close(tc[key].numpy(), jc[key])


@pytest.mark.parametrize("vector", [False, True])
def test_decode_after_the_patches_matches(setup, vector):
    """Decode at ``num_patches + S + i`` (one position, or a vector of
    per-row positions) against the reference, then against the port's own
    full forward over the same tokens within 2e-4."""
    jcfg, tcfg, jp, tp, _, toks, patches = setup
    P = tcfg.num_patches
    target = P + SEQ + 4
    batch = {"tokens": torch.from_numpy(toks[:, :SEQ]),
             "patches": torch.from_numpy(patches)}
    _, tc = tapi.prefill(tcfg, tp, batch, target_seq=target)
    _, jc = _jprefill(jcfg, jp, jnp.asarray(toks[:, :SEQ]),
                      jnp.asarray(patches), target_seq=target)
    for i in range(4):
        step = toks[:, SEQ + i:SEQ + i + 1]
        pos = np.full(2, P + SEQ + i, np.int32) if vector else P + SEQ + i
        tl, tc = tapi.decode(tcfg, tp, tc, torch.from_numpy(step),
                             torch.as_tensor(pos))
        jl, jc = _jdecode(jcfg, jp, jc, jnp.asarray(step),
                          jnp.asarray(pos, jnp.int32))
        _close(tl.numpy(), jl)
        for key in ("k", "v"):
            _close(tc[key].numpy(), jc[key])
    full, _ = tapi.prefill(tcfg, tp, {**batch, "tokens": torch.from_numpy(
        toks[:, :SEQ + 4])}, target_seq=target)
    assert float((tl - full).abs().max()) < STEPWISE_TOL


def test_vlm_needs_patches_and_the_engine_refuses_it(setup):
    jcfg, tcfg, jp, tp, _, toks, _ = setup
    with pytest.raises(ValueError, match="patch"):
        tapi.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    with pytest.raises(NotImplementedError, match="families"):
        JServeEngine(jcfg, jp, slots=1, max_prompt=8, max_seq=16)
    with pytest.raises(NotImplementedError, match="families"):
        ServeEngine(tcfg, tp, slots=1, max_prompt=8, max_seq=16)


def test_other_families_ignore_patches(setup):
    """The reference's ``embed_inputs`` reads ``patches`` only for the
    VLM; a dense config given some embeds its tokens alone."""
    _, tcfg, _, tp, _, toks, patches = setup
    dense = dataclasses.replace(tcfg, family="dense")
    x = TT.embed_inputs(dense, tp, torch.from_numpy(toks),
                        torch.from_numpy(patches))
    torch.testing.assert_close(x, tp["embed"][torch.from_numpy(toks)],
                               atol=0, rtol=0)


def test_convert_round_trip_and_init_layout(setup):
    _, tcfg, _, tp, np_params, _, _ = setup
    back = convert.lm_params_to_numpy(tp)
    flat_a = jax.tree_util.tree_leaves_with_path(np_params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    mine = jax.tree_util.tree_leaves_with_path(
        convert.lm_params_to_numpy(tapi.init(tcfg, seed=0, device="cpu")))
    assert [(p, a.shape, a.dtype) for p, a in mine] == \
        [(p, a.shape, a.dtype) for p, a in flat_a]
    d = tcfg.d_model
    assert np_params["patch_proj"].shape == (d, d)
    norms = tcfg.num_layers * 2 * d + d
    # the analytic count leaves out the frontend's projection
    assert sum(a.size for _, a in mine) == tcfg.param_count() + norms + d * d
