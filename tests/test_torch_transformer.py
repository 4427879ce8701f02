"""The port's dense transformer against the JAX reference.

Params come from the reference's ``api.init`` and are carried across by
``convert`` (the two packages draw different random bits from a seed);
tokens are numpy from a seed.  Each config runs the full-sequence
``forward``, ``prefill`` and ``decode_step`` (one position for the whole
batch, and a vector of per-row positions) in both packages on the CPU,
where the port's prefill attention takes the flash kernel's plain version.
Prompts (70 tokens) are longer than gemma2's smoke window (32), so the
local layers' window masks work, and the all-local variant's cache is a
32-slot rolling buffer.

Tolerance: 2e-5 absolute (rtol 1e-5) on hidden states, logits and caches:
fp32 matmuls sum in another order in each framework, which moves these
O(1) values by a few ulps per layer.
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
from repro_torch import convert
from repro_torch.configs import (gemma2_2b, llama3_8b, lm_small, minicpm_2b,
                                 qwen3_0_6b)
from repro_torch.models import api as tapi
from repro_torch.models import transformer as TT

ATOL, RTOL = 2e-5, 1e-5
SEQ, TARGET = 70, 80

_CONFIGS = {
    "qwen3-0.6b": qwen3_0_6b.smoke_config(),
    "gemma2-2b": gemma2_2b.smoke_config(),
    "gemma2-2b-all-local": dataclasses.replace(gemma2_2b.smoke_config(),
                                               layer_pattern=("L",)),
    # the dense configs that came with the registry: GQA with a large rope
    # base, and tied embeddings with full multi-head attention
    "llama3-8b": llama3_8b.smoke_config(),
    "minicpm-2b": minicpm_2b.smoke_config(),
}


def _reference_config(name):
    if name == "gemma2-2b-all-local":
        return dataclasses.replace(R.get_smoke_config("gemma2-2b"),
                                   layer_pattern=("L",))
    return R.get_smoke_config(name)


@pytest.fixture(scope="module", params=list(_CONFIGS))
def setup(request):
    name = request.param
    jcfg, tcfg = _reference_config(name), _CONFIGS[name]
    jp = japi.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    tp = convert.lm_params_from_numpy(np_params, device="cpu")
    toks = np.random.RandomState(1).randint(
        0, tcfg.vocab_size, (2, SEQ)).astype(np.int32)
    return name, jcfg, tcfg, jp, tp, np_params, toks


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def test_forward_hidden_matches(setup):
    _, jcfg, tcfg, jp, tp, _, toks = setup
    jh, _ = JT.forward(jcfg, jp, jnp.asarray(toks))
    th, cache = TT.forward(tcfg, tp, torch.from_numpy(toks))
    assert cache is None
    _close(th.numpy(), jh)


def test_prefill_logits_and_cache_match(setup):
    name, jcfg, tcfg, jp, tp, _, toks = setup
    jl, jc = JT.prefill(jcfg, jp, jnp.asarray(toks), target_seq=TARGET)
    tl, tc = TT.prefill(tcfg, tp, torch.from_numpy(toks), target_seq=TARGET)
    want_cl = 32 if name == "gemma2-2b-all-local" else TARGET
    assert tc["k"].shape == (tcfg.num_layers, 2, want_cl, tcfg.num_kv_heads,
                             tcfg.head_dim)
    assert tl.dtype == torch.float32
    _close(tl.numpy(), jl)
    for key in ("k", "v"):
        _close(tc[key].numpy(), jc[key])


@pytest.mark.parametrize("vector", [False, True])
def test_decode_step_matches(setup, vector):
    _, jcfg, tcfg, jp, tp, _, toks = setup
    _, jc = JT.prefill(jcfg, jp, jnp.asarray(toks), target_seq=TARGET)
    _, tc = TT.prefill(tcfg, tp, torch.from_numpy(toks), target_seq=TARGET)
    tok = np.array([[3], [7]], np.int32)
    pos = np.array([SEQ, SEQ - 25], np.int32) if vector else SEQ
    for step in range(3):      # rolls past the all-local buffer's end
        p = pos + step
        jl, jc = JT.decode_step(jcfg, jp, jc, jnp.asarray(tok),
                                jnp.asarray(p, jnp.int32))
        tl, tc = TT.decode_step(tcfg, tp, tc, torch.from_numpy(tok),
                                torch.as_tensor(p))
        _close(tl.numpy(), jl)
        for key in ("k", "v"):
            _close(tc[key].numpy(), jc[key])
        tok = (tok * 5 + step) % tcfg.vocab_size


def test_convert_round_trip_is_bitwise(setup):
    _, _, _, _, tp, np_params, _ = setup
    back = convert.lm_params_to_numpy(tp)
    flat_a = jax.tree_util.tree_leaves_with_path(np_params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_port_init_matches_reference_layout(setup):
    """Same tree, shapes and dtypes as the reference's init; the same
    distributions (other random bits)."""
    _, jcfg, tcfg, _, _, np_params, _ = setup
    tp = tapi.init(tcfg, seed=0, device="cpu")
    mine = jax.tree_util.tree_leaves_with_path(
        convert.lm_params_to_numpy(tp))
    ref = jax.tree_util.tree_leaves_with_path(np_params)
    assert [(p, a.shape, a.dtype) for p, a in mine] == \
        [(p, a.shape, a.dtype) for p, a in ref]
    wq = tp["layers"]["attn"]["wq"]
    assert abs(float(wq.std()) * np.sqrt(tcfg.d_model) - 1.0) < 0.05
    assert abs(float(tp["embed"].std()) / 0.02 - 1.0) < 0.05
    assert not tp["final_norm"].any()
    per_layer = (4 if tcfg.post_block_norm else 2) * tcfg.d_model + (
        2 * tcfg.head_dim if tcfg.qk_norm else 0)
    norms = tcfg.num_layers * per_layer + tcfg.d_model
    assert sum(a.size for _, a in mine) == tcfg.param_count() + norms


@pytest.mark.parametrize("name,cfg", [
    ("gemma2-2b", gemma2_2b.CONFIG), ("qwen3-0.6b", qwen3_0_6b.CONFIG),
    ("gemma2-2b-smoke", gemma2_2b.smoke_config()),
    ("qwen3-0.6b-smoke", qwen3_0_6b.smoke_config()),
    ("lm16m", lm_small.LM16M), ("lm100m", lm_small.LM100M)])
def test_configs_equal_reference(name, cfg):
    from repro.configs import lm_small as jsmall
    ref = {"gemma2-2b": R.get_config("gemma2-2b"),
           "qwen3-0.6b": R.get_config("qwen3-0.6b"),
           "gemma2-2b-smoke": R.get_smoke_config("gemma2-2b"),
           "qwen3-0.6b-smoke": R.get_smoke_config("qwen3-0.6b"),
           "lm16m": jsmall.LM16M, "lm100m": jsmall.LM100M}[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.param_count() == ref.param_count()
    assert TT.window_schedule(cfg) == np.asarray(
        JT.window_schedule(ref)).tolist()
    for seq in (16, 4640):
        assert TT.cache_len(cfg, seq) == JT.cache_len(ref, seq)


def test_unported_families_raise():
    """hybrid (recurrentgemma-9b) and encdec (whisper-base) are served and
    trained by their own modules, which ``api.get_model`` returns; the
    transformer still refuses them ("LM families").  ``api.loss`` is each
    family's ``loss_fn`` (tests/test_torch_lm_loss.py)."""
    from repro_torch.configs import recurrentgemma_9b, whisper_base
    from repro_torch.models import encdec, hybrid
    for cfg, module in ((recurrentgemma_9b.smoke_config(), hybrid),
                        (whisper_base.smoke_config(), encdec)):
        assert tapi.get_model(cfg) is module
        with pytest.raises(NotImplementedError, match="LM families"):
            TT.init(cfg, device="cpu")
        with pytest.raises(NotImplementedError, match="LM families"):
            TT.forward(cfg, {}, torch.zeros((1, 4), dtype=torch.long))
    cfg = qwen3_0_6b.smoke_config()
    params = TT.init(cfg, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    batch = {"tokens": toks, "labels": toks}
    with torch.no_grad():
        assert torch.equal(tapi.loss(cfg, params, batch),
                           TT.loss_fn(cfg, params, batch))


def test_init_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: init(device=None) would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.init(qwen3_0_6b.smoke_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.lm_params_from_numpy({"embed": np.zeros(2)})
