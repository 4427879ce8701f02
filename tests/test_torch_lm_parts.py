"""The parts of the port's LM training slice that are no model, against the
JAX reference: ``optim.adafactor`` and ``make_optimizer``, the LM cost
model (``core/costmodel.py``: ``lm_layer_flops``, ``lm_embed_head_flops``,
``lm_workload``, ``program_workload``, ``slice_profile``) and the token
data (``data.synthetic.token_dataset`` / ``batch_tokens``).

Tolerances: adafactor's params and factored statistics within 1e-6 after
four steps (observed 6e-8: the row and column means reduce in another
order); the cost model and the data exactly, the cost model in float64 as
the reference computes it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import registry as JR
from repro.configs.lm_small import SMALL_CONFIGS as J_SMALL
from repro.core import costmodel as jcm
from repro.data import synthetic as jsyn
from repro.models.split_program import get_split_program as jget
from repro_torch import optim as topt
from repro_torch.configs import registry as TR
from repro_torch.configs.lm_small import SMALL_CONFIGS as T_SMALL
from repro_torch.core import costmodel as tcm
from repro_torch.data import synthetic as tsyn
from repro_torch.models.split_program import get_split_program as tget
from repro_torch.tree import tree_leaves

ADAFACTOR_ATOL = 1e-6


def _tree(rng):
    """Stacked-layer leaves (3 and 4 dims, factored over the last two),
    a matrix, a vector and a scalar (not factored)."""
    return {"layers": {"w": rng.randn(3, 6, 5), "e": rng.randn(2, 3, 4, 5)},
            "m": rng.randn(7, 4), "v": rng.randn(9), "s": rng.randn()}


def _as(tree, fn, scale=1.0):
    if isinstance(tree, dict):
        return {k: _as(v, fn, scale) for k, v in tree.items()}
    return fn(np.asarray(tree * scale, np.float32))


@pytest.mark.parametrize("kw", [
    {},
    {"weight_decay": 0.1, "clip_threshold": 0.5},
    {"min_dim_factored": 3, "decay_pow": 0.5},
], ids=["default", "decay-clip", "factored-3d-only"])
def test_adafactor_four_steps_match_reference(kw):
    rng = np.random.RandomState(len(kw))
    params, grads = _tree(rng), [_tree(rng) for _ in range(4)]
    jo = jopt.adafactor(jopt.cosine(1e-2, 4, warmup_steps=1), **kw)
    to = topt.adafactor(topt.cosine(1e-2, 4, warmup_steps=1), **kw)
    jp, tp = _as(params, jnp.asarray), _as(params, torch.from_numpy)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update(jp, _as(g, jnp.asarray, 2.0), js)
        tp, ts = to.update(tp, _as(g, torch.from_numpy, 2.0), ts)
    assert int(ts["step"]) == int(js["step"]) == 4
    for want, got in ((jp, tp), (js["stats"], ts["stats"])):
        jl, tl = jax.tree_util.tree_leaves(want), tree_leaves(got)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            assert b.dtype == torch.float32 and b.shape == a.shape
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=ADAFACTOR_ATOL)
    # the stacked leaves keep their layer axes in the factored statistics
    assert ts["stats"]["layers"]["e"]["vr"].shape == (2, 3, 4)
    assert ts["stats"]["layers"]["e"]["vc"].shape == (2, 3, 5)


def test_make_optimizer_names():
    for name in ("sgd", "adamw", "adafactor"):
        assert topt.make_optimizer(name).name == name
    with pytest.raises(KeyError):
        topt.make_optimizer("lamb")


def _configs():
    out = [(JR.get_config(a), TR.get_config(a)) for a in JR.ARCH_NAMES]
    out += [(JR.get_smoke_config(a), TR.get_smoke_config(a))
            for a in JR.ARCH_NAMES]
    return out + [(J_SMALL[k], T_SMALL[k]) for k in J_SMALL]


def test_lm_cost_model_is_the_references_exactly():
    for jcfg, tcfg in _configs():
        for seq in (1, 64, 4096, 32768):
            np.testing.assert_array_equal(tcm.lm_layer_flops(tcfg, seq),
                                          jcm.lm_layer_flops(jcfg, seq))
            assert tcm.lm_embed_head_flops(tcfg, seq) == \
                jcm.lm_embed_head_flops(jcfg, seq)
        tw, jw = tcm.lm_workload(tcfg, 2, 512), jcm.lm_workload(jcfg, 2, 512)
        assert tw.name == jw.name
        np.testing.assert_array_equal(tw.layer_flops, jw.layer_flops)
        np.testing.assert_array_equal(tw.cut_bytes, jw.cut_bytes)
        for B, S, per in ((1, 4096, 2), (2, 16, 4)):
            tw = tcm.program_workload(tget(tcfg), B, S, bytes_per_el=per)
            jw = jcm.program_workload(jget(jcfg), B, S, bytes_per_el=per)
            assert tw.layer_flops.dtype == np.float64
            np.testing.assert_array_equal(tw.layer_flops, jw.layer_flops)
            np.testing.assert_array_equal(tw.cut_bytes, jw.cut_bytes)
            for op in range(len(tw.layer_flops) + 1):
                assert tw.device_fraction(op) == jw.device_fraction(op)


def test_slice_profiles_are_the_references():
    for name in ("V5E_PEAK_FLOPS", "V5E_HBM_BPS", "V5E_ICI_BPS", "DCN_BPS"):
        assert getattr(tcm, name) == getattr(jcm, name)
    for chips, mfu in ((8, 0.5), (1, 0.15), (64, 0.5)):
        assert tcm.slice_profile("c", chips, mfu) == \
            tcm.DeviceProfile(*jcm.slice_profile("c", chips, mfu).__dict__
                              .values())
    assert tcm.slice_profile("c", 2, 0.3, jcm.DCN_BPS).bandwidth_bps == \
        jcm.slice_profile("c", 2, 0.3, jcm.DCN_BPS).bandwidth_bps


def test_token_data_is_the_references_exactly():
    stream = tsyn.make_token_stream(5000, 300, seed=3)
    np.testing.assert_array_equal(stream, jsyn.make_token_stream(5000, 300,
                                                                 seed=3))
    for B, S, step in ((2, 32, 0), (2, 32, 7), (1, 100, 123), (4, 63, 9)):
        for got, want in zip(tsyn.batch_tokens(stream, B, S, step),
                             jsyn.batch_tokens(stream, B, S, step)):
            assert got.dtype == want.dtype and got.shape == (B, S)
            np.testing.assert_array_equal(got, want)
    got, want = tsyn.token_dataset(20, 16, 300, 1), \
        jsyn.token_dataset(20, 16, 300, 1)
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
