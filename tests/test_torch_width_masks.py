"""The LM width masks and the flat layout over LM params, in the port
against the JAX package's, for every family's smoke config
(``tests/torch_lm_cases.py`` ``ARCHS``).

Exact: ``SplitProgram.width_mask`` at widths 1.0, 0.5 and 0.25 (a pure
function of the params' structure and shapes), nested across widths;
``HeteroSpec``'s flat mask rows; ``FlatLayout``'s offsets, block padding
and ``block_meta`` against ``repro.fl.flatbuf.layout_of``, its ``flatten``
bitwise the reference's and ``unflatten`` its exact inverse in the
params' nesting.
"""
import jax
import numpy as np
import pytest
import torch

from repro.fl.flatbuf import layout_of as j_layout_of
from repro.fl.hetero import HeteroSpec as JHeteroSpec
from repro.models.split_program import get_split_program as j_program
from repro_torch.fl.flatbuf import FlatLayout
from repro_torch.fl.hetero import HeteroSpec
from repro_torch.models.split_program import SplitProgram, get_split_program
from repro_torch.tree import tree_leaves, tree_structure, tree_unflatten
from torch_lm_cases import ARCHS, configs, params

WIDTHS = (1.0, 0.5, 0.25)


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    jcfg, tcfg = configs(request.param)
    jp, tp = params(jcfg)
    return request.param, jcfg, tcfg, jp, tp


def _same_nesting(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_nesting(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_nesting(x, y)


def test_width_masks_equal_the_reference(family):
    arch, jcfg, tcfg, jp, tp = family
    tprog, jprog = get_split_program(tcfg), j_program(jcfg)
    assert tprog.width_dims() == jprog.width_dims(), arch
    masks = []
    for w in WIDTHS:
        tm = tprog.width_mask(tp, w)
        _same_nesting(tm, tp)
        tl = tree_leaves(tm)
        jl = jax.tree_util.tree_leaves(jprog.width_mask(jp, w))
        assert len(tl) == len(jl) == len(tree_leaves(tp))
        for i, (a, b, p) in enumerate(zip(tl, jl, tree_leaves(tp))):
            assert a.dtype == p.dtype and a.device == p.device
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{arch} w={w} leaf {i}")
        masks.append(tl)
    assert all(float(m.min()) == 1.0 for m in masks[0])     # width 1.0
    # nested: a narrower mask lies within a wider one, and width 0.25
    # really cuts something
    for wide, narrow in zip(masks, masks[1:]):
        for a, b in zip(narrow, wide):
            assert float((a * (1 - b)).sum()) == 0.0
    assert sum(float(m.sum()) for m in masks[2]) < \
        sum(float(m.sum()) for m in masks[1]) < \
        sum(m.numel() for m in masks[0])


def test_hetero_rows_equal_the_reference(family):
    arch, jcfg, tcfg, jp, tp = family
    widths = [0.5, 0.25, 1.0]
    spec = HeteroSpec(get_split_program(tcfg), tp, widths)
    jspec = JHeteroSpec(j_program(jcfg), jp, widths)
    np.testing.assert_array_equal(spec.rows([2, 0, 1]).numpy(),
                                  np.asarray(jspec.rows([2, 0, 1])),
                                  err_msg=arch)
    # the client's start point is the masked params, in their nesting
    applied = spec.apply(tp, 1)
    _same_nesting(applied, tp)
    for a, m, p in zip(tree_leaves(applied), tree_leaves(spec.mask_tree(1)),
                       tree_leaves(tp)):
        torch.testing.assert_close(a, m * p, rtol=0, atol=0)


def test_flat_layout_equals_layout_of(family):
    arch, jcfg, tcfg, jp, tp = family
    tl, jl = FlatLayout(tp), j_layout_of(jp)
    assert (tl.shapes, tl.sizes, tl.segs, tl.offsets, tl.size, tl.padded) \
        == (jl.shapes, jl.sizes, jl.segs, jl.offsets, jl.size, jl.padded)
    assert tl.exact_fp32 and jl.exact_fp32
    for density in (0.1, 0.5):
        np.testing.assert_array_equal(tl.block_meta(density),
                                      np.asarray(jl.block_meta(density)))
    flat = tl.flatten(tp)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jl.flatten(jp)),
                                  err_msg=arch)
    back = tl.unflatten(flat)
    _same_nesting(back, tp)
    for a, b in zip(tree_leaves(back), tree_leaves(tp)):
        assert a.dtype == b.dtype and a.data_ptr() != b.data_ptr()
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_tree_unflatten_keeps_containers():
    tree = {"b": [torch.ones(2), {}], "a": (torch.zeros(1),), "c": {}}
    s = tree_structure(tree)
    out = tree_unflatten(s, [torch.full((1,), 7.0), torch.full((2,), 3.0)])
    _same_nesting(out, tree)
    assert float(out["a"][0]) == 7.0 and float(out["b"][0][1]) == 3.0
    with pytest.raises(ValueError):
        tree_unflatten(s, [torch.ones(1)] * 3)


def test_width_dims_of_the_base_class_is_abstract():
    with pytest.raises(NotImplementedError):
        SplitProgram(None).width_dims()
    with pytest.raises(NotImplementedError):
        SplitProgram(None).width_mask([], 0.5)
