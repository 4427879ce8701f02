"""The port's checkpoints (``repro_torch.checkpoint``, ``fl/state.py``)
against the JAX package's: twins of tests/test_checkpoint.py, the stored
key strings against ``jax.tree_util.tree_flatten_with_path``'s, and files
written by either package restored by the other.

Every comparison is exact (``array_equal`` and equal dtypes): a checkpoint
holds the bits of its leaves, and a restore casts only where the template
asks for another dtype.  Observed: every case bitwise, keys equal in order.
"""
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_tree as j_restore_tree
from repro.checkpoint import save_tree as j_save_tree
from repro.configs.vgg import VGG5 as J_VGG5
from repro.fl.async_loop import _Report as JReport
from repro.fl.cohort import EFStore as JEFStore
from repro.fl.flatbuf import layout_of as j_layout_of
from repro.fl.state import async_state_tree as j_async_tree
from repro.fl.state import base_state_tree as j_base_tree
from repro.models.split_program import get_split_program as j_program
from repro_torch.checkpoint import (CheckpointManager, checkpoint_step,
                                    leaf_shapes, restore_tree, save_tree)
from repro_torch.checkpoint.ckpt import _walk
from repro_torch.convert import vgg_params_from_numpy
from repro_torch.fl.async_loop import _Report
from repro_torch.fl.cohort import EFStore
from repro_torch.fl.flatbuf import FlatLayout
from repro_torch.fl.state import (async_state_tree, base_state_tree,
                                  ef_template_len)



@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for these small runs: test workers running side
    by side then do not oversubscribe the cores (eight threads a worker
    made the files ~20x slower in parallel than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: restores onto the card")
    return torch.device(request.param)


def _tree(device="cpu"):
    g = torch.Generator().manual_seed(0)
    return {
        "params": {"w": torch.randn((8, 8), generator=g).to(device),
                   "layers": [torch.arange(4.0, device=device),
                              torch.ones((2, 3), device=device)]},
        "opt": {"step": torch.tensor(7, dtype=torch.int32, device=device),
                "m": {"w": torch.zeros((8, 8), device=device)}},
    }


def _leaves(tree):
    return [leaf for _, leaf in _walk(tree)]


def _np(leaf):
    return (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf))


# =============================================================================
# twins of tests/test_checkpoint.py
# =============================================================================
def test_roundtrip_bitwise(tmp_path, device):
    tree = _tree(device)
    path = str(tmp_path / "ckpt.npz")
    save_tree(path, tree, step=7)
    restored = restore_tree(path, tree)
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert b.device == a.device and b.dtype == a.dtype
        assert torch.equal(a, b)
    assert checkpoint_step(path) == 7
    assert leaf_shapes(path)["params/layers/1"] == (2, 3)


def test_shape_mismatch_rejected(tmp_path):
    tree = _tree()
    path = str(tmp_path / "ckpt.npz")
    save_tree(path, tree)
    bad = _tree()
    bad["params"]["w"] = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_tree(path, bad)


def test_atomic_save_never_corrupts(tmp_path):
    """A crashed writer's leftover temp file leaves the checkpoint intact:
    saving is a temp file plus ``os.replace``."""
    tree = _tree()
    path = str(tmp_path / "ckpt.npz")
    save_tree(path, tree, step=1)
    before = os.path.getmtime(path)
    with open(str(tmp_path / "garbage.tmp"), "wb") as f:
        f.write(b"partial")
    restored = restore_tree(path, tree)
    assert restored is not None
    assert os.path.getmtime(path) == before
    assert sorted(os.listdir(tmp_path)) == ["ckpt.npz", "garbage.tmp"]


def test_manager_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for step in [1, 2, 3, 4]:
        mgr.save(tree, step)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000003.npz",
                                            "ckpt_00000004.npz"]
    restored, step = mgr.restore_latest(tree)
    assert step == 4
    assert torch.equal(restored["params"]["w"], tree["params"]["w"])
    assert mgr.latest_shapes()["opt/m/w"] == (8, 8)


def test_manager_empty_dir(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    restored, step = mgr.restore_latest(_tree())
    assert restored is None and step is None
    assert mgr.latest_shapes() is None


def test_restore_casts_to_the_template_and_keeps_its_structure(tmp_path,
                                                               device):
    path = str(tmp_path / "ckpt.npz")
    save_tree(path, {"a": [np.arange(3, dtype=np.float64)],
                     "b": (np.int32(5), np.ones(2, np.float32)), "n": None})
    template = {"a": [torch.zeros(3, dtype=torch.float32, device=device)],
                "b": (np.zeros((), np.int64), np.zeros(2, np.float64)),
                "n": None}
    out = restore_tree(path, template)
    assert out["a"][0].dtype == torch.float32
    assert out["a"][0].device == device
    assert torch.equal(out["a"][0].cpu(), torch.arange(3.0))
    assert isinstance(out["b"], tuple) and out["b"][0].dtype == np.int64
    assert out["b"][1].dtype == np.float64 and out["n"] is None
    with pytest.raises(KeyError, match="missing leaf"):
        restore_tree(path, {"c": torch.zeros(1)})


# =============================================================================
# the same trees in both packages, from the same numpy data
# =============================================================================
K, G = 3, 3


def _state(kind):
    """``(jax tree, port tree, port template, jax template)`` of one state
    tree: ``kind`` is ``base`` or ``async`` with ``dense`` or ``sparse``
    error feedback."""
    tree_kind, ef = kind.split("-")
    rng = np.random.RandomState(0)
    jparams = jax.tree_util.tree_map(
        np.asarray, j_program(J_VGG5).init(jax.random.PRNGKey(0)))
    tparams = vgg_params_from_numpy(jparams, device="cpu")
    jlayout = j_layout_of(jparams)
    tlayout = FlatLayout(tparams)
    assert tlayout.padded == jlayout.padded
    padded = tlayout.padded
    ctl = types.SimpleNamespace(
        baselines=rng.rand(K) * 30, G=G,
        prev_actions=rng.rand(G).astype(np.float32))
    if ef == "dense":
        rows = rng.randn(K, padded).astype(np.float32)
        jerr, terr = jnp.asarray(rows), torch.from_numpy(rows.copy())
        terr_t, ef_len = torch.zeros((K, padded)), 0
        jerr_t = jnp.zeros((K, padded))
    else:
        rows = rng.randn(2, padded).astype(np.float32)
        jerr, terr = JEFStore(K, padded), EFStore(K, padded, "cpu")
        jerr.store([2, 0], rows)
        terr.store([2, 0], rows)
        terr_t, jerr_t, ef_len = EFStore(K, padded, "cpu"), jerr, 2
    if tree_kind == "base":
        return (j_base_tree(jparams, jerr, ctl, K),
                base_state_tree(tparams, terr, ctl, K),
                base_state_tree(tparams, terr_t, ctl, K, template=True,
                                ef_len=ef_len),
                j_base_tree(jparams, jerr_t, ctl, K, template=True,
                            ef_len=ef_len))
    deltas = rng.randn(K, padded).astype(np.float32)
    ev = [(1.5, 1, 2, 4, 1.5, 0.25), (2.0, 0, 2, 2, 2.0, 0.5),
          (float("inf"), 2, 1, 3, float("inf"), float("inf"))]
    jev = [(t, JReport(c, v, op, None, d, cm), jnp.asarray(deltas[i]))
           for i, (t, c, v, op, d, cm) in enumerate(ev)]
    tev = [(t, _Report(c, v, op, None, d, cm), torch.from_numpy(deltas[i]))
           for i, (t, c, v, op, d, cm) in enumerate(ev)]
    extra = dict(clock=[2.0, 1.5], times=rng.rand(K), comm=rng.rand(K),
                 ops=[2, 2, 1], loader_state=[(1, 20), (0, 0), (2, 40)])
    return (j_async_tree(jparams, jerr, ctl, K, K, jlayout, events=jev,
                         **extra),
            async_state_tree(tparams, terr, ctl, K, K, tlayout, events=tev,
                             **extra),
            async_state_tree(tparams, terr_t, ctl, K, K, tlayout,
                             template=True, ef_len=ef_len),
            j_async_tree(jparams, jerr_t, ctl, K, K, jlayout, template=True,
                         ef_len=ef_len))


KINDS = ["base-dense", "async-dense", "base-sparse", "async-sparse"]


def _jax_keys(tree):
    return ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("kind", KINDS)
def test_state_tree_keys_and_dtypes_are_the_references(kind):
    jtree, ttree, ttemplate, jtemplate = _state(kind)
    keys = _jax_keys(jtree)
    assert [k for k, _ in _walk(ttree)] == keys
    assert [k for k, _ in _walk(ttemplate)] == _jax_keys(jtemplate) == keys
    for (_, t), j in zip(_walk(ttree), jax.tree_util.tree_leaves(jtree)):
        assert _np(t).dtype == np.asarray(j).dtype
        np.testing.assert_array_equal(_np(t), np.asarray(j))
    assert "params/0/w" in keys
    assert ("controller/baselines" in keys
            and ("async/ev_delta" in keys) == kind.startswith("async")
            and ("ef/ids" in keys) == kind.endswith("sparse"))


def test_vgg5_params_keys_are_the_references():
    jparams = j_program(J_VGG5).init(jax.random.PRNGKey(0))
    tparams = vgg_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    keys = [k for k, _ in _walk(tparams)]
    assert keys == _jax_keys(jparams)
    assert keys[:2] == ["0/b", "0/bn_bias"]


@pytest.mark.parametrize("kind", KINDS)
def test_jax_written_state_restores_bitwise_in_the_port(tmp_path, kind,
                                                        device):
    jtree, _, ttemplate, _ = _state(kind)
    path = str(tmp_path / "ckpt_00000003.npz")
    j_save_tree(path, jtree, step=3)
    ttemplate = jax.tree_util.tree_map(
        lambda x: x.to(device) if isinstance(x, torch.Tensor) else x,
        ttemplate, is_leaf=lambda x: isinstance(x, torch.Tensor))
    if kind.endswith("sparse"):
        assert ef_template_len(leaf_shapes(path)) == 2
    restored = restore_tree(path, ttemplate)
    for (key, t), j in zip(_walk(restored), jax.tree_util.tree_leaves(jtree)):
        if isinstance(t, torch.Tensor):
            assert t.device == device, key
        assert _np(t).dtype == np.asarray(j).dtype, key
        np.testing.assert_array_equal(_np(t), np.asarray(j), err_msg=key)


@pytest.mark.parametrize("kind", KINDS)
def test_port_written_state_restores_bitwise_in_the_reference(tmp_path,
                                                              kind):
    _, ttree, _, jtemplate = _state(kind)
    path = str(tmp_path / "ckpt_00000003.npz")
    save_tree(path, ttree, step=3)
    restored = j_restore_tree(path, jtemplate)
    for (key, t), j in zip(_walk(ttree), jax.tree_util.tree_leaves(restored)):
        assert _np(t).dtype == np.asarray(j).dtype, key
        np.testing.assert_array_equal(np.asarray(j), _np(t), err_msg=key)


def test_async_tree_off_a_boundary_is_refused():
    _, ttree, _, _ = _state("async-dense")
    params = ttree["params"]
    layout = FlatLayout(params)
    ev = [(1.0, _Report(0, 0, 2, None, 1.0, 0.0), torch.zeros(layout.padded))]
    with pytest.raises(AssertionError, match="aggregation boundary"):
        async_state_tree(params, None, None, K, K, layout, clock=[1.0, 0.0],
                         times=np.zeros(K), comm=np.zeros(K), ops=[2] * K,
                         loader_state=[(0, 0)] * K, events=ev)
