"""The port's mesh-sharded flat buffer and server step
(``ShardedFlatLayout``, ``ShardedServerStep``, ``topk_compress_rows``)
against its single-device step and the JAX reference's, on VGG-5's layout
with K = 5 seeded delta rows.

* ``data = 1`` meshes ((1, 1), (1, 2), (1, 8)): bitwise the port's
  single-device step in the new global, the EF rows and ``reduce``: every
  op is block-local and the shards are whole blocks.  At (2, 4) the five
  rows pad to six and the two data shards' partial sums add in another
  order: within 1e-6 (atol; values of order 1e-2..1).
* Against the JAX reference's single-device step (which its own tests hold
  equal to its ``shard_map`` step, bitwise at ``data = 1`` and within 1e-6
  above): what each client sent has the same nonzero pattern, and the
  values agree within 1e-6, the bounds ``tests/test_torch_flatbuf.py``
  holds.
* The tail: (1, 8) pads VGG-5's 580 blocks with 4; their metadata rows are
  ``(0, 1)``, every place receives ``shard_elems`` distinct lanes, and the
  tail stays zero in the global and the EF rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.fl.flatbuf import FlatLayout as JFlatLayout
from repro.fl.flatbuf import ServerStep as JServerStep
from repro.configs.vgg import VGG5 as J_VGG5
from repro.models import vgg as jvgg
from repro_torch.configs.vgg import VGG5
from repro_torch.convert import vgg_params_from_numpy
from repro_torch.fl.flatbuf import (
    FlatLayout,
    ServerStep,
    ShardedFlatLayout,
    ShardedServerStep,
    get_root_step,
    get_server_step,
    layout_of,
)
from repro_torch.fl.hierarchy import hierarchical_apply
from repro_torch.kernels.topk_compress import (
    topk_compress_flat,
    topk_compress_rows,
)
from repro_torch.models.split_program import get_split_program
from repro_torch.parallel.sharding import make_flat_mesh
from repro_torch.tree import tree_map

CPU8 = [torch.device("cpu")] * 8
K = 5
MODES = [(1.0, False), (0.05, False), (0.05, True)]
MESHES = [(1, 1), (1, 2), (1, 8), (2, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: test workers running side by side then do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    """VGG-5's params (the reference's init, both sides), the base
    layouts, K seeded delta and EF rows and the client weights."""
    jparams = jvgg.init(J_VGG5, jax.random.PRNGKey(0))
    tparams = vgg_params_from_numpy(
        [{k: np.asarray(v) for k, v in layer.items()} for layer in jparams],
        device="cpu")
    base, jbase = FlatLayout(tparams), JFlatLayout(jparams)
    rng = np.random.RandomState(1)
    g = base.flatten(tparams)
    lanes = (g != 0).numpy() | (np.arange(base.padded) % 7 == 0)
    deltas = (rng.randn(K, base.padded) * 1e-2 * lanes).astype(np.float32)
    errors = (rng.randn(K, base.padded) * 1e-3 * lanes).astype(np.float32)
    weights = list(np.arange(1, K + 1, dtype=np.float64))
    return dict(tparams=tparams, jparams=jparams, base=base, jbase=jbase,
                g=g, deltas=torch.from_numpy(deltas),
                errors=torch.from_numpy(errors), weights=weights)


_JAX_STEPS = {}


def _reference_step(case, density, quant):
    """The reference's single-device step on the case's inputs, once per
    mode."""
    if (density, quant) not in _JAX_STEPS:
        track = density < 1
        jstep = JServerStep(case["jbase"], density=density, quantize=quant)
        _JAX_STEPS[density, quant] = jstep(
            jnp.asarray(case["g"].numpy()),
            jnp.asarray(case["deltas"].numpy()), case["weights"],
            jnp.asarray(case["errors"].numpy()) if track else None)
    return _JAX_STEPS[density, quant]


def _mesh(shape):
    return make_flat_mesh(shape, devices=CPU8)


def _pad(x, tail):
    return F.pad(x, (0, tail)) if tail else x


# =============================================================================
# dispatch
# =============================================================================
def test_layout_and_step_dispatch(case):
    params = case["tparams"]
    plain = layout_of(params)
    assert type(plain) is FlatLayout
    assert type(get_split_program(VGG5).flat_layout(params)) is FlatLayout
    assert type(get_server_step(plain, 0.5, True)) is ServerStep
    lay = get_split_program(VGG5).flat_layout(params, mesh=_mesh((1, 1)))
    assert type(lay) is ShardedFlatLayout and lay.tail == 0
    assert type(get_server_step(lay, 1.0, False)) is ShardedServerStep
    with pytest.raises(TypeError, match="ShardedFlatLayout"):
        ShardedServerStep(plain)


# =============================================================================
# the battery: every mesh x (density, quantize)
# =============================================================================
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("density,quant", MODES)
def test_sharded_step_matches_single_device_and_reference(case, shape,
                                                          density, quant):
    base, n = case["base"], case["base"].padded
    lay = layout_of(case["tparams"], mesh=_mesh(shape))
    track = density < 1
    g, d0, e0, w = case["g"], case["deltas"], case["errors"], case["weights"]
    assert torch.equal(lay.flatten(case["tparams"])[:n], g)
    ref = ServerStep(base, density, quant)
    rg, re = ref(g, d0, w, e0 if track else None)
    ra, _, rae = ref.reduce(d0, w, e0 if track else None)
    step = get_server_step(lay, density, quant)
    d, e = _pad(d0, lay.tail), _pad(e0, lay.tail) if track else None
    sg, se = step(_pad(g, lay.tail), d, w, e)
    sa, sden, sae = step.reduce(d, w, e)
    assert sden is None
    outs = [(sg[:n], rg), (sa[:n], ra)]
    if track:
        outs += [(se[:, :n], re), (sae[:, :n], rae)]
    else:
        assert se is None and sae is None
    for got, want in outs:
        if shape[0] == 1:
            assert torch.equal(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-6)
    # the tail stays zero
    if lay.tail:
        assert not sg[n:].any() and not sa[n:].any()
        if track:
            assert not se[:, n:].any()
    # against the reference's single-device step
    jg, jerr = _reference_step(case, density, quant)
    np.testing.assert_allclose(sg[:n].numpy(), np.asarray(jg), rtol=0,
                               atol=1e-6)
    if track:
        carried = (d0 + e0).numpy()
        np.testing.assert_array_equal(carried - se[:, :n].numpy() != 0,
                                      carried - np.asarray(jerr) != 0)
        np.testing.assert_allclose(se[:, :n].numpy(), np.asarray(jerr),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(1, 8), (2, 4)])
def test_masked_and_tiered_steps_over_the_mesh(case, shape):
    """Width-mask rows (the even clients cover every lane, the odd ones
    miss every third lane) through the sharded step, and two edges through
    ``hierarchical_apply`` (``reduce`` on the mesh): bitwise the
    single-device step at data = 1, within 1e-6 above."""
    base, n = case["base"], case["base"].padded
    lay = layout_of(case["tparams"], mesh=_mesh(shape))
    g, d0, e0, w = case["g"], case["deltas"], case["errors"], case["weights"]
    masks = torch.ones(K, n)
    masks[1::2, 1::3] = 0.0
    ref, step = ServerStep(base, 0.05, True), get_server_step(lay, 0.05,
                                                               True)
    got = step(_pad(g, lay.tail), _pad(d0, lay.tail), w, _pad(e0, lay.tail),
               masks=_pad(masks, lay.tail))
    want = ref(g, d0, w, e0, masks=masks)
    tiered = hierarchical_apply(step, get_root_step(lay), _pad(g, lay.tail),
                                _pad(d0, lay.tail), w, _pad(e0, lay.tail),
                                num_edges=2)
    flat_tiered = hierarchical_apply(ref, get_root_step(base), g, d0, w, e0,
                                     num_edges=2)
    assert tiered[2] == flat_tiered[2] == 2
    for (ga, ea), (gb, eb) in ((got, want), (tiered[:2], flat_tiered[:2])):
        for a, b in ((ga[:n], gb), (ea[:, :n], eb)):
            if shape[0] == 1:
                assert torch.equal(a, b)
            else:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                           atol=1e-6)


# =============================================================================
# the tail and the per-shard lanes
# =============================================================================
def test_tail_masked_and_lanes_per_place(case, monkeypatch):
    """(1, 8) over VGG-5's 580 blocks: 4 tail blocks with (0, 1) metadata;
    each place's rows are views of its ``shard_elems`` distinct lanes,
    top-k and the int8 pair run once per (padded row, model shard), and
    the tail stays zero in the global and the EF rows."""
    base, n = case["base"], case["base"].padded
    lay = layout_of(case["tparams"], mesh=_mesh((1, 8)))
    assert lay.tail == 4 * lay.block and lay.padded == n + lay.tail
    assert lay.padded % (lay.block * 8) == 0
    assert lay.shard_elems * 8 == lay.padded and lay.base_padded == n
    meta = lay.block_meta(0.05)
    assert meta.shape[0] == lay.padded // lay.block
    np.testing.assert_array_equal(meta[-4:], [[0, 1]] * 4)
    np.testing.assert_array_equal(meta[:-4], base.block_meta(0.05))
    g = lay.flatten(case["tparams"])
    assert g.shape == (lay.padded,) and not g[n:].any()
    stacked = lay.flatten_stacked(tree_map(
        lambda v: v[None].expand(2, *v.shape), case["tparams"]))
    assert stacked.shape == (2, lay.padded) and not stacked[:, n:].any()

    seen = []
    send = ShardedServerStep._send

    def spy(self, d, e, m, meta):
        seen.append((d.storage_offset() % lay.padded, d.numel(),
                     d.device, meta.shape[0]))
        return send(self, d, e, m, meta)

    monkeypatch.setattr(ShardedServerStep, "_send", spy)
    step = get_server_step(lay, 0.05, True)
    d = _pad(case["deltas"][:3], lay.tail)
    sg, se = step(g, d, [1.0] * 3, torch.zeros(3, lay.padded))
    assert len(seen) == 3 * 8
    starts = sorted({s for s, _, _, _ in seen})
    assert starts == [j * lay.shard_elems for j in range(8)]
    assert {(num, nb) for _, num, _, nb in seen} == {
        (lay.shard_elems, lay.shard_elems // lay.block)}
    assert {dev for _, _, dev, _ in seen} == {torch.device("cpu")}
    assert not sg[n:].any() and not se[:, n:].any()


def test_pad_rows_run_through_the_wire(case, monkeypatch):
    """(2, 4) with K = 5: six padded rows a model shard, the pad row at
    zero weight; its EF row is dropped."""
    lay = layout_of(case["tparams"], mesh=_mesh((2, 4)))
    calls = []
    send = ShardedServerStep._send
    monkeypatch.setattr(ShardedServerStep, "_send",
                        lambda self, *a: calls.append(1) or send(self, *a))
    step = get_server_step(lay, 0.05, True)
    _, se = step(lay.flatten(case["tparams"]), case["deltas"],
                 case["weights"], case["errors"])
    assert len(calls) == 6 * 4 and se.shape == (K, lay.padded)


@pytest.mark.parametrize("model", [2, 8])
def test_topk_compress_rows_is_the_slice_of_the_full_call(case, model):
    lay = layout_of(case["tparams"], mesh=_mesh((1, model)))
    meta = torch.from_numpy(lay.block_meta(0.1))
    row = _pad(case["deltas"][:2] + case["errors"][:2], lay.tail)
    full = topk_compress_flat(row.contiguous(), meta, lay.block)
    S, nbs = lay.shard_elems, lay.shard_elems // lay.block
    kmax = int(meta[:, 1].max())
    for j in range(model):
        part = topk_compress_rows(row[:, j * S:(j + 1) * S].contiguous(),
                                  meta[j * nbs:(j + 1) * nbs], kmax,
                                  lay.block)
        assert torch.equal(part, full[:, j * S:(j + 1) * S])
