"""The port's mesh and sharding rules (``repro_torch.parallel.sharding``)
against the JAX reference's (``repro.parallel.sharding``): the mesh's
validation and messages, the flat buffer's shard tail, the client chunk
padding, ``AxisRules.resolve``'s divisibility fallback, the active-rules
context, ``activation_spec`` and ``param_pspecs`` over every registry
config's smoke params, and the collectives.

The reference's rules read only ``mesh.shape``; its meshes here are stubs
of that shape (tests see one JAX device).  Specs are compared as tuples,
leaf by leaf under the ``/``-joined path ``tree_flatten_with_path`` gives.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_smoke_config as j_smoke
from repro.models import api as japi
from repro.parallel import sharding as J
from repro_torch.configs.registry import ARCH_NAMES, get_smoke_config
from repro_torch.models import api
from repro_torch.parallel import sharding as T

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: test workers running side by side then do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stub(data=16, model=16, pod=0):
    shape = {"data": data, "model": model}
    if pod:
        shape = {"pod": pod, **shape}
    return SimpleNamespace(shape=shape)


# =============================================================================
# the mesh
# =============================================================================
def test_make_flat_mesh_validation_and_messages():
    for bad in ((2,), (0, 4), (2, 4, 1)):
        with pytest.raises(ValueError, match="two positive ints"):
            T.make_flat_mesh(bad, devices=CPU8)
    # more places than given: the message names the devices= argument
    with pytest.raises(ValueError, match="devices="):
        T.make_flat_mesh((2, 4), devices=CPU8[:3])
    with pytest.raises(ValueError, match="devices="):
        T.make_flat_mesh((64, 64), devices=CPU8)


def test_default_places_on_the_cpu_are_one_device():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default places are cards")
    mesh = T.make_flat_mesh((1, 1))
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.home == torch.device("cpu") and mesh.n_devices == 1
    assert T.default_places("cpu") == [torch.device("cpu")]
    # no silent fallback to fewer places
    with pytest.raises(ValueError, match="devices="):
        T.make_flat_mesh((2, 1))


def test_mesh_over_repeated_places():
    mesh = T.make_flat_mesh((2, 4), devices=CPU8)
    assert mesh.shape == {"data": 2, "model": 4}
    assert list(mesh.shape) == ["data", "model"]
    assert mesh.size == 8 and mesh.n_devices == 1
    assert mesh.home == torch.device("cpu")
    assert mesh.devices.shape == (2, 4)
    coords = list(mesh.coords())
    assert coords[0] == {"data": 0, "model": 0}
    assert coords[5] == {"data": 1, "model": 1}
    assert mesh.place(coords[5]) == torch.device("cpu")
    # the first data * model places, in order
    mixed = T.make_flat_mesh((1, 2), devices=["cpu", "meta", "cpu"])
    assert [d.type for d in mixed.devices.flat] == ["cpu", "meta"]
    assert mixed.n_devices == 2


# =============================================================================
# the pure helpers, against the reference's
# =============================================================================
def test_flat_shard_tail_values():
    assert T.flat_shard_tail(593920, 1024, 8) == 4096   # vgg5: 580 % 8 = 4
    assert T.flat_shard_tail(593920, 1024, 1) == 0
    assert T.flat_shard_tail(593920, 1024, 4) == 0      # 580 % 4 = 0
    # qwen3-0.6b's flat buffer: 582,081 blocks, 582,081 % 4 = 1
    assert T.flat_shard_tail(596050944, 1024, 4) == 3 * 1024
    for padded, block, model in ((593920, 1024, 8), (4096, 1024, 3),
                                 (1024 * 7, 1024, 16), (512, 512, 2)):
        assert T.flat_shard_tail(padded, block, model) == \
            J.flat_shard_tail(padded, block, model)
    with pytest.raises(ValueError, match="block-aligned"):
        T.flat_shard_tail(1000, 1024, 2)


def test_client_chunk_pad_values():
    assert T.client_chunk_pad(5, 1) == 0
    assert T.client_chunk_pad(5, 2) == 1
    assert T.client_chunk_pad(8, 2) == 0
    assert T.client_chunk_pad(1, 8) == 7
    assert T.client_chunk_pad(0, 4) == 0
    for n in range(10):
        for data in (1, 2, 3, 8):
            assert T.client_chunk_pad(n, data) == J.client_chunk_pad(n, data)
    with pytest.raises(ValueError):
        T.client_chunk_pad(5, 0)


def _rules_both(data=16, model=16, pod=0):
    stub = _stub(data, model, pod)
    batch = tuple(a for a in ("pod", "data") if a in stub.shape)
    return (T.AxisRules(mesh=stub, batch=batch),
            J.AxisRules(mesh=stub, batch=batch))


def test_resolve_divisibility_fallback():
    tr, jr = _rules_both()
    assert tr.resolve("tp", 1024) == "model"
    assert tr.resolve("tp", 56) is None           # arctic heads: replicate
    assert tr.resolve("batch", 256) == "data"
    assert tr.resolve("batch", 1) is None
    tp, jp = _rules_both(pod=2)
    assert tp.resolve("batch", 256) == ("pod", "data")
    assert tp.resolve("batch", 16) is None        # 16 % 32 != 0
    for (t, j) in ((tr, jr), (tp, jp)):
        for name in ("batch", "fsdp", "tp", "experts", "vocab", "cache_seq",
                     "seq", "none", "unknown"):
            for dim in (None, 1, 16, 56, 256, 1024):
                assert t.resolve(name, dim) == j.resolve(name, dim), \
                    (name, dim)


@pytest.mark.parametrize("kw", [dict(), dict(fsdp=False), dict(tp=False),
                                dict(seq_shard=True),
                                dict(extra={"heads": ("model",)})])
@pytest.mark.parametrize("pod", [0, 2])
def test_make_axis_rules_matches_reference(kw, pod):
    stub = _stub(4, 2, pod)
    t, j = T.make_axis_rules(stub, **kw), J.make_axis_rules(stub, **kw)
    for field in ("batch", "fsdp", "tp", "seq_shard", "cache_seq",
                  "logical"):
        assert getattr(t, field) == getattr(j, field), field
    # a port mesh of repeated places gives the same rules as its shape
    if not pod:
        mesh = T.make_flat_mesh((4, 2), devices=CPU8)
        r = T.make_axis_rules(mesh, **kw)
        assert (r.batch, r.fsdp, r.tp) == (t.batch, t.fsdp, t.tp)
        assert r.axis_size(("data", "model")) == 8


def test_use_rules_nests_and_restores():
    a = T.make_axis_rules(_stub(2, 2))
    b = T.make_axis_rules(_stub(1, 4))
    assert T.current_rules() is None
    with T.use_rules(a):
        assert T.current_rules() is a
        with T.use_rules(b):
            assert T.current_rules() is b
        assert T.current_rules() is a
        assert T.activation_spec(("batch", "seq", "tp"), (8, 32, 64)) == \
            tuple(J.activation_spec(("batch", "seq", "tp"), (8, 32, 64),
                                    rules=J.make_axis_rules(_stub(2, 2))))
    assert T.current_rules() is None
    assert T.activation_spec(("batch",)) == ()


# =============================================================================
# param_pspecs over every registry config's smoke params
# =============================================================================
def _port_specs(specs, params):
    """``{path: spec}`` of a port spec tree, walked as its params."""
    out = {}

    def walk(s, p, prefix):
        if isinstance(p, dict):
            for k in p:
                walk(s[k], p[k], prefix + (str(k),))
        elif isinstance(p, (list, tuple)):
            for i, v in enumerate(p):
                walk(s[i], v, prefix + (str(i),))
        else:
            out["/".join(prefix)] = s
    walk(specs, params, ())
    return out


def _jax_specs(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in flat}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_pspecs_match_reference(arch):
    tparams = api.init(get_smoke_config(arch), 0, device="cpu")
    jshapes = jax.eval_shape(lambda: japi.init(
        j_smoke(arch), jax.random.PRNGKey(0), jnp.float32))
    for data, model, pod, fsdp in ((16, 16, 0, True), (2, 4, 0, False),
                                   (4, 2, 2, True), (1, 8, 0, True)):
        stub = _stub(data, model, pod)
        trules = T.make_axis_rules(stub, fsdp=fsdp)
        jrules = J.make_axis_rules(stub, fsdp=fsdp)
        got = _port_specs(T.param_pspecs(tparams, trules), tparams)
        want = _jax_specs(J.param_pspecs(jshapes, jrules))
        assert got == want
        # every sharded dim divides its mesh axes; stacked layers never
        for path, spec in got.items():
            shape = tuple(_leaf(tparams, path).shape)
            assert len(spec) == len(shape)
            if "layers" in path.split("/"):
                assert spec[0] is None
            for dim, ax in zip(shape, spec):
                if ax is not None:
                    assert dim % trules.axis_size(
                        (ax,) if isinstance(ax, str) else ax) == 0


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def test_param_pspecs_shard_the_flat_mesh_params():
    """A real port mesh: the specs a placement over distinct cards would
    use (``SplitProgram.shard_params``' rules: tp over model, no fsdp)."""
    tparams = api.init(get_smoke_config("qwen3-0.6b"), 0, device="cpu")
    mesh = T.make_flat_mesh((2, 4), devices=CPU8)
    specs = T.param_pspecs(tparams, T.make_axis_rules(mesh, fsdp=False,
                                                      tp=True))
    wq = specs["layers"]["attn"]["wq"]
    assert wq[0] is None and len(wq) == 3 and "data" not in wq


# =============================================================================
# the collectives
# =============================================================================
def test_collectives_fixed_order():
    rng = np.random.RandomState(0)
    parts = [torch.from_numpy(rng.randn(4, 6).astype(np.float32))
             for _ in range(3)]
    want = (parts[0] + parts[1]) + parts[2]
    assert torch.equal(T.psum(parts), want)
    assert T.psum(parts[:1]) is parts[0]
    assert torch.equal(T.all_gather(parts, dim=1), torch.cat(parts, 1))
    tiles = T.psum_scatter(parts, 1, [torch.device("cpu")] * 3)
    assert [tuple(t.shape) for t in tiles] == [(4, 2)] * 3
    assert torch.equal(torch.cat(tiles, 1), want)
