"""Public names of the reference that the port carries, each against the
reference on the CPU: ``Workload.total_train_flops`` and
``Workload.op_fractions`` (VGG-5 and an LM program's workload, equal);
``vgg.split_loss`` at every cut of VGG-5 from the same weights (the VGG
tests' loss bound, rtol 1e-5: the convolutions sum in another order);
``ClientLoader.__iter__`` (the same batches, byte for byte);
``FleetLoader.loaders`` and ``FleetLoader.materialized`` (the streams
built on first draw, counted as the reference counts them);
``SplitProgram.width_dims`` of every family (VGG's empty set included)
equal to the reference's; ``SplitProgram.init_batched``, each row bit for
bit ``init`` from the seed drawn for it (the reference splits a threefry
key, which the port does not reproduce, so the rows are held to the
port's own ``init``)."""
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.configs.vgg import VGG5 as J_VGG5
from repro.core import costmodel as jcm
from repro.data.loader import ClientLoader as JClientLoader
from repro.data.loader import FleetLoader as JFleetLoader
from repro.models import vgg as jvgg
from repro.models.split_program import get_split_program as j_program
from repro_torch.configs import registry as TR
from repro_torch.configs.vgg import VGG5
from repro_torch.convert import vgg_params_from_numpy
from repro_torch.core import costmodel as tcm
from repro_torch.data.loader import ClientLoader, FleetLoader
from repro_torch.models import vgg as tvgg
from repro_torch.models.split_program import get_split_program
from repro_torch.tree import tree_leaves

LOSS_RTOL = 1e-5


def _workloads():
    yield "vgg5", jcm.vgg_workload(J_VGG5, 100), tcm.vgg_workload(VGG5, 100)
    arch = "qwen3-0.6b"
    yield arch, jcm.program_workload(
        j_program(JR.get_smoke_config(arch)), 2, 64), tcm.program_workload(
        get_split_program(TR.get_smoke_config(arch)), 2, 64)


@pytest.mark.parametrize("case", list(_workloads()), ids=lambda c: c[0])
def test_workload_train_flops_and_op_fractions(case):
    _, j, t = case
    assert t.total_train_flops == j.total_train_flops > 0
    ops = list(range(t.num_layers + 1))
    assert t.op_fractions(ops) == j.op_fractions(ops)
    assert t.op_fractions([]) == [] and t.op_fractions([0])[0] == 0.0


@pytest.mark.parametrize("op_layer", range(len(VGG5.layers) + 1))
def test_vgg_split_loss(op_layer):
    jparams = jvgg.init(J_VGG5, jax.random.PRNGKey(0))
    rng = np.random.RandomState(op_layer)
    b = {"images": rng.randn(4, 32, 32, 3).astype(np.float32),
         "labels": rng.randint(0, 10, 4).astype(np.int32)}
    tparams = vgg_params_from_numpy(
        [{k: np.asarray(v) for k, v in layer.items()} for layer in jparams],
        device="cpu")
    got = tvgg.split_loss(VGG5, tparams, {k: torch.from_numpy(v)
                                          for k, v in b.items()}, op_layer)
    want = jvgg.split_loss(J_VGG5, jparams, b, op_layer)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    # the cut is the whole forward's: the same loss at every layer
    assert torch.allclose(got, tvgg.loss_fn(VGG5, tparams, {
        k: torch.from_numpy(v) for k, v in b.items()}), rtol=1e-6, atol=0)


def _clients(K=4, n=12):
    rng = np.random.RandomState(3)
    return [{"x": rng.randn(n, 2).astype(np.float32),
             "y": rng.randint(0, 5, n).astype(np.int32)} for _ in range(K)]


def test_client_loader_iter():
    data = _clients(1, n=10)[0]
    t, j = ClientLoader(data, 4, seed=5), JClientLoader(data, 4, seed=5)
    for a, b in itertools.islice(zip(iter(t), iter(j)), 7):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k])
    assert t.state() == j.state()


def test_fleet_loader_loaders_and_materialized():
    clients = _clients()
    t = FleetLoader.for_clients(clients, 5, seed=2)
    j = JFleetLoader.for_clients(clients, 5, seed=2)
    assert t.materialized == j.materialized == 0
    for k in (2, 0, 2):
        a, b = t.next_batch(k), j.next_batch(k)
        assert all(np.array_equal(a[key], b[key]) for key in a)
    assert t.materialized == j.materialized == 2
    tl, jl = t.loaders, j.loaders
    assert t.materialized == j.materialized == len(clients)
    assert [ld.state() for ld in tl] == [ld.state() for ld in jl]
    assert tl[2] is t.loaders[2]
    for a, b in zip(tl, jl):
        x, y = a.next_batch(), b.next_batch()
        assert all(np.array_equal(x[key], y[key]) for key in x)


# one config a split program: VGG, dense, MoE, VLM, SSM, hybrid, encdec
PROGRAMS = ("vgg5", "qwen3-0.6b", "mixtral-8x22b", "internvl2-2b",
            "mamba2-780m", "recurrentgemma-9b", "whisper-base")


def _configs(name):
    if name == "vgg5":
        return J_VGG5, VGG5
    return JR.get_smoke_config(name), TR.get_smoke_config(name)


@pytest.mark.parametrize("name", PROGRAMS)
def test_width_dims_match_reference(name):
    jcfg, tcfg = _configs(name)
    j, t = j_program(jcfg), get_split_program(tcfg)
    assert type(t).__name__ == type(j).__name__
    assert t.width_dims() == j.width_dims()
    assert isinstance(t.width_dims(), frozenset)


@pytest.mark.parametrize("name", ["vgg5", "qwen3-0.6b", "mamba2-780m"])
def test_init_batched_rows_are_init(name):
    program = get_split_program(_configs(name)[1])
    stacked = program.init_batched(7, 3, device="cpu")
    # the seeds come from the generator: an integer seed and a generator
    # seeded alike draw the same rows
    again = program.init_batched(torch.Generator().manual_seed(7), 3,
                                 device="cpu")
    seeds = torch.randint(0, 2 ** 31 - 1, (3,),
                          generator=torch.Generator().manual_seed(7))
    rows = [program.init(int(s), device="cpu") for s in seeds]
    for i, row in enumerate(rows):
        for x, y, z in zip(tree_leaves(stacked), tree_leaves(again),
                           tree_leaves(row)):
            assert x.shape == (3,) + tuple(z.shape)
            assert torch.equal(x[i], z) and torch.equal(y[i], z)
    # distinct seeds, distinct rows
    assert not all(torch.equal(x[0], x[1]) for x in tree_leaves(stacked))
