"""The port's flat-buffer layout and server step against the JAX
reference's, on identical weights, deltas, error-feedback rows and client
weights (made with numpy from a seed).

``flatten`` is a pure layout: bitwise equal.  The server step is compared
for (density, quantize) in {(1,F), (1,T), (0.25,F), (0.25,T)}: the nonzero
pattern of what each client sent is exact (top-k keep masks and int8 codes
do not depend on summation order), while the new global and the new EF rows
agree to fp32 tolerance (atol 1e-6 on values of order 1e-2..1): both sides
accumulate ``acc + w_i * sent`` in client order, but XLA may fuse the
multiply-add or reorder the plain ``w @ deltas`` matvec.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.vgg import VGG5 as J_VGG5
from repro.fl.fedavg import model_bytes as j_model_bytes
from repro.fl.flatbuf import FlatLayout as JFlatLayout
from repro.fl.flatbuf import ServerStep as JServerStep
from repro.models import vgg as jvgg
from repro_torch.convert import vgg_params_from_numpy, vgg_params_to_numpy
from repro_torch.fl.flatbuf import FlatLayout, ServerStep, model_bytes


@pytest.fixture(scope="module")
def carried():
    jparams = jvgg.init(J_VGG5, jax.random.PRNGKey(3))
    np_params = [{k: np.asarray(v) for k, v in layer.items()}
                 for layer in jparams]
    return jparams, vgg_params_from_numpy(np_params, device="cpu")


def test_flatten_is_bitwise_the_reference_buffer(carried):
    jparams, tparams = carried
    jl, tl = JFlatLayout(jparams), FlatLayout(tparams)
    assert (tl.padded, tl.size) == (jl.padded, jl.size) == (593_920, 582_346)
    assert tl.offsets == jl.offsets and tl.shapes == jl.shapes
    np.testing.assert_array_equal(
        tl.flatten(tparams).numpy().view(np.int32),
        np.asarray(jl.flatten(jparams)).view(np.int32))
    np.testing.assert_array_equal(tl.block_meta(0.1), jl.block_meta(0.1))
    assert model_bytes(tparams) == j_model_bytes(jparams) == 4 * 582_346
    # exact inverse, in the reference's per-layer layout
    back = vgg_params_to_numpy(tl.unflatten(tl.flatten(tparams)))
    for bl, jlay in zip(back, jparams):
        assert sorted(bl) == sorted(jlay)
        for k in bl:
            np.testing.assert_array_equal(bl[k], np.asarray(jlay[k]))


@pytest.mark.parametrize("density,quantize", [(1.0, False), (1.0, True),
                                              (0.25, False), (0.25, True)])
def test_server_step_matches_reference(carried, density, quantize):
    jparams, tparams = carried
    jl, tl = JFlatLayout(jparams), FlatLayout(tparams)
    K, n = 3, tl.padded
    rng = np.random.RandomState(int(density * 100) + quantize)
    g = np.asarray(jl.flatten(jparams))
    mask = (g != 0) | (np.arange(n) % 7 == 0)           # leaf lanes, roughly
    deltas = (rng.randn(K, n) * 1e-2 * mask).astype(np.float32)
    errors = (rng.randn(K, n) * 1e-3 * mask).astype(np.float32)
    weights = [20.0, 30.0, 50.0]
    track = density < 1

    jstep = JServerStep(jl, density=density, quantize=quantize)
    jg, jerr = jstep(jnp.asarray(g), jnp.asarray(deltas), weights,
                     jnp.asarray(errors) if track else None)
    tstep = ServerStep(tl, density=density, quantize=quantize)
    tg, terr = tstep(torch.from_numpy(g.copy()), torch.from_numpy(deltas),
                     weights, torch.from_numpy(errors) if track else None)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    if track:
        # what each client sent is carried - new_err: same nonzero pattern
        carried_rows = deltas + errors
        jsent = carried_rows - np.asarray(jerr)
        tsent = carried_rows - terr.numpy()
        np.testing.assert_array_equal(tsent != 0, jsent != 0)
        np.testing.assert_allclose(terr.numpy(), np.asarray(jerr),
                                   atol=1e-6, rtol=0)
    else:
        assert terr is None and jerr is None
