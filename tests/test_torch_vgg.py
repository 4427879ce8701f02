"""The port's VGG and split program against the JAX reference, from the
same (carried) weights and the same numpy batch.

Tolerances: loss rtol 1e-5 and gradients atol 1e-5 (rtol 1e-4).  Both sides
compute in fp32 on the CPU, but the convolutions and matrix products sum in
another order (XLA's kernels vs PyTorch's), so agreement is to fp32
rounding, not bitwise.

With ``quantize`` on, the cut activation crosses as int8, and a
rounding-level difference in the client half can move an element across a
code boundary: it then differs by a whole quantization step (observed: a
few of 32768 elements, moving some gradient entries by ~1e-3).  So the
int8 path is held to the tolerances above on a shared cut: the reference's
cut activation goes through both sides' fake-quant and server half (the
codes are then equal, as the kernel tests show), comparing the loss, the
server-side gradients and the straight-through gradient of the cut.  The
whole ``loss_through_cut(quantize=True)`` is compared too, at rtol 1e-4 on
the loss, with code flips limited to 1e-3 of the cut's elements.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.vgg import VGG5 as J_VGG5, VGG8 as J_VGG8
from repro.models import vgg as jvgg
from repro.models.split_program import get_split_program as j_program
from repro_torch.configs.vgg import VGG5, VGG8
from repro_torch.convert import vgg_params_from_numpy
from repro_torch.fl.flatbuf import tree_leaves
from repro_torch.models import vgg as tvgg
from repro_torch.models.split_program import get_split_program

CONFIGS = {"vgg5": (J_VGG5, VGG5), "vgg8": (J_VGG8, VGG8)}


@functools.lru_cache(maxsize=None)
def _reference_params(name, seed):
    return jvgg.init(CONFIGS[name][0], jax.random.PRNGKey(seed))


def _setup(name, batch=4, seed=0):
    jcfg, tcfg = CONFIGS[name]
    jparams = _reference_params(name, seed)
    rng = np.random.RandomState(seed)
    b = {"images": rng.randn(batch, 32, 32, 3).astype(np.float32),
         "labels": rng.randint(0, 10, batch).astype(np.int32)}
    tparams = vgg_params_from_numpy(
        [{k: np.asarray(v) for k, v in layer.items()} for layer in jparams],
        device="cpu")
    return jcfg, tcfg, jparams, tparams, b


def test_config_and_cost_hooks_equal_reference():
    for name, (jcfg, tcfg) in CONFIGS.items():
        assert tcfg == tcfg.__class__(**jcfg.__dict__)
        assert tvgg.layer_flops(tcfg) == jvgg.layer_flops(jcfg)
        assert tvgg.op_flops_fraction(tcfg) == jvgg.op_flops_fraction(jcfg)
        for i in range(len(tcfg.layers)):
            assert tvgg.activation_bytes(tcfg, i) == \
                jvgg.activation_bytes(jcfg, i)
        jp, tp = j_program(jcfg), get_split_program(tcfg)
        assert tp.native_op == jp.native_op
        for op in range(tp.num_boundaries):
            for quant in (False, True):
                assert tp.cut_bytes(op, 100, quantize=quant) == \
                    jp.cut_bytes(op, 100, quantize=quant)


def test_init_has_reference_shapes_and_scales():
    tparams = tvgg.init(VGG5, torch.Generator().manual_seed(0), device="cpu")
    jparams = _reference_params("vgg5", 0)
    for tl, jl in zip(tparams, jparams):
        assert sorted(tl) == sorted(jl)
        for k in tl:
            assert tuple(tl[k].shape) == jl[k].shape
            assert tl[k].dtype == torch.float32
    w = tparams[5]["w"]                          # FC1: 8*8*64 -> 128
    assert abs(float(w.std()) * np.sqrt(4096) - 1.0) < 0.05


def _port_params(tparams):
    """Fresh leaf tensors that require grad, and the params built on them."""
    leaves = [v.clone().requires_grad_() for v in tree_leaves(tparams)]
    it = iter(leaves)
    return leaves, [{k: next(it) for k in sorted(layer)} for layer in tparams]


def _assert_grads_close(tgrads, jgrads):
    for tg, jg in zip(tgrads, jax.tree_util.tree_leaves(jgrads)):
        tg = np.zeros(jg.shape, np.float32) if tg is None else tg.numpy()
        np.testing.assert_allclose(tg, np.asarray(jg), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("name", ["vgg5", "vgg8"])
def test_loss_and_grads_at_every_op(name):
    jcfg, tcfg, jparams, tparams, b = _setup(name)
    jprog, tprog = j_program(jcfg), get_split_program(tcfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    for op in (0, *tcfg.ops):
        jloss, jgrads = jax.value_and_grad(
            lambda p: jprog.loss_through_cut(p, jb, op))(jparams)
        leaves, params = _port_params(tparams)
        tloss = tprog.loss_through_cut(params, tb, op)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
        _assert_grads_close(torch.autograd.grad(tloss, leaves), jgrads)


@pytest.mark.parametrize("name", ["vgg5", "vgg8"])
def test_int8_cut_loss_and_grads_at_every_op(name):
    from repro.kernels.quant_transfer.ops import fake_quant_int8 as jfq
    from repro_torch.kernels.quant_transfer import fake_quant_int8 as tfq
    jcfg, tcfg, jparams, tparams, b = _setup(name)
    jprog, tprog = j_program(jcfg), get_split_program(tcfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    for op in tcfg.ops[:-1]:                  # every OP that ships a cut
        # the server half on a shared cut
        jacts = jprog.client_forward(jparams, jb, op)
        jloss, (jgp, jga) = jax.value_and_grad(
            lambda p, a: jprog.server_forward(p, jfq(a), jb, op),
            argnums=(0, 1))(jparams, jacts)
        leaves, params = _port_params(tparams)
        acts = torch.tensor(np.asarray(jacts), requires_grad=True)
        tloss = tprog.server_forward(params, tfq(acts), tb, op)
        *tgp, tga = torch.autograd.grad(tloss, leaves + [acts],
                                        allow_unused=True)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
        _assert_grads_close(tgp, jgp)
        np.testing.assert_allclose(tga.numpy(), np.asarray(jga),
                                   atol=1e-5, rtol=1e-4)
        # the whole loss through the int8 cut
        jfull = jprog.loss_through_cut(jparams, jb, op, quantize=True)
        with torch.no_grad():
            tfull = tprog.loss_through_cut(tparams, tb, op, quantize=True)
            tacts = tprog.client_forward(tparams, tb, op)
        np.testing.assert_allclose(tfull.item(), float(jfull), rtol=1e-4)
        from repro.kernels.quant_transfer.ops import quantize as jquant
        from repro_torch.kernels.quant_transfer import quantize as tquant
        flips = (tquant(tacts)[0].numpy()
                 != np.asarray(jquant(jacts, interpret=True)[0])).mean()
        assert flips < 1e-3


def test_eval_uses_batch_statistics():
    """Accuracy normalizes with the test batch's own statistics, as the
    reference does: logits equal to fp32 rounding."""
    jcfg, tcfg, jparams, tparams, b = _setup("vgg5", batch=16)
    jl = np.asarray(jvgg.forward(jcfg, jparams, jnp.asarray(b["images"])))
    tl = tvgg.forward(tcfg, tparams, torch.from_numpy(b["images"])).numpy()
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=1e-5)
    assert float(tvgg.accuracy(tcfg, tparams,
                               {k: torch.from_numpy(v) for k, v in b.items()})
                 ) == float(jvgg.accuracy(jcfg, jparams, b))
