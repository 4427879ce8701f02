"""The port's LM training loss against the JAX reference.

``layers.chunked_ce_loss`` and ``layers.moe_aux_loss`` on seeded numpy
inputs, and every family's ``loss_fn`` (through ``api.loss``) with its
gradient on the smoke configs (``torch_lm_cases``), from the reference's
params carried across by ``convert``: gemma2 (softcap, local and global
layers), qwen3 (qk-norm, tied embeddings), mixtral (MoE at capacity factor
1.25, with its aux term), internvl2 (VLM, labels -1 over the patches),
mamba2 (SSM), recurrentgemma (hybrid, a group and two remainder layers)
and whisper (encdec).  On the CPU every attention takes the flash
Function's plain versions and the SSD scan its plain, differentiable
version.

Tolerances: losses within 1e-6 relative (observed <= 1.6e-7); every
gradient leaf within 1e-5 of its largest entry (observed <= 2.3e-6): fp32
matmuls and reductions sum in other orders in each framework.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_lm_cases import (ARCHS, assert_grads_close, batch, configs,
                            jax_batch, params, port_grads, torch_batch)

from repro.configs.mixtral_8x22b import smoke_config as j_mixtral
from repro.models import api as japi
from repro.models import layers as JL
from repro_torch.configs.mixtral_8x22b import smoke_config as t_mixtral
from repro_torch.models import api as tapi
from repro_torch.models import layers as TL

LOSS_REL = 1e-6
GRAD_REL = 1e-5


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_chunked_ce_loss_and_gradient(cap):
    """Several chunks (S = 64 in chunks of 16), -1 labels, the softcap."""
    rng = np.random.RandomState(0)
    h = rng.randn(2, 64, 32).astype(np.float32)
    w = (rng.randn(32, 300) / np.sqrt(32)).astype(np.float32)
    lab = rng.randint(0, 300, (2, 64)).astype(np.int32)
    lab[:, ::5] = -1
    jl, (jgh, jgw) = jax.value_and_grad(
        lambda a, b: JL.chunked_ce_loss(a, b, jnp.asarray(lab), cap,
                                        chunk=16), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    tl = TL.chunked_ce_loss(th, tw, torch.from_numpy(lab), cap, chunk=16)
    gh, gw = torch.autograd.grad(tl, (th, tw))
    assert _rel(tl.detach(), jl) <= LOSS_REL
    assert_grads_close([gh, gw], [jgh, jgw], GRAD_REL, "chunked_ce")
    with pytest.raises(ValueError, match="divisible"):
        TL.chunked_ce_loss(th[:, :60], tw, torch.from_numpy(lab[:, :60]),
                           chunk=16)


def test_moe_aux_loss_and_gradient():
    jcfg, tcfg = j_mixtral(), t_mixtral()
    rng = np.random.RandomState(2)
    x = rng.randn(2, 24, tcfg.d_model).astype(np.float32)
    router = (rng.randn(tcfg.d_model, tcfg.moe.num_experts)
              / 8).astype(np.float32)
    jl, (jgx, jgr) = jax.value_and_grad(
        lambda a, r: JL.moe_aux_loss(jcfg, {"router": r}, a),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(router))
    tx, tr = (torch.from_numpy(a).requires_grad_() for a in (x, router))
    tl = TL.moe_aux_loss(tcfg, {"router": tr}, tx)
    assert _rel(tl.detach(), jl) <= LOSS_REL
    assert_grads_close(list(torch.autograd.grad(tl, (tx, tr))), [jgx, jgr],
                       GRAD_REL, "moe_aux_loss")


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    jcfg, tcfg = configs(request.param)
    jp, tp = params(jcfg)
    return request.param, jcfg, tcfg, jp, tp, batch(tcfg)


def test_family_loss_and_gradient_match_reference(family):
    arch, jcfg, tcfg, jp, tp, b = family
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: japi.loss(jcfg, p, jax_batch(b))))(jp)
    tg, tl = port_grads(lambda p: tapi.loss(tcfg, p, torch_batch(b)), tp)
    assert tapi.get_model(tcfg).loss_fn is not None
    assert _rel(tl.detach(), jl) <= LOSS_REL, arch
    assert all(bool(torch.isfinite(g).all()) for g in tg)
    assert_grads_close(tg, jg, GRAD_REL, arch)


def test_remat_changes_nothing_but_memory(family):
    """``cfg.remat`` recomputes each layer (group) in the backward: the loss
    and every gradient are bitwise those of the run that keeps the
    activations."""
    arch, _, tcfg, _, tp, b = family
    off = dataclasses.replace(tcfg, remat=False)
    g_on, l_on = port_grads(lambda p: tapi.loss(tcfg, p, torch_batch(b)), tp)
    g_off, l_off = port_grads(lambda p: tapi.loss(off, p, torch_batch(b)),
                              tp)
    assert tcfg.remat and torch.equal(l_on, l_off), arch
    assert all(torch.equal(a, c) for a, c in zip(g_on, g_off)), arch
    with torch.no_grad():                    # serving: no checkpoint at all
        assert torch.equal(tapi.loss(tcfg, tp, torch_batch(b)), l_on.detach())
