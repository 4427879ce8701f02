"""Shared set-up of the LM training tests (``test_torch_lm_loss.py``,
``test_torch_split_lm.py``): the smoke configs of the six families in both
packages, the reference's params carried across by ``convert``, and seeded
numpy batches (labels with -1 entries, the VLM's patches, whisper's
frames)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as JR
from repro.models import api as japi
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.tree import tree_leaves

# the smoke configs of every family: gemma2 (softcap, local/global),
# qwen3 (qk-norm, tied), mixtral (MoE, drops at cf 1.25), internvl2 (VLM),
# mamba2 (SSM), recurrentgemma (hybrid; 5 layers: one group and two
# remainder layers) and whisper (encdec)
ARCHS = ("gemma2-2b", "qwen3-0.6b", "mixtral-8x22b", "internvl2-2b",
         "mamba2-780m", "recurrentgemma-9b", "whisper-base")
SEQ = 48


def configs(arch):
    jcfg, tcfg = JR.get_smoke_config(arch), TR.get_smoke_config(arch)
    if arch == "recurrentgemma-9b":
        jcfg = dataclasses.replace(jcfg, num_layers=5)
        tcfg = dataclasses.replace(tcfg, num_layers=5)
    return jcfg, tcfg


def params(jcfg, seed=0):
    """The reference's params and the port's copy on the CPU."""
    jp = japi.init(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    tp = convert.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")
    return jp, tp


def batch(cfg, seed=1, B=2):
    """numpy tokens and next-token labels (B, S_text), a few labels -1,
    plus the family's frontend stub; S_text + patches = SEQ."""
    rng = np.random.RandomState(seed)
    S = SEQ - cfg.num_patches if cfg.family == "vlm" else SEQ
    toks = rng.randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    out["labels"][:, ::7] = -1
    if cfg.family == "vlm":
        out["patches"] = rng.randn(B, cfg.num_patches,
                                   cfg.d_model).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = (0.1 * rng.randn(B, cfg.encoder_seq,
                                         cfg.d_model)).astype(np.float32)
    return out


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _requires_grad(tree):
    if isinstance(tree, dict):
        return {k: _requires_grad(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_requires_grad(t) for t in tree)
    return tree.detach().clone().requires_grad_()


def port_grads(loss, tp):
    """(the port's grads, leaf by leaf in the reference's order) of
    ``loss(params)`` at ``tp``, and the loss."""
    lp = _requires_grad(tp)
    value = loss(lp)
    leaves = tree_leaves(lp)
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, grads)], value


def assert_grads_close(tgrads, jgrads, rel, what):
    """Every leaf within ``rel`` of its largest reference entry (and of
    1e-3, for leaves whose reference gradient is near zero); returns the
    largest error relative to the leaf's max."""
    jl = jax.tree_util.tree_leaves(jgrads)
    assert len(jl) == len(tgrads), what
    worst = 0.0
    for i, (t, j) in enumerate(zip(tgrads, jl)):
        j = np.asarray(j)
        assert t.shape == j.shape, (what, i)
        scale = max(float(np.abs(j).max()), 1e-3)
        err = float(np.abs(t.detach().numpy() - j).max()) / scale
        assert err <= rel, f"{what}: leaf {i} {t.shape} rel err {err}"
        worst = max(worst, err)
    return worst


def check_split_program(arch):
    """Every OP of the family's split program, with and without the int8
    cut: ``loss_through_cut`` and its gradient against the reference's
    program (losses within 1e-6 relative, every leaf within 1e-5 of its
    largest entry), then the cost-model hooks exactly.  Returns the worst
    gradient error."""
    from repro.models.split_program import get_split_program as jget
    from repro_torch.models.split_program import get_split_program as tget
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg)
    b = batch(tcfg)
    jprog, tprog = jget(jcfg), tget(tcfg)
    assert type(tprog).__name__ == type(jprog).__name__
    assert tprog.num_boundaries == jprog.num_boundaries
    assert tprog.op_candidates() == jprog.op_candidates()
    # at the native OP nothing crosses: the quantized run is the plain one
    # in both packages
    cases = [(op, quant) for op in range(tprog.num_boundaries)
             for quant in (False, True)
             if not (quant and op == tprog.native_op)]
    jb = jax_batch(b)

    def every_case(p):
        return [jax.value_and_grad(
            lambda p: jprog.loss_through_cut(p, jb, op, quantize=quant))(p)
            for op, quant in cases]

    # one compile for every case (each its own would compile 2L + 1 times)
    worst = 0.0
    for (op, quant), (jl, jg) in zip(cases, jax.jit(every_case)(jp)):
        tg, tl = port_grads(
            lambda p: tprog.loss_through_cut(p, torch_batch(b), op,
                                             quantize=quant), tp)
        what = f"{arch} op {op} quantize {quant}"
        assert abs(float(tl.detach()) - float(jl)) <= \
            1e-6 * abs(float(jl)), what
        worst = max(worst, assert_grads_close(tg, jg, 1e-5, what))
    with torch.no_grad():
        got = tprog.eval_metric(tp, torch_batch(b))
    want = jprog.eval_metric(jp, jax_batch(b))
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    for B, S in ((1, 32), (3, 4096)):
        np.testing.assert_array_equal(tprog.layer_flops(B, S),
                                      jprog.layer_flops(B, S))
        for op in range(tprog.num_boundaries):
            for quant in (False, True):
                for per in (2, 4):
                    assert tprog.cut_bytes(op, B, S, per, quant) == \
                        jprog.cut_bytes(op, B, S, per, quant)
    return worst
