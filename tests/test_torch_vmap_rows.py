"""The vmapped training steps at more than one row: two rows a pod or a
client and a sequence of two CE chunks (S = 2 x 1024), on the CPU at
smoke width, each family cut to one layer (the hybrid keeps its group of
three, whisper one encoder and one decoder layer: the quadratic
attention of the plain versions at S = 2048 sets this file's time).

* every family's vmapped local step (``launch.steps
  .make_local_sync_steps``, P = 2 pods) under ``launch.steps
  .ParamCopyRecorder``: no param is copied per row.  The CE's ``h @
  unembed`` once took matmul's broadcast path there and copied each pod's
  unembedding once a row, a ``(P, B, d, V)`` clone a chunk.  The batched
  fleet engine's vmapped client step (``fl.fleet.client_iterations``) is
  held the same way, dense and SSM, with and without a width mask;
* qwen3's local step at two rows a pod against the reference's
  ``make_local_sync_steps`` (``test_torch_launch_steps.py``'s LOSS_REL
  and PARAM_ATOL), and each pod against ``make_train_step`` on its own
  rows;
* qwen3 on the batched engine at batch 2 and S = 2048
  bit for bit the sequential engine (``torch_fl_cases
  .check_engines_bitwise``);
* ``layers.chunked_ce_loss`` outside a transform bit for bit its earlier
  form (kept here as ``_old_chunked_ce_loss``), loss and gradients, over
  three chunks.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_launch_steps import LOSS_REL, PARAM_ATOL, _assert_trees_close
from torch_fl_cases import check_engines_bitwise

from repro.configs import registry as JR
from repro.launch import steps as JS
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.fl.fleet import client_iterations
from repro_torch.launch import steps as S
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.models.split_program import get_split_program
from repro_torch.tree import tree_leaves, tree_map

FAMILIES = ("qwen3-0.6b", "mixtral-8x22b", "internvl2-2b", "mamba2-780m",
            "recurrentgemma-9b", "whisper-base")
PODS, ROWS, SEQ = 2, 2, 2048


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cut(cfg):
    """The smoke config at one layer (the hybrid: one R, R, L group)."""
    if cfg.family == "hybrid":
        return cfg
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, num_layers=1, encoder_layers=1)
    return dataclasses.replace(cfg, num_layers=1)


def _rows(cfg, lead, seed=1):
    """numpy tokens and next-token labels ``lead + (S_text,)``, every
    seventh label -1, plus the family's frontend stub; S_text + patches =
    SEQ."""
    rng = np.random.RandomState(seed)
    S_text = SEQ - cfg.num_patches if cfg.family == "vlm" else SEQ
    toks = rng.randint(0, cfg.vocab_size, lead + (S_text + 1,)) \
        .astype(np.int32)
    out = {"tokens": toks[..., :-1], "labels": toks[..., 1:].copy()}
    out["labels"][..., ::7] = -1
    if cfg.family == "vlm":
        out["patches"] = rng.randn(*lead, cfg.num_patches,
                                   cfg.d_model).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = (0.1 * rng.randn(*lead, cfg.encoder_seq,
                                         cfg.d_model)).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _local_run(arch):
    """``arch``'s vmapped local step over PODS pods of ROWS rows each, from
    one start, under the recorder: (configs, start params, batch, loss,
    params after, the recorder's copies)."""
    jcfg = _cut(JR.get_smoke_config(arch))
    tcfg = _cut(TR.get_smoke_config(arch))
    tp = api.init(tcfg, 0, device="cpu")
    opt = S.make_opt(tcfg)
    local, _ = S.make_local_sync_steps(tcfg, opt, PODS)
    pp = tree_map(lambda x: torch.stack([x] * PODS), tp)
    oo = tree_map(lambda x: torch.stack([x] * PODS), opt.init(tp))
    b = _rows(tcfg, (PODS, ROWS))
    with S.ParamCopyRecorder(pp) as rec:
        loss, pp2, _ = local(pp, oo, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
    return jcfg, tcfg, tp, b, loss, pp2, rec.copies


@pytest.mark.parametrize("arch", FAMILIES)
def test_local_step_copies_no_param_per_row(arch):
    _, _, tp, _, loss, pp2, copies = _local_run(arch)
    assert copies == [], f"{arch}: {copies}"
    assert loss.shape == (PODS,) and bool(torch.isfinite(loss).all())
    # the step trained: the comparison below is not of the start
    assert max(float((a[0] - b).abs().max())
               for a, b in zip(tree_leaves(pp2), tree_leaves(tp))) > 1e-5


@pytest.mark.parametrize("arch,masked", [("qwen3-0.6b", True),
                                         ("mamba2-780m", False),
                                         ("mamba2-780m", True)])
def test_fleet_client_step_copies_no_param_per_row(arch, masked):
    """Two clients of two rows, one local iteration through the int8 cut
    at an OP inside the model; the recorder watches the clients' stacked
    start, the tree the vmapped gradient takes.  A width mask acts outside
    the vmap (on the start and on the gradient), so the vmapped step is
    the same with and without one: qwen3 runs it once."""
    program = get_split_program(_cut(TR.get_smoke_config(arch)))
    p = program.init_batched(0, 2, device="cpu")
    mask = (program.width_mask(program.init(0, device="cpu"), 0.5)
            if masked else None)
    b = {k: torch.from_numpy(v[:, None])
         for k, v in _rows(program.cfg, (2, ROWS)).items()}
    lr = torch.tensor(0.1)
    with S.ParamCopyRecorder(p) as rec:
        out = client_iterations(program, True, p, b, lr,
                                program.native_op // 2 or 1, mask)
    assert rec.copies == [], f"{arch}: {rec.copies}"
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(out))


def test_two_row_local_step_matches_reference():
    jcfg, tcfg, tp, b, loss, pp2, _ = _local_run("qwen3-0.6b")
    jp = jax.tree_util.tree_map(jnp.asarray, convert.lm_params_to_numpy(tp))
    jopt, topt = JS.make_opt(jcfg), S.make_opt(tcfg)
    jlocal, _ = JS.make_local_sync_steps(jcfg, jopt, PODS)
    jpp = jax.tree_util.tree_map(lambda x: jnp.stack([x] * PODS), jp)
    joo = jax.tree_util.tree_map(lambda x: jnp.stack([x] * PODS),
                                 jopt.init(jp))
    jl, jpp2, _ = jax.jit(jlocal)(jpp, joo, {k: jnp.asarray(v)
                                             for k, v in b.items()})
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), atol=0,
                               rtol=LOSS_REL)
    _assert_trees_close(pp2, jpp2, PARAM_ATOL, 0, "qwen3 two-row local step")
    # each pod is the train step on its own two rows
    for i in range(PODS):
        li, alone, _ = S.make_train_step(tcfg, topt)(
            tp, topt.init(tp), {k: torch.from_numpy(v[i])
                                for k, v in b.items()})
        assert abs(float(li) - float(loss[i])) <= LOSS_REL * abs(float(li))
        for x, y in zip(tree_leaves(pp2), tree_leaves(alone)):
            torch.testing.assert_close(x[i], y, atol=PARAM_ATOL, rtol=0)


def test_batched_engine_at_two_rows_bitwise_sequential():
    check_engines_bitwise("qwen3-0.6b", seq=SEQ, cut=_cut, rounds=1,
                          local_iters=1)


def _old_chunk_loss(h, lab, unembed, cap):
    logits = (h @ unembed).float()
    if cap > 0.0:
        logits = L.softcap(logits, cap)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lab.clamp(min=0).long()[..., None])[..., 0]
    valid = (lab >= 0).float()
    return torch.sum((lse - gold) * valid), torch.sum(valid)


def _old_chunked_ce_loss(hidden, unembed, labels, cap=0.0, chunk=1024):
    """``chunked_ce_loss`` as it was before its chunks were flattened."""
    _, S_, _ = hidden.shape
    chunk = min(chunk, S_)
    total = hidden.new_zeros((), dtype=torch.float32)
    count = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, S_, chunk):
        tl, tc = L.remat(True, _old_chunk_loss, hidden[:, c0:c0 + chunk],
                         labels[:, c0:c0 + chunk], unembed, cap)
        total, count = total + tl, count + tc
    return total / torch.clamp(count, min=1.0)


@pytest.mark.parametrize("B,cap,grad", [(2, 0.0, True), (3, 30.0, True),
                                        (1, 0.0, True), (2, 0.0, False)])
def test_chunked_ce_outside_a_transform_is_its_old_bits(B, cap, grad):
    rng = np.random.RandomState(B)
    h0 = torch.from_numpy(rng.randn(B, 3 * 1024, 64).astype(np.float32))
    u0 = torch.from_numpy(0.1 * rng.randn(64, 256).astype(np.float32))
    lab = torch.from_numpy(rng.randint(-1, 256, (B, 3 * 1024))
                           .astype(np.int32))
    outs = []
    for f in (_old_chunked_ce_loss, L.chunked_ce_loss):
        h, u = h0.clone().requires_grad_(grad), u0.clone().requires_grad_(grad)
        loss = f(h, u, lab, cap)
        outs.append([loss] + (list(torch.autograd.grad(loss, (h, u)))
                              if grad else []))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
