"""Activation remat under ``torch.func`` (``models.layers.remat``), on the
CPU at the smoke configs of every family: dense (gemma2, qwen3), MoE
(mixtral, its capacity factor E / k so that nothing drops), VLM
(internvl2), SSM (mamba2), hybrid (recurrentgemma, one group and two
remainder layers) and encdec (whisper).

* ``torch.func.vmap(torch.func.grad(loss_through_cut))`` over 2 clients
  at an interior OP with the int8 cut: every gradient leaf with
  ``cfg.remat`` on bit for bit the one with it off, but encdec's encoder
  leaves (``ENC_REL`` of their leaf's max: under remat the encoder
  output's gradient is summed a decoder layer at a time, as the
  reference's scan transpose sums it, without remat in one running sum
  over every layer's terms); each rematerialised body runs twice a layer
  (the forward and its recompute), as under plain autograd, and once
  without remat; the kernels' entries (flash's and the SSD scan's
  ``_forward`` and backward passes) never see a batched tensor, which
  the card's kernels could not take, and the forward kernels run twice as
  often as without remat, the backward ones as often; the recompute's
  cotangents carry no graph at the levels around it (``torch.func.grad``
  differentiates with create_graph, which would otherwise keep every
  layer's recomputed intermediates to the end of the backward).
* Plain autograd: ``torch.utils.checkpoint`` (what ``remat`` keeps there)
  against ``layers.remat_apply`` (the ``torch.func`` path): bit for bit
  but for encdec's encoder leaves, within ``ENC_REL`` for the same reason.
* ``run_federated`` on lm16m through the batched engine: the same history
  and params with ``cfg.remat`` on and off.
* ``make_local_sync_steps`` at lm16m with remat: on the CPU, each body
  twice a layer and the pods' params bit for bit the run without remat;
  on ``meta``, the real run's shapes, nothing launched.
"""
import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch_lm_cases import ARCHS, batch, configs, torch_batch

from repro_torch.configs.lm_small import LM16M
from repro_torch.data import split_clients, token_dataset
from repro_torch.fl.loop import FLConfig, run_federated
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ssd_scan as SD
from repro_torch.launch import steps as S
from repro_torch.models import encdec, hybrid, ssm, transformer
from repro_torch.models import layers as L
from repro_torch.models.split_program import get_split_program
from repro_torch.tree import tree_leaves, tree_map

OP = 1
# encdec's encoder leaves: one running sum of 2 x layers terms against a
# sum a layer; read 2.8e-7 of a leaf's max on the CPU
ENC_REL = 1e-6
# the rematerialised bodies a family's loss runs, each by its module
BODIES = {"dense": ((transformer, "_block"),),
          "moe": ((transformer, "_block"),),
          "vlm": ((transformer, "_block"),),
          "ssm": ((ssm, "block"),),
          "hybrid": ((hybrid, "_group"),),
          "encdec": ((encdec, "_enc_layer"), (encdec, "_dec_layer"))}
# the kernels' entries: the forward's and the backward's
FORWARDS = ((FA, "_forward"), (SD, "_forward"))
BACKWARDS = ((FA, "attention_bwd_dq_plain"),
             (FA, "attention_bwd_dkdv_plain"), (SD, "ssd_scan_bwd_plain"))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, remat=True):
    _, cfg = configs(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    return dataclasses.replace(cfg, remat=remat)


def _layers_run(cfg):
    """Each body's calls in one forward without remat."""
    if cfg.family == "encdec":
        return {"_enc_layer": cfg.encoder_layers, "_dec_layer":
                cfg.num_layers}
    if cfg.family == "hybrid":
        return {"_group": cfg.num_layers // len(cfg.layer_pattern)}
    return {BODIES[cfg.family][0][1]: cfg.num_layers}


@pytest.fixture
def counted(monkeypatch):
    """Counts the bodies' and the kernels' calls (``calls``), and fails on
    a batched tensor at a kernel's entry."""
    calls = collections.Counter()

    def wrap(mod, name, kernel):
        fn = getattr(mod, name)

        def counting(*args, **kwargs):
            if kernel:
                assert not any(
                    isinstance(a, torch.Tensor)
                    and torch._C._functorch.is_batchedtensor(a)
                    for a in args), f"{mod.__name__}.{name}: batched input"
            calls[(mod.__name__.rsplit(".", 1)[-1], name)] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, counting)
    for mod, name in {b for bodies in BODIES.values() for b in bodies}:
        wrap(mod, name, False)
    wrap(L, "_chunk_loss", False)
    for mod, name in FORWARDS + BACKWARDS:
        wrap(mod, name, True)
    backward = L._Remat.backward

    def recorded(ctx, *grads):
        out = backward(ctx, *grads)
        calls["graph"] += sum(isinstance(g, torch.Tensor) and g.requires_grad
                              for g in out)
        return out
    monkeypatch.setattr(L._Remat, "backward", staticmethod(recorded))
    return calls


def _bodies(calls):
    """The bodies' calls by name (the kernels' left out)."""
    kernels = {(m.__name__.rsplit(".", 1)[-1], f)
               for m, f in FORWARDS + BACKWARDS}
    return {k[1]: n for k, n in calls.items()
            if k != "graph" and k not in kernels}


def _kernels(calls, entries):
    keys = {(m.__name__.rsplit(".", 1)[-1], f) for m, f in entries}
    return sum(n for k, n in calls.items() if k in keys)


def _clients(cfg):
    """Two clients' batches, stacked on a leading axis."""
    bs = [torch_batch(batch(cfg, seed=s)) for s in (1, 2)]
    return bs, {k: torch.stack([b[k] for b in bs]) for k in bs[0]}


def _vmapped_grads(cfg, params, stacked):
    program = get_split_program(cfg)

    def loss(p, b):
        return program.loss_through_cut(p, b, OP, quantize=True)
    pp = tree_map(lambda v: v.expand(2, *v.shape).clone(), params)
    return tree_leaves(torch.func.vmap(torch.func.grad(loss))(pp, stacked))


def _paths(tree, prefix=""):
    """Each leaf's path, in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in _paths(t, f"{prefix}/{i}")]
    return [prefix]


def _assert_grads(cfg, got, want, paths, what):
    for path, g, w in zip(paths, got, want):
        if cfg.family == "encdec" and path.startswith("/enc_"):
            torch.testing.assert_close(
                g, w, rtol=0, atol=ENC_REL * float(w.abs().max()),
                msg=f"{what}: {path}")
        else:
            assert torch.equal(g, w), f"{what}: {path}"


@pytest.mark.parametrize("arch", ARCHS)
def test_vmapped_grad_with_remat_is_the_grad_without(arch, counted):
    cfg = _cfg(arch)
    params = get_split_program(cfg).init(0, device="cpu")
    _, stacked = _clients(cfg)
    counted.clear()
    on = _vmapped_grads(cfg, params, stacked)
    calls_on = dict(counted)
    counted.clear()
    off = _vmapped_grads(dataclasses.replace(cfg, remat=False), params,
                         stacked)
    calls_off = dict(counted)
    _assert_grads(cfg, on, off, _paths(params), f"{arch} vmap(grad)")
    once = _layers_run(cfg)
    # the CE chunk is rematerialised whatever cfg.remat says: twice always
    chunk = {"_chunk_loss": 2}
    assert _bodies(calls_on) == {**{k: 2 * n for k, n in once.items()},
                                 **chunk}
    assert _bodies(calls_off) == {**once, **chunk}
    # the recompute is not recorded at the levels around it: the
    # torch.func.grad outside runs its backward with create_graph, and a
    # recorded recompute would hold every layer's intermediates (on the
    # card, qwen3-0.6b's batched step at 4096 tokens ran out of memory)
    assert calls_on.get("graph", 0) == 0
    fwd_on = _kernels(calls_on, FORWARDS)
    fwd_off = _kernels(calls_off, FORWARDS)
    assert fwd_off > 0 and fwd_on == 2 * fwd_off
    assert _kernels(calls_on, BACKWARDS) == \
        _kernels(calls_off, BACKWARDS) > 0
    # plain autograd (torch.utils.checkpoint) runs each body as often
    counted.clear()
    program = get_split_program(cfg)
    p = tree_map(lambda v: v.detach().clone().requires_grad_(), params)
    bs, _ = _clients(cfg)
    torch.autograd.grad(program.loss_through_cut(p, bs[0], OP,
                                                 quantize=True),
                        tree_leaves(p), allow_unused=True)
    assert _bodies(counted) == _bodies(calls_on)


def _plain_grads(cfg, params, b):
    program = get_split_program(cfg)
    p = tree_map(lambda v: v.detach().clone().requires_grad_(), params)
    loss = program.loss_through_cut(p, b, OP, quantize=True)
    return loss, torch.autograd.grad(loss, tree_leaves(p),
                                     allow_unused=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_apply_is_checkpoint_under_plain_autograd(arch, monkeypatch):
    cfg = _cfg(arch)
    params = get_split_program(cfg).init(0, device="cpu")
    (b, _), _ = _clients(cfg)
    ckpt_loss, ckpt = _plain_grads(cfg, params, b)

    def through_function(enabled, fn, *args):
        if enabled and torch.is_grad_enabled():
            return L.remat_apply(fn, *args)
        return fn(*args)
    monkeypatch.setattr(L, "remat", through_function)
    loss, got = _plain_grads(cfg, params, b)
    assert torch.equal(loss, ckpt_loss)
    pairs = [(g, w) for g, w in zip(got, ckpt) if w is not None]
    assert len(pairs) == sum(g is not None for g in got)
    paths = [p for p, w in zip(_paths(params), ckpt) if w is not None]
    _assert_grads(cfg, [g for g, _ in pairs], [w for _, w in pairs], paths,
                  f"{arch} plain autograd")


def test_remat_apply_carries_trees_and_constants():
    """Trees of tensors and non-tensor leaves through ``remat_apply``
    under ``vmap(grad)``: every tensor leaf gets its gradient, a
    non-floating one none, and a floating output the caller drops hands
    the vjp zeros."""
    def body(x, p, scale, idx):
        y = (x @ p["w"] + p["b"][idx]) * scale
        return y.sum(), (x * 0).sum() + 1.0

    def loss(x, p, idx, remat):
        fn = (lambda *a: L.remat_apply(body, *a)) if remat else body
        return fn(x, p, 2.0, idx)[0]
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(3, 4, 5).astype(np.float32))
    p = {"w": torch.from_numpy(rng.randn(5, 6).astype(np.float32)),
         "b": torch.from_numpy(rng.randn(4, 6).astype(np.float32))}
    idx = torch.tensor([3, 0, 1, 2])
    got, want = (torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)),
                                 in_dims=(0, None, None, None))(
        x, p, idx, remat) for remat in (True, False))
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(g, w)


def _lm16m_run(remat, engine="batched"):
    cfg = dataclasses.replace(LM16M, remat=remat)
    clients = split_clients(token_dataset(8, 16, cfg.vocab_size, seed=0), 2)
    test = token_dataset(2, 16, cfg.vocab_size, seed=9)
    fl = FLConfig(rounds=2, local_iters=2, batch_size=2, lr=0.1,
                  augment=False, mode="sfl", static_op=3, engine=engine,
                  quantize_transfer=True)
    init = get_split_program(cfg).init(0, "cpu")
    return run_federated(cfg, clients, test, fl, init_params=init,
                         device="cpu")


def test_batched_run_federated_same_with_remat_on_and_off(counted):
    on = _lm16m_run(True)
    blocks_on = counted[("transformer", "_block")]
    counted.clear()
    off = _lm16m_run(False)
    blocks_off = counted[("transformer", "_block")]
    # 2 rounds x 2 local iterations of one chunk, plus an eval a round
    steps, evals = 4 * LM16M.num_layers, 2 * LM16M.num_layers
    assert (blocks_on, blocks_off) == (2 * steps + evals, steps + evals)
    for key in ("ops", "times", "round_time", "comm_time", "dropped",
                "accuracy"):
        assert np.array_equal(np.asarray(on[key]), np.asarray(off[key])), \
            key
    for x, y in zip(tree_leaves(on["params"]), tree_leaves(off["params"])):
        assert torch.equal(x, y)


def _pod_inputs(cfg, device):
    opt = S.make_opt(cfg)
    params = get_split_program(cfg).init(0, device=device)
    rng = np.random.RandomState(4)
    toks = rng.randint(0, cfg.vocab_size, (2, 1, 17)).astype(np.int64)
    b = {"tokens": torch.from_numpy(toks[..., :-1]).to(device),
         "labels": torch.from_numpy(toks[..., 1:]).to(device)}
    pp = tree_map(lambda v: torch.stack([v, v]), params)
    oo = tree_map(lambda v: torch.stack([v, v]), opt.init(params))
    return opt, pp, oo, b


def test_local_sync_steps_with_remat_on_cpu(counted):
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(LM16M, remat=remat)
        opt, pp, oo, b = _pod_inputs(cfg, "cpu")
        local, sync = S.make_local_sync_steps(cfg, opt, 2)
        counted.clear()
        loss, pp2, _ = local(pp, oo, b)
        out[remat] = (loss, pp2, counted[("transformer", "_block")])
    assert out[True][2] == 2 * out[False][2] == 2 * LM16M.num_layers
    assert torch.equal(out[True][0], out[False][0])
    for x, y in zip(tree_leaves(out[True][1]), tree_leaves(out[False][1])):
        assert torch.equal(x, y)
    synced = sync(out[True][1])
    for x, y in zip(tree_leaves(synced), tree_leaves(out[True][1])):
        assert torch.equal(x[0], (y[0] + y[1]) * 0.5)


def test_local_sync_steps_with_remat_on_meta(counted):
    opt, pp, oo, b = _pod_inputs(LM16M, "cpu")
    real = S.make_local_sync_steps(LM16M, opt, 2)[0](pp, oo, b)
    meta = tree_map(lambda v: torch.empty(v.shape, dtype=v.dtype,
                                          device="meta"), (pp, oo, b))
    counted.clear()
    before = dict(LAUNCHES)
    abstract = S.make_local_sync_steps(LM16M, opt, 2)[0](*meta)
    assert dict(LAUNCHES) == before
    assert counted[("transformer", "_block")] == 2 * LM16M.num_layers
    for got, want in zip(tree_leaves(abstract), tree_leaves(real)):
        assert got.device.type == "meta"
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
