"""The activations the port differentiates give one gradient under every
engine: ``torch.func.grad`` and ``vmap`` of it (the batched fleet engine,
``launch.steps``, the pod pair) equal ``torch.autograd.grad`` (the
sequential engine, the drivers) bit for bit on seeded inputs.

* ``silu`` is ``layers.silu``, a ``torch.autograd.Function`` whose
  backward is aten's fused ``silu_backward``.  ``F.silu`` itself does not
  qualify: ``torch.func.grad`` runs the backward in grad mode, where its
  derivative is the decomposed formula, an ulp apart in about a fifth of
  the lanes (checked below, so the Function's reason stays pinned).
* ``gelu`` (tanh), ``sigmoid``, ``softplus`` (``logaddexp(x, 0)``) and the
  softcap's ``tanh`` agree as PyTorch gives them.
* ``layers.silu`` against ``jax.nn.silu`` and ``jax.grad`` of it within
  1e-6 of the largest entry; it runs under ``no_grad``, on ``meta`` and
  inside ``_Remat``'s ``torch.func.vjp``; no source of the port calls
  another ``silu``.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

PORT = Path(__file__).resolve().parent.parent / "src" / "repro_torch"
JAX_REL = 1e-6
ACTIVATIONS = {
    "silu": L.silu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "softplus": L.softplus,
    "softcap": lambda x: L.softcap(x, 30.0),
}


def _x(shape=(8, 4096), seed=0, scale=4.0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32))


def _autograd(fn, x):
    xa = x.clone().requires_grad_()
    g, = torch.autograd.grad(fn(xa).sum(), xa)
    return g


def _func_grads(fn, x):
    """``torch.func.grad`` over the whole input, and ``vmap`` of it over
    the rows (each row its own loss, as the batched engine's clients)."""
    def loss(t):
        return fn(t).sum()
    return (torch.func.grad(loss)(x),
            torch.func.vmap(torch.func.grad(loss))(x))


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_func_grad_is_autograd_bitwise(name):
    fn = ACTIVATIONS[name]
    x = _x()
    want = _autograd(fn, x)
    assert float(want.abs().max()) > 0
    for got in _func_grads(fn, x):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_f_silu_under_func_grad_rounds_apart():
    x = _x()
    want = _autograd(F.silu, x)
    for got in _func_grads(F.silu, x):
        apart = int((got != want).sum())
        assert apart > x.numel() // 20, apart
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_silu_forward_is_f_silu_bitwise():
    x = _x(seed=1)
    torch.testing.assert_close(L.silu(x), F.silu(x), rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_silu_matches_jax(seed):
    x = _x(seed=seed)
    xj = jnp.asarray(x.numpy())
    want_y = np.asarray(jax.nn.silu(xj))
    want_g = np.asarray(jax.grad(lambda t: jax.nn.silu(t).sum())(xj))
    for got, want in ((L.silu(x).numpy(), want_y),
                      (_autograd(L.silu, x).numpy(), want_g),
                      (_func_grads(L.silu, x)[1].numpy(), want_g)):
        err = float(np.abs(got - want).max()) / float(np.abs(want).max())
        assert err <= JAX_REL, err


def test_silu_under_no_grad_and_on_meta():
    x = _x(seed=2).requires_grad_()
    with torch.no_grad():
        y = L.silu(x)
    assert not y.requires_grad
    m = torch.empty((3, 5), device="meta", requires_grad=True)
    out = L.silu(m)
    assert out.device.type == "meta" and out.shape == (3, 5)
    g, = torch.autograd.grad(out.sum(), m)
    assert g.device.type == "meta" and g.shape == (3, 5)


def test_silu_inside_remat_under_func_grad_and_vmap():
    """A swiglu body through ``_Remat`` (``remat`` under a transform):
    each client's ``torch.func.grad`` equals plain autograd's through
    ``torch.utils.checkpoint`` bit for bit, and vmapped over the clients
    it equals the vmapped gradient without remat bit for bit (a vmapped
    product may sum apart from the loop's, with or without ``silu``)."""
    rng = np.random.RandomState(3)
    n, d, f = 3, 16, 24
    w = {k: torch.from_numpy(rng.randn(n, *s).astype(np.float32) / 4)
         for k, s in (("w_gate", (d, f)), ("w_up", (d, f)),
                      ("w_down", (f, d)))}
    x = torch.from_numpy(rng.randn(n, 5, d).astype(np.float32))

    def loss_of(remat):
        def loss(p, x):
            y = L.remat(remat, lambda x_, p_: L.ffn(p_, x_, "swiglu"), x, p)
            return (y * y).mean()
        return loss
    loss = loss_of(True)
    for c in range(n):
        p = {k: v[c].clone().requires_grad_() for k, v in w.items()}
        want = torch.autograd.grad(loss(p, x[c]), list(p.values()))
        got = torch.func.grad(loss)({k: v[c] for k, v in w.items()}, x[c])
        for k, g in zip(p, want):
            torch.testing.assert_close(got[k], g, rtol=0, atol=0)
    batched = torch.func.vmap(torch.func.grad(loss))(w, x)
    plain = torch.func.vmap(torch.func.grad(loss_of(False)))(w, x)
    for k in w:
        assert float(plain[k].abs().max()) > 0
        torch.testing.assert_close(batched[k], plain[k], rtol=0, atol=0)


def _dotted(f):
    parts = []
    while isinstance(f, ast.Attribute):
        parts.append(f.attr)
        f = f.value
    if isinstance(f, ast.Name):
        parts.append(f.id)
    return ".".join(reversed(parts))


def test_no_other_silu_in_the_port():
    """Every call that names a ``silu`` (``F.silu``, ``nn.SiLU``, aten's
    ops) is ``L.silu``, or in ``layers.py`` the bare ``silu``, the
    Function's ``apply`` and its two aten calls."""
    own = {"silu", "_SiLU.apply", "torch.ops.aten.silu.default",
           "torch.ops.aten.silu_backward.default"}
    found, seen_own = {}, set()
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            if "silu" not in name.lower() or name == "L.silu":
                continue
            if path.name == "layers.py" and name in own:
                seen_own.add(name)
                continue
            found.setdefault(str(path.relative_to(PORT)), []).append(
                (node.lineno, name))
    assert not found, found
    assert seen_own == own
