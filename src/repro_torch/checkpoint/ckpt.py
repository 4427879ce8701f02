"""Fault-tolerant checkpointing (counterpart of ``repro/checkpoint/ckpt.py``):
atomic npz save/restore of parameter and state trees.

* Atomic: write to a temp file in the same directory, fsync, then
  ``os.replace``, so a crash mid-save never corrupts the latest checkpoint.
* Interchangeable with the reference: each leaf is stored under the
  ``/``-joined path that ``jax.tree_util.tree_flatten_with_path`` gives it
  (a dict key as itself, a list or tuple index as its number, dict keys in
  sorted order, ``None`` an empty subtree), the step under ``__step__``.
  Either package restores the other's files.
* Tensors leave through ``.detach().cpu().numpy()``; ``restore_tree`` puts
  each leaf back as its template leaf is: shape checked, cast to the
  template's dtype, on the template's device.
* Retention: ``CheckpointManager`` keeps the newest ``keep`` checkpoints.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_unflatten

Tree = Any
_STEP_RE = re.compile(r"ckpt_(\d+)\.npz$")


def _walk(tree: Tree, prefix: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[str, Any]]:
    """``(key path, leaf)`` pairs in the reference's leaf order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _walk(t, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_tree(path: str, tree: Tree, step: Optional[int] = None) -> None:
    payload = {key: _to_numpy(leaf) for key, leaf in _walk(tree)}
    if step is not None:
        payload["__step__"] = np.asarray(step)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _like(arr: np.ndarray, leaf):
    """A stored array as ``leaf`` is: a tensor of its dtype on its device,
    a numpy array of its dtype, or the array itself."""
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
    if hasattr(leaf, "dtype"):
        return arr.astype(leaf.dtype)
    return arr


def restore_tree(path: str, template: Tree) -> Tree:
    with np.load(path) as z:
        stored = {k: z[k] for k in z.files if k != "__step__"}
    leaves = []
    for key, leaf in _walk(template):
        if key not in stored:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = stored[key]
        shape = tuple(leaf.shape if hasattr(leaf, "shape")
                      else np.shape(leaf))
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                             f"vs template {shape}")
        leaves.append(_like(arr, leaf))
    return tree_unflatten(template, leaves)


def leaf_shapes(path: str) -> dict:
    """Shapes of every stored leaf, keyed by ``/``-joined path: the peek
    that sizes a template's variable-shape leaves (the sparse
    ``ef/ids``/``ef/rows`` EF snapshot of ``fl/state.py``) before a strict
    ``restore_tree``."""
    with np.load(path) as z:
        return {k: tuple(z[k].shape) for k in z.files if k != "__step__"}


def checkpoint_step(path: str) -> Optional[int]:
    with np.load(path) as z:
        if "__step__" in z.files:
            return int(z["__step__"])
    return None


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _paths(self) -> List[str]:
        out = []
        for f in os.listdir(self.dir):
            m = _STEP_RE.search(f)
            if m:
                out.append((int(m.group(1)), os.path.join(self.dir, f)))
        return [p for _, p in sorted(out)]

    def save(self, tree: Tree, step: int) -> str:
        path = os.path.join(self.dir, f"ckpt_{step:08d}.npz")
        save_tree(path, tree, step)
        for old in self._paths()[: -self.keep]:
            os.unlink(old)
        return path

    def latest_path(self) -> Optional[str]:
        paths = self._paths()
        return paths[-1] if paths else None

    def restore_latest(self, template: Tree):
        path = self.latest_path()
        if path is None:
            return None, None
        return restore_tree(path, template), checkpoint_step(path)

    def latest_shapes(self) -> Optional[dict]:
        """``leaf_shapes`` of the newest checkpoint (``None`` when the
        directory holds none)."""
        path = self.latest_path()
        return leaf_shapes(path) if path is not None else None
