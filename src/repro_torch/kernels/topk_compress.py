"""Block-local top-k delta sparsification (counterpart of
``repro/kernels/topk_compress``), used by the server step's error-feedback
compression.

A flat buffer is tiled into blocks of ``block`` lanes; each block carries a
``(valid, k)`` pair: lanes ``>= valid`` are padding and never selected, and
``k`` is the keep budget from the block's true element count
(``density_block_meta``, copied verbatim from the reference with its
``+1e-9`` and int truncation).  Within a block the ``k`` largest ``|x|`` are
kept, ties going to the earlier lane; everything else becomes 0.
``topk_compress_flat`` is the kernel wrapper (``csrc/topk_compress.cu``,
whose header proves the selection rule equal to the reference's);
``topk_blocks_plain`` is the same function in plain PyTorch.

``topk_compress_density`` and ``compress_tree`` are the per-leaf entry
points of the reference server step: each leaf is its own buffer (a leaf
smaller than a block is one short block), one kernel launch a leaf, and
``compress_tree`` carries the error feedback (``carried = leaf + error``,
the new error ``carried - kept``).
"""
from __future__ import annotations

import ctypes
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.tree import tree_map, tree_unzip

_SIGNATURES = {
    "repro_topk_blocks": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p),
}


def _lib():
    return _build.load("topk_compress", _SIGNATURES)


def keep_count(density: float, valid: int) -> int:
    """Per-block keep budget from the true element count: at least one entry
    always survives (a leaf never vanishes from the update)."""
    return max(1, min(int(valid), int(density * valid + 1e-9)))


def density_block_meta(n: int, block: int, density: float) -> np.ndarray:
    """(ceil(n/block), 2) int32 rows of ``(valid, k)`` for an ``n``-element
    buffer tiled into fixed-size blocks (the last block may be partial)."""
    nb = -(-n // block)
    valid = np.minimum(block, n - block * np.arange(nb, dtype=np.int64))
    k = np.maximum(1, np.minimum(
        valid, (density * valid + 1e-9).astype(np.int64)))
    return np.stack([valid, k], axis=1).astype(np.int32)


def topk_blocks_plain(xb: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """``xb`` (nb, block) fp32, ``meta`` (nb, 2) int rows of (valid, k).
    A lane's position in the stable descending sort of its block's valid
    magnitudes is its rank; ranks below ``k`` are kept."""
    nb, block = xb.shape
    lane = torch.arange(block, device=xb.device)[None]
    valid = meta[:, :1].to(torch.int64)
    ks = meta[:, 1:].to(torch.int64)
    mag = torch.where(lane < valid, xb.abs(), xb.new_full((), float("-inf")))
    order = torch.sort(mag, dim=1, descending=True, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(1, order, lane.expand(nb, block).contiguous())
    keep = (rank < ks) & (lane < valid)
    return torch.where(keep, xb, xb.new_zeros(()))


def topk_compress_flat(buf: torch.Tensor,
                       meta: Union[torch.Tensor, np.ndarray],
                       block: int = 1024) -> torch.Tensor:
    """Top-k over a flat-buffer batch: ``buf`` (R, n) fp32 contiguous with
    ``n % block == 0``; ``meta`` the ``(n/block, 2)`` int32 ``(valid, k)``
    table of ONE row (every row shares the layout)."""
    if buf.dim() != 2 or buf.dtype != torch.float32 or \
            not buf.is_contiguous():
        raise ValueError(f"topk_compress_flat takes a contiguous 2-D float32 "
                         f"buffer, got {buf.dtype} {tuple(buf.shape)}")
    R, n = buf.shape
    if not 0 < block <= 1024 or n % block:
        raise ValueError(f"row length {n} must be a multiple of block "
                         f"{block}, and 0 < block <= 1024")
    nb = n // block
    meta = torch.as_tensor(meta, dtype=torch.int32, device=buf.device)
    if meta.shape != (nb, 2) or not meta.is_contiguous():
        raise ValueError(f"meta {tuple(meta.shape)} != ({nb}, 2)")
    if not _build.wants_kernel(buf, "topk_compress_flat"):
        return topk_blocks_plain(buf.view(R * nb, block),
                                 meta.repeat(R, 1)).view(R, n)
    out = torch.empty_like(buf)
    if buf.numel() == 0:
        return out
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        _build.check_launch(_lib().repro_topk_blocks(
            buf.data_ptr(), meta.data_ptr(), out.data_ptr(), R * nb, nb,
            block, stream), "topk_compress_flat")
    LAUNCHES["topk_compress"] += 1
    return out


def topk_compress_density(x: torch.Tensor, density: float,
                          block: int = 1024) -> torch.Tensor:
    """Every block of ``x`` (flattened, fp32, padded to blocks of
    ``min(block, numel)``) keeps ``max(1, int(density * true lanes))``
    entries; same shape and dtype out."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    b = min(block, n)
    flat = F.pad(flat, (0, (-n) % b))
    out = topk_compress_flat(flat[None], density_block_meta(n, b, density),
                             b)[0]
    return out[:n].reshape(x.shape).to(x.dtype)


def compress_tree(tree: Any, error: Optional[Any], density: float = 0.01,
                  block: int = 1024) -> Tuple[Any, Any]:
    """Error-feedback top-k over every leaf: ``(kept tree, new error
    tree)``, the per-block budget from each leaf's true size."""

    def one(leaf, err):
        carried = leaf.to(torch.float32) + (
            0.0 if err is None else err.to(torch.float32))
        comp = topk_compress_density(carried, density, block)
        return comp.to(leaf.dtype), carried - comp

    if error is None:
        pairs = tree_map(lambda leaf: one(leaf, None), tree)
    else:
        pairs = tree_map(one, tree, error)
    return tree_unzip(pairs, 0), tree_unzip(pairs, 1)
