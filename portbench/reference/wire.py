"""The server step's compression in plain PyTorch: each leaf's delta,
flattened and padded to blocks of ``BLOCK`` lanes, keeps the ``k``
largest magnitudes of every block (ties to the earlier lane), ``k`` from
the block's true lane count, with error feedback; the kept row crosses
the wire as rowwise int8 over blocks.  What the port's flat-buffer step
states, written again from its rules."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from portbench.reference.common import dequantize_rows, quantize_rows

BLOCK = 1024


def blocks(flat: torch.Tensor) -> torch.Tensor:
    """A flat leaf, zero-padded to whole blocks, as (blocks, BLOCK)."""
    n = flat.numel()
    return torch.nn.functional.pad(flat, (0, (-n) % BLOCK)).view(-1, BLOCK)


def keep_counts(n: int, density: float, device) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """Each block's (valid lanes, kept lanes) for an ``n``-lane leaf: at
    least one lane, ``int(density * valid + 1e-9)`` otherwise."""
    nb = -(-n // BLOCK)
    valid = torch.clamp(n - BLOCK * torch.arange(nb, device=device),
                        max=BLOCK)
    k = torch.clamp((density * valid.double() + 1e-9).long(), min=1)
    return valid, torch.minimum(k, valid)


def top_k(xb: torch.Tensor, valid: torch.Tensor, k: torch.Tensor
          ) -> torch.Tensor:
    """Each row of ``xb`` keeps its ``k`` largest ``|x|`` among its first
    ``valid`` lanes, ties to the earlier lane; the rest become 0."""
    lane = torch.arange(xb.shape[1], device=xb.device)[None]
    mag = torch.where(lane < valid[:, None], xb.abs(),
                      xb.new_full((), float("-inf")))
    kmax = int(k.max())
    thr = torch.topk(mag, kmax, dim=1).values.gather(1, (k - 1)[:, None])
    above = mag > thr
    tie = mag == thr
    room = k[:, None] - above.sum(1, keepdim=True)
    keep = above | (tie & (torch.cumsum(tie, 1) <= room))
    return torch.where(keep, xb, xb.new_zeros(()))


def send(delta: torch.Tensor, error: Optional[torch.Tensor],
         density: float, quantize: bool
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One client's leaf through the wire: ``(sent, new error)`` as
    (blocks, BLOCK) rows.  ``error`` is None without top-k."""
    carried = blocks(delta.reshape(-1))
    if error is not None:
        carried = carried + error
        valid, k = keep_counts(delta.numel(), density, delta.device)
        comp = top_k(carried, valid, k)
    else:
        comp = carried
    sent = dequantize_rows(*quantize_rows(comp)) if quantize else comp
    return sent, (carried - sent if error is not None else None)
