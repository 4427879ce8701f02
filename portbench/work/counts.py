"""Frozen copies of the port's written kernel counts, the yardstick of the
roofline metrics.

They are copies, not imports: a later change to the program may rewrite
its own counts, and the benchmark's bounds must not move with it.  The
originals are ``repro_torch.kernels.flash_attention`` (``visible_pairs``,
``flash_attention_work``, ``flash_attention_bwd_dq_work``,
``flash_attention_bwd_dkdv_work``) and ``repro_torch.kernels.ssd_scan``
(``_ssd_terms``, ``ssd_scan_work``, ``ssd_scan_bwd_work``).  Each count is
``{"flops", "matmul_flops", "bytes_accessed", "transcendentals"}`` for one
call at the given operand shapes.
"""
from __future__ import annotations

import functools
from typing import Dict


def work(flops: float, matmul_flops: float, nbytes: float,
         transcendentals: float) -> Dict[str, float]:
    return {"flops": float(flops), "matmul_flops": float(matmul_flops),
            "bytes_accessed": float(nbytes),
            "transcendentals": float(transcendentals)}


@functools.lru_cache(maxsize=256)
def visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs a causal / windowed mask leaves visible."""
    n = 0
    for i in range(Sq):
        hi = min(i, Sk - 1) if causal else Sk - 1
        lo = max(0, i - window + 1) if window > 0 else 0
        n += max(0, hi - lo + 1)
    return n


def flash_attention_work(q, k, causal: bool = False, window: int = 0,
                         itemsize: int = 4, lse: bool = False,
                         softcap: float = 0.0) -> Dict[str, float]:
    """The forward at q ``(B, Sq, H, D)``, k ``(B, Sk, KV, D)``: QK^T and
    PV over the visible pairs, the softmax's elementwise work, q, k, v
    read and the output (and the lse) written once."""
    B, Sq, H, D = q
    Sk, KV = k[1], k[2]
    pairs = B * H * visible_pairs(Sq, Sk, bool(causal), int(window))
    capped = softcap > 0
    return work(4 * pairs * D + (4 + 2 * capped) * pairs + B * Sq * H * D,
                4 * pairs * D,
                itemsize * 2 * (B * Sq * H * D + B * Sk * KV * D)
                + (4 * B * H * Sq if lse else 0),
                (1 + capped) * pairs + (B * H * Sq if lse else 0))


def flash_attention_bwd_dq_work(q, k, causal: bool = False, window: int = 0,
                                softcap: float = 0.0) -> Dict[str, float]:
    """The backward's dP = dO V^T and dQ = dS K over the visible pairs."""
    B, Sq, H, D = q
    Sk, KV = k[1], k[2]
    pairs = B * H * visible_pairs(Sq, Sk, bool(causal), int(window))
    capped = softcap > 0
    return work(4 * pairs * D + (3 + 3 * capped) * pairs + 2 * B * Sq * H * D,
                4 * pairs * D,
                4 * (4 * B * Sq * H * D + 2 * B * Sk * KV * D
                     + 2 * B * H * Sq),
                (1 + capped) * pairs)


def flash_attention_bwd_dkdv_work(q, k, causal: bool = False,
                                  window: int = 0, softcap: float = 0.0
                                  ) -> Dict[str, float]:
    """The backward's dV = P^T dO and dK = dS^T Q over the visible
    pairs."""
    B, Sq, H, D = q
    Sk, KV = k[1], k[2]
    pairs = B * H * visible_pairs(Sq, Sk, bool(causal), int(window))
    capped = softcap > 0
    return work(4 * pairs * D + (4 + 3 * capped) * pairs, 4 * pairs * D,
                4 * (2 * B * Sq * H * D + 4 * B * Sk * KV * D
                     + 2 * B * H * Sq),
                (1 + capped) * pairs)


def ssd_terms(x, N: int, chunk: int):
    """(products, elementwise, transcendentals) of the chunked SSD
    forward at x ``(B, S, H, P)``, each chunk's causal half of C.B^T and of
    the decay-weighted product with x, the entering and the chunk's own
    state terms."""
    B, S, H, P = x
    Q = min(chunk, S)
    prod = elem = trans = 0
    for s0 in range(0, S, Q):
        q = min(Q, S - s0)
        t = q * (q + 1) // 2
        prod += B * (2 * t * N + H * (2 * t * P + 4 * q * N * P))
        elem += B * H * (2 * t + 4 * q + q * P + 2 * P * N)
        trans += B * H * (t + 2 * q + 1)
    return prod, elem, trans


def ssd_scan_work(x, Bm, init: bool = False, chunk: int = 128
                  ) -> Dict[str, float]:
    """The SSD forward at x ``(B, S, H, P)``, Bm ``(B, S, N)``."""
    B, S, H, P = x
    N = Bm[-1]
    prod, elem, trans = ssd_terms(x, N, chunk)
    nbytes = 4 * (2 * B * S * H * P + B * S * H + H + 2 * B * S * N
                  + (2 if init else 1) * B * H * P * N)
    return work(prod + elem, prod, nbytes, trans)


def ssd_scan_bwd_work(x, Bm, init: bool = False, chunk: int = 128,
                      dfinal: bool = False) -> Dict[str, float]:
    """The SSD backward: two products for each forward one, twice the
    elementwise work, the transcendentals once."""
    B, S, H, P = x
    N = Bm[-1]
    prod, elem, trans = ssd_terms(x, N, chunk)
    states = (2 if init else 0) + (1 if dfinal else 0)
    nbytes = 4 * (2 * (2 * B * S * H * P + B * S * H + H + 2 * B * S * N)
                  + B * S * H * P + states * B * H * P * N)
    return work(2 * (prod + elem), 2 * prod, nbytes, trans)
