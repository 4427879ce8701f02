"""The one traffic generator: a traffic mix's file of parameters in,
each client's token rows and the test rows out, all drawn from the seed.

A mix (``portbench/traffic/<name>.json``) states ``clients`` (K),
``local_steps`` a round, ``rows_per_step`` and ``seq`` (the tokens of a
client step are their product) and ``test_rows`` of ``seq`` tokens.
Each client gets ``rounds x local_steps x rows_per_step`` distinct rows,
so the checked rounds never repeat a row.  Every seed draws the same
sizes; only the tokens change.

The token stream is a frozen copy of the port's ``make_token_stream``
(Zipf marginals, and half the positions following a fixed bigram rule),
so a row has structure a model can learn and a loss that moves.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

Rows = Dict[str, np.ndarray]


def token_stream(n_tokens: int, vocab: int, seed: int) -> np.ndarray:
    """Zipf marginals plus a deterministic bigram rule: half the positions
    follow ``(prev * 31 + 7) % vocab``.  int32 tokens."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    base = rng.choice(vocab, size=n_tokens, p=probs).astype(np.int32)
    follow = rng.rand(n_tokens) < 0.5
    out = base.copy()
    for i in range(1, n_tokens):
        if follow[i]:
            out[i] = (out[i - 1] * 31 + 7) % vocab
    return out


def token_rows(num_rows: int, seq: int, vocab: int, seed: int) -> Rows:
    """``num_rows`` rows of ``seq`` tokens and their next-token labels,
    int32 ``(num_rows, seq)`` each, cut from one stream."""
    stream = token_stream(num_rows * (seq + 1), vocab, seed)
    rows = stream.reshape(num_rows, seq + 1)
    return {"tokens": np.ascontiguousarray(rows[:, :-1]),
            "labels": np.ascontiguousarray(rows[:, 1:])}


def seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 30-bit seeds from any whole number ``seed``."""
    words = np.random.SeedSequence(int(seed)).generate_state(n)
    return [int(w) % (1 << 30) for w in words]


def make(traffic: dict, vocab: int, seed: int, rounds: int
         ) -> Tuple[List[Rows], Rows]:
    """(each client's rows, the test rows) of a mix for ``rounds``
    rounds of distinct rows."""
    K = int(traffic["clients"])
    per_client = rounds * int(traffic["local_steps"]) * int(
        traffic["rows_per_step"])
    seq = int(traffic["seq"])
    s = seeds(seed, K + 1)
    clients = [token_rows(per_client, seq, vocab, s[k]) for k in range(K)]
    return clients, token_rows(int(traffic["test_rows"]), seq, vocab, s[K])


def tokens_per_round(traffic: dict) -> int:
    """The tokens the clients train on in one round."""
    return (int(traffic["clients"]) * int(traffic["local_steps"])
            * int(traffic["rows_per_step"]) * int(traffic["seq"]))
