"""Deterministic synthetic data (a copy of the reference's
``make_cifar_like`` / ``make_token_stream`` / ``token_dataset`` /
``split_clients`` / ``batch_tokens``: byte-identical arrays per seed)."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def make_cifar_like(n: int, seed: int = 0, num_classes: int = 10,
                    hw: int = 32, ch: int = 3) -> Dict[str, np.ndarray]:
    """Class-conditional smooth templates plus noise, (n, hw, hw, ch) fp32
    NHWC images and int32 labels."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=n).astype(np.int32)
    yy, xx = np.meshgrid(np.linspace(0, 1, hw), np.linspace(0, 1, hw),
                         indexing="ij")
    templates = np.stack([
        np.stack([np.sin(2 * np.pi * ((c + 1) * xx + k))
                  * np.cos(2 * np.pi * ((c % 3 + 1) * yy - k))
                  for k in range(ch)], axis=-1)
        for c in range(num_classes)
    ])  # (C, hw, hw, ch)
    images = templates[labels] + rng.randn(n, hw, hw, ch) * 0.8
    return {"images": images.astype(np.float32), "labels": labels}


def make_token_stream(n_tokens: int, vocab: int, seed: int = 0,
                      order: int = 2) -> np.ndarray:
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


def token_dataset(num_seqs: int, seq: int, vocab: int, seed: int = 0
                  ) -> Dict[str, np.ndarray]:
    """(tokens, next-token labels) rows cut from one synthetic stream,
    int32 (num_seqs, seq) each, shaped like ``make_cifar_like``'s output so
    ``split_clients`` and the loaders take LM data unchanged."""
    stream = make_token_stream(num_seqs * (seq + 1), vocab, seed=seed)
    rows = stream[:num_seqs * (seq + 1)].reshape(num_seqs, seq + 1)
    return {"tokens": rows[:, :-1].astype(np.int32),
            "labels": rows[:, 1:].astype(np.int32)}


def split_clients(data: Dict[str, np.ndarray], num_clients: int
                  ) -> List[Dict[str, np.ndarray]]:
    """IID split into ``num_clients`` equal, non-overlapping shards."""
    n = len(next(iter(data.values())))
    per = n // num_clients
    return [{k: v[i * per:(i + 1) * per] for k, v in data.items()}
            for i in range(num_clients)]


def batch_tokens(stream: np.ndarray, batch: int, seq: int, step: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic sliding batches of ``stream``: (tokens, next-token
    labels), (batch, seq) each; step ``step`` starts at ``step * batch *
    (seq + 1)`` modulo the stream's usable length."""
    need = batch * (seq + 1)
    start = (step * need) % max(len(stream) - need - 1, 1)
    chunk = stream[start:start + need].reshape(batch, seq + 1)
    return chunk[:, :-1], chunk[:, 1:]
