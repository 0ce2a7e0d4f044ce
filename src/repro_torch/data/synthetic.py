"""Synthetic data generators (offline container: no dataset downloads).

SyntheticImageTask mimics the paper's SVHN/CIFAR-10 setting at laptop scale:
a 10-class Gaussian-prototype image task where class distinguishability is
controlled by ``margin``. SyntheticLMTask provides order-k Markov token
streams so language-model FL runs have learnable structure.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticImageTask:
    images: np.ndarray  # [n, H, W, C] float32
    labels: np.ndarray  # [n] int32
    n_classes: int


def make_image_classification(seed=0, n=20000, n_classes=10, shape=(8, 8, 1),
                              margin=2.0, noise=1.0):
    rng = np.random.default_rng(seed)
    d = int(np.prod(shape))
    protos = rng.normal(0, margin, (n_classes, d))
    labels = rng.integers(0, n_classes, n)
    x = protos[labels] + rng.normal(0, noise, (n, d))
    return SyntheticImageTask(
        images=x.reshape((n,) + shape).astype(np.float32),
        labels=labels.astype(np.int32),
        n_classes=n_classes,
    )


@dataclasses.dataclass
class SyntheticLMTask:
    tokens: np.ndarray  # [n_seq, L+1] int32 (inputs + next-token labels)
    vocab: int


def make_lm_tokens(seed=0, n_seq=2048, seq_len=64, vocab=97, order=1,
                   concentration=0.3):
    """Markov-chain token streams — per-seed transition matrix gives each
    'client corpus' its own distribution when seeds differ."""
    rng = np.random.default_rng(seed)
    T = rng.dirichlet(np.full(vocab, concentration), size=vocab)  # [V, V]
    cdf = np.cumsum(T, axis=1)
    toks = np.zeros((n_seq, seq_len + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab, n_seq)
    u = rng.random((n_seq, seq_len))
    for t in range(seq_len):
        toks[:, t + 1] = (cdf[toks[:, t]] < u[:, t:t + 1]).sum(axis=1)
    return SyntheticLMTask(tokens=toks, vocab=vocab)
