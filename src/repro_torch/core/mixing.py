"""Implicit-gossip mixing matrix utilities (eq. 4, Lemma 1, Lemma 4); a
copy of the reference's ``repro/core/mixing.py`` (numpy only, so the port
keeps its own copy rather than importing it).

Used by tests/benchmarks to verify that the engine's masked-mean +
broadcast-back implements exactly multiplication by the doubly stochastic
W^{(t)} of eq. (4), and to measure rho = lambda_2(E[W^2]) against the
Lemma 4 bound.
"""
from __future__ import annotations

import numpy as np


def mixing_matrix(mask: np.ndarray) -> np.ndarray:
    """W^{(t)} from eq. (4). mask: [m] 0/1. Empty round -> identity."""
    m = len(mask)
    a = np.asarray(mask, dtype=np.float64)
    n = a.sum()
    if n == 0:
        return np.eye(m)
    W = np.outer(a, a) / n
    for i in range(m):
        if a[i] == 0:
            W[i, i] = 1.0
    return W


def is_doubly_stochastic(W, tol=1e-9):
    return (np.all(W >= -tol)
            and np.allclose(W.sum(0), 1.0, atol=tol)
            and np.allclose(W.sum(1), 1.0, atol=tol))


def rho_monte_carlo(probs_fn, m, n_samples=2000, seed=0):
    """Estimate rho = lambda_2(E[W^2]) for i.i.d. Bernoulli availability.

    probs_fn(t) -> [m] probabilities (stationary: constant).
    """
    rng = np.random.default_rng(seed)
    M = np.zeros((m, m))
    for s in range(n_samples):
        p = probs_fn(s)
        mask = (rng.random(m) < p).astype(np.float64)
        W = mixing_matrix(mask)
        M += W @ W
    M /= n_samples
    eig = np.sort(np.linalg.eigvalsh(M))
    return eig[-2], M


def lemma4_bound(delta, m):
    """rho <= 1 - delta^4 (1-(1-delta)^m)^2 / 8."""
    return 1.0 - delta ** 4 * (1.0 - (1.0 - delta) ** m) ** 2 / 8.0
