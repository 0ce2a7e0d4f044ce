"""Federated data partitioning — Dirichlet(alpha) label-skew (Hsu et al.,
the paper's heterogeneity protocol, Fig. 4)."""
from __future__ import annotations

import numpy as np


def dirichlet_partition(rng: np.random.Generator, labels: np.ndarray, m: int,
                        alpha: float = 0.1, min_per_client: int = 1):
    """Assign sample indices to m clients with Dirichlet(alpha) label skew.

    Returns (indices: list of m int arrays, nu: [m, C] realized label
    distribution per client).
    """
    labels = np.asarray(labels)
    C = int(labels.max()) + 1
    by_class = [rng.permutation(np.where(labels == c)[0]) for c in range(C)]

    # per-client class proportions
    nu = rng.dirichlet(np.full(C, alpha), size=m)  # [m, C]
    client_idx = [[] for _ in range(m)]
    for c in range(C):
        n_c = len(by_class[c])
        if n_c == 0:
            continue
        # split class-c samples proportionally to nu[:, c]
        w = nu[:, c] / max(nu[:, c].sum(), 1e-12)
        counts = np.floor(w * n_c).astype(int)
        counts[np.argmax(counts)] += n_c - counts.sum()
        splits = np.cumsum(counts)[:-1]
        for i, part in enumerate(np.split(by_class[c], splits)):
            client_idx[i].append(part)
    out = []
    for i in range(m):
        idx = np.concatenate(client_idx[i]) if client_idx[i] else \
            np.zeros((0,), np.int64)
        if len(idx) < min_per_client:
            # top up from the global pool so every client can form a batch
            extra = rng.integers(0, len(labels), min_per_client - len(idx))
            idx = np.concatenate([idx, extra])
        out.append(rng.permutation(idx))

    # realized per-client label distribution
    realized = np.zeros((m, C))
    for i in range(m):
        if len(out[i]):
            bc = np.bincount(labels[out[i]], minlength=C)
            realized[i] = bc / bc.sum()
    return out, realized
