"""Federated batching: per-client shards -> [m, s, b, ...] round batches.

The round engine consumes one fresh minibatch per local step, so a round
batch has leading dims [clients, local_steps, batch].  Two sampling paths,
as in the reference:

  * ``FederatedDataset.round_batches`` — the host path: numpy RNG picks
    indices per client and builds the round batch in host memory.
  * ``device_store`` + ``make_device_sampler`` — the device path: the
    backing arrays and a padded ``[m, cap]`` index matrix live on the
    device, and a round batch is one gather driven by a PRNG key
    (``core/prng.py``), so the draws equal the reference's bit for bit.

``make_device_sampler`` returns ``(init_sampler_state, sample)`` with
``sample(store, sampler_state, key) -> (batches, sampler_state)``, the
stateful contract both executors of ``core/engine.py`` thread through.
Only ``mode="uniform"``, emitting gathered batches, is ported so far.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.core import prng


class FederatedDataset:
    """Holds per-client index shards over a backing array store."""

    def __init__(self, arrays: Dict[str, np.ndarray],
                 client_indices: List[np.ndarray], seed: int = 0):
        self.arrays = arrays
        self.client_indices = client_indices
        self.m = len(client_indices)
        self._rng = np.random.default_rng(seed)

    def round_batches(self, t: int, s: int, b: int) -> Dict[str, np.ndarray]:
        """Sample [m, s, b, ...] batches for round t (with replacement within
        each client shard — clients hold few samples under Dirichlet skew)."""
        out = {k: np.empty((self.m, s, b) + v.shape[1:], v.dtype)
               for k, v in self.arrays.items()}
        for i, idx in enumerate(self.client_indices):
            pick = self._rng.choice(idx, size=(s, b), replace=True)
            for k, v in self.arrays.items():
                out[k][i] = v[pick]
        return out

    def eval_batch(self, n: int = 1024, seed: int = 0):
        rng = np.random.default_rng(seed)
        all_idx = np.concatenate(self.client_indices)
        pick = rng.choice(all_idx, size=min(n, len(all_idx)), replace=False)
        return {k: v[pick] for k, v in self.arrays.items()}

    def device_store(self, device):
        """Device-resident store for on-device sampling: see module-level
        ``device_store``."""
        return device_store(self.arrays, self.client_indices, device)


def padded_client_index(client_indices) -> Dict[str, np.ndarray]:
    """Ragged per-client shards -> dense ``idx [m, cap] int32`` (rows padded
    by repeating the first element — never sampled past ``counts``) plus
    ``counts [m] int32``."""
    counts = np.asarray([len(ix) for ix in client_indices], np.int32)
    if counts.min() <= 0:
        raise ValueError("every client needs at least one sample")
    cap = int(counts.max())
    flat = np.concatenate(
        [np.asarray(ix, np.int32) for ix in client_indices])
    starts = np.concatenate(
        [[0], np.cumsum(counts[:-1], dtype=np.int64)])
    ar = np.arange(cap, dtype=np.int64)
    valid = ar[None, :] < counts[:, None]
    pos = starts[:, None] + np.where(valid, ar[None, :], 0)
    return dict(idx=flat[pos].astype(np.int32), counts=counts)


def _to_device(x, device):
    t = torch.from_numpy(np.ascontiguousarray(x))
    # integer arrays become int64, torch's index dtype
    if not t.is_floating_point():
        t = t.long()
    return t.to(device)


def device_store(arrays: Dict[str, np.ndarray], client_indices, device):
    """The on-device store consumed by ``make_device_sampler``:

      {'arrays': {k: [n, ...]}, 'idx': [m, cap] i64, 'counts': [m] i64}

    Integer arrays (labels, indices) are held as int64 for gathers; their
    values equal the reference store's int32 ones."""
    pad = padded_client_index(client_indices)
    return dict(
        arrays={k: _to_device(v, device) for k, v in arrays.items()},
        idx=_to_device(pad["idx"], device),
        counts=_to_device(pad["counts"], device),
    )


SAMPLING_MODES = ("uniform", "epoch")


def _gather_batches(store, cols, m, s, b):
    """cols [m, s*b]: per-client columns into the padded index matrix ->
    {k: [m, s, b, ...]} round batches, as one gather per array."""
    rows = torch.gather(store["idx"], 1, cols)               # [m, s*b]
    flat = rows.reshape(-1)
    return {k: v.index_select(0, flat).reshape((m, s, b) + v.shape[1:])
            for k, v in store["arrays"].items()}


def make_device_sampler(m: int, s: int, b: int, mode: str = "uniform"):
    """Stateful round-batch sampler over a ``device_store``.

    ``mode="uniform"``: i.i.d. draws with replacement within each client
    shard, ``prng.randint`` with the per-client ``maxval=counts`` — the
    reference's exact column stream.  The state is empty; the per-round
    key is ``fold_in(data_key, t)``.

    ``mode="epoch"`` belongs to a later slice of the port and raises; the
    reference's ``emit="cols"`` (the sparse cohort path) is not ported."""
    if mode not in SAMPLING_MODES:
        raise ValueError(f"unknown sampling mode {mode!r}; "
                         f"expected one of {SAMPLING_MODES}")
    if mode == "epoch":
        raise NotImplementedError(
            "epoch-permutation sampling is not ported yet (a later slice "
            "of the port); use mode='uniform'")
    q = s * b

    def init_sampler_state(store, key):
        del store, key
        return {}

    def sample(store, sampler_state, key):
        cols = prng.randint(key, (m, q), 0, store["counts"][:, None])
        return _gather_batches(store, cols, m, s, b), sampler_state

    return init_sampler_state, sample
