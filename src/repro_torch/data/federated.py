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
``seed_data_keys`` and ``init_seed_sampler_states`` give the seed-batched
executor its ``[S]`` keys and carries; ``pad_store`` widens a store for
the packed grid (``launch/experiments.pack_cells``).
Both modes are ported, uniform draws and epoch permutations.  Each emits
gathered batches, or with ``emit="cols"`` (the sparse cohort round) the
per-client column draws and the store, from which the round gathers its
cohort's rows alone (``gather_batches_at``); ``contiguous_client_index``
builds the index of a store of 10⁵ clients without a Python loop over
them.

Under a client placement (``sharding/placement.py``) a rank's store holds
its rows of ``idx`` and ``counts`` and the whole ``arrays``
(``device_store(place=)``), and its sampler (``make_device_sampler(
place=)``) draws every round's columns over all m clients from the
replicated key and keeps its rows, so a rank's batches and carry are the
unplaced sampler's rows, bit for bit.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.sharding.placement import rows_of


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

    def device_store(self, device, *, place=None):
        """Device-resident store for on-device sampling: see module-level
        ``device_store``."""
        return device_store(self.arrays, self.client_indices, device,
                            place=place)


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


def contiguous_client_index(m: int, n_per: int) -> Dict[str, np.ndarray]:
    """Padded index for the contiguous layout where client ``i`` owns rows
    ``[i * n_per, (i + 1) * n_per)``, built without the m per-client
    arrays, so a store of 10⁵ clients is O(m * n_per) numpy work.  Feed
    it to ``device_store(..., padded=...)``."""
    if n_per <= 0:
        raise ValueError(f"n_per must be > 0; got {n_per}")
    counts = np.full((m,), n_per, np.int32)
    idx = (np.arange(m, dtype=np.int64)[:, None] * n_per
           + np.arange(n_per, dtype=np.int64)[None, :]).astype(np.int32)
    return dict(idx=idx, counts=counts)


def _to_device(x, device):
    t = torch.from_numpy(np.ascontiguousarray(x))
    # integer arrays become int64, torch's index dtype
    if not t.is_floating_point():
        t = t.long()
    return t.to(device)


def device_store(arrays: Dict[str, np.ndarray], client_indices, device, *,
                 padded=None, place=None):
    """The on-device store consumed by ``make_device_sampler``:

      {'arrays': {k: [n, ...]}, 'idx': [m, cap] i64, 'counts': [m] i64}

    Integer arrays (labels, indices) are held as int64 for gathers; their
    values equal the reference store's int32 ones.  ``padded`` (a prebuilt
    ``{'idx', 'counts'}``, e.g. ``contiguous_client_index``) takes the
    place of ``client_indices``.  A client placement ``place`` keeps the
    rank's rows of ``idx`` and ``counts`` (the reference's ``shardings=``:
    ``P(ca, None)`` and ``P(ca)``) and the whole ``arrays``."""
    if padded is None:
        if client_indices is None:
            raise ValueError("device_store needs client_indices or padded=")
        padded = padded_client_index(client_indices)
    pad = padded
    return dict(
        arrays={k: _to_device(v, device) for k, v in arrays.items()},
        idx=_to_device(rows_of(pad["idx"], place), device),
        counts=_to_device(rows_of(pad["counts"], place), device),
    )


def pad_store(store, *, m: int = 0, cap: int = 0):
    """Pad a device store's client axis to ``m`` rows and/or its index
    capacity to ``cap`` columns (the packed grid's bucket padding), as the
    reference's ``jnp.pad`` does: new index entries 0, new clients'
    counts 1 (one dummy sample each, so the sampler's invariants hold).

    Cap padding leaves the uniform sampler's stream unchanged: its draws
    are ``randint(0, counts)`` and the gather reads no column at or past a
    row's count.  The epoch sampler's permutations are cap-shaped, so
    callers pad uniform-mode cells only."""
    idx, counts = store["idx"], store["counts"]
    m0, cap0 = idx.shape
    m, cap = max(int(m), m0), max(int(cap), cap0)
    if (m, cap) == (m0, cap0):
        return store
    idx = torch.nn.functional.pad(idx, (0, cap - cap0, 0, m - m0))
    counts = torch.nn.functional.pad(counts, (0, m - m0), value=1)
    return dict(store, idx=idx, counts=counts)


SAMPLING_MODES = ("uniform", "epoch")


def _gather_batches(store, cols, m, s, b):
    """cols [m, s*b]: per-client columns into the padded index matrix ->
    {k: [m, s, b, ...]} round batches, as one gather per array."""
    rows = torch.gather(store["idx"], 1, cols)               # [m, s*b]
    flat = rows.reshape(-1)
    return {k: v.index_select(0, flat).reshape((m, s, b) + v.shape[1:])
            for k, v in store["arrays"].items()}


def gather_batches_at(store, cols, rows_idx, s, b):
    """The cohort's batch gather: ``cols [c, s*b]`` column draws of the
    cohort rows ``rows_idx [c]`` -> ``{k: [c, s, b, ...]}`` batches, bit
    for bit rows ``rows_idx`` of the dense gather of the full ``[m, s*b]``
    draw, at O(c) data rows.  A leading seed axis (``cols [S, c, s*b]``,
    ``rows_idx [S, c]``) gathers every seed's cohort from the shared
    store at once."""
    pad = store["idx"]
    own = pad.index_select(0, rows_idx.reshape(-1)).view(
        tuple(rows_idx.shape) + (pad.shape[1],))
    flat = torch.gather(own, -1, cols).reshape(-1)
    lead = tuple(rows_idx.shape) + (s, b)
    return {k: v.index_select(0, flat).reshape(lead + v.shape[1:])
            for k, v in store["arrays"].items()}


def make_device_sampler(m: int, s: int, b: int, mode: str = "uniform",
                        min_count: int = 1, emit: str = "batches",
                        place=None):
    """Stateful round-batch sampler over a ``device_store``.

    ``mode="uniform"``: i.i.d. draws with replacement within each client
    shard, ``prng.randint`` with the per-client ``maxval=counts`` — the
    reference's exact column stream.  The state is empty; the per-round
    key is ``fold_in(data_key, t)``.

    ``mode="epoch"``: each client walks a fresh random permutation of its
    own shard per epoch, so every sample is drawn exactly once an epoch.
    The carry is ``{perm [m, cap], cursor [m], epoch [m]}`` (int32) and
    the data ``key``; the stream is a function of that carry alone (the
    per-round key is ignored), bit-equal to the reference's.
    ``min_count`` is a lower bound on every shard's size: a client
    crosses at most ``(s*b - 1) // min_count + 1`` epoch boundaries a
    round, so it sizes the per-round permutation stack (1 is always
    safe); ``init_sampler_state`` checks it against the store.

    ``emit="batches"`` gathers the round's ``{k: [m, s, b, ...]}`` rows;
    ``emit="cols"`` returns ``{'cols': [m, s*b], 'store': store}``, the
    column draws and the store, for the cohort round, which gathers only
    its cohort's rows (``gather_batches_at``) while the draws and the
    carry advance over the full population, as a dense run's.

    ``place`` (a client placement; ``emit="batches"`` only) makes it the
    sampler of one rank over a ``device_store(place=)`` store: its batches
    and carry are the rank's rows of the unplaced sampler's, the uniform
    columns drawn over all ``m`` clients and sliced, each epoch
    permutation keyed by the client's global index.  ``sample.place`` is
    ``place``."""
    if mode not in SAMPLING_MODES:
        raise ValueError(f"unknown sampling mode {mode!r}; "
                         f"expected one of {SAMPLING_MODES}")
    if emit not in ("batches", "cols"):
        raise ValueError(f"unknown emit mode {emit!r}; "
                         "expected 'batches' or 'cols'")
    if place is not None and emit != "batches":
        raise ValueError("a placed sampler emits batches (no cohort under "
                         "a client placement)")
    q = s * b
    # the clients this sampler draws for: all m, or the rank's rows
    lo, rows = (0, m) if place is None else (place.lo, place.rows)

    def _emit(store, cols):
        if emit == "cols":
            return dict(cols=cols, store=store)
        return _gather_batches(store, cols, rows, s, b)

    if mode == "uniform":
        def init_sampler_state(store, key):
            del store, key
            return {}

        def sample(store, sampler_state, key):
            counts = store["counts"]
            if place is not None:
                # the other ranks' rows draw below 1 (their columns are
                # dropped): randint is elementwise in its bound
                counts = torch.nn.functional.pad(
                    counts, (lo, m - lo - rows), value=1)
            cols = rows_of(prng.randint(key, (m, q), 0, counts[:, None]),
                           place)
            return _emit(store, cols), sampler_state

        sample.place = place
        return init_sampler_state, sample

    # epoch offsets 0..n_off-1 can be touched within one round: the carried
    # permutation plus every reshuffle a cursor can wrap into
    n_off = 2 + (q - 1) // max(int(min_count), 1)

    def _perms(base_key, epochs, counts, cap):
        """``[..., m]`` per-client epoch numbers -> ``[..., m, cap]``
        permutations: client i's epoch e sorts ``uniform(fold_in(fold_in(
        key, e), i), (cap,))``, padded columns keyed +inf, by a stable
        argsort, so the first ``counts[i]`` entries permute
        ``0..counts[i]-1``."""
        k = prng.fold_in(prng.fold_in(base_key, epochs),
                         torch.arange(lo, lo + rows, device=counts.device))
        u = prng.uniform(k, (cap,))
        pad = torch.arange(cap, device=counts.device) >= counts[:, None]
        u = torch.where(pad, float("inf"), u)
        return torch.argsort(u, dim=-1, stable=True).to(torch.int32)

    def init_sampler_state(store, key):
        counts = store["counts"]
        smallest = int(counts.min())
        if smallest < min_count:
            raise ValueError(
                f"min_count={min_count} overstates the smallest shard "
                f"({smallest}): the epoch permutation stack would be too "
                "short and sampling would silently repeat")
        cap = store["idx"].shape[1]
        zeros = torch.zeros((rows,), dtype=torch.int32,
                            device=counts.device)
        # every field owns its buffer (the carry is replaced, field by
        # field, every round)
        return dict(perm=_perms(key, zeros, counts, cap),
                    cursor=zeros.clone(), epoch=zeros.clone(),
                    key=key.clone())

    def sample(store, sampler_state, key):
        del key  # the epoch stream is fully determined by the carry
        counts = store["counts"]                                 # [m] i64
        cap = store["idx"].shape[1]
        cursor = sampler_state["cursor"].long()
        epoch = sampler_state["epoch"]
        base = sampler_state["key"]
        held = torch.arange(rows, device=counts.device)
        # global draw positions of this round, as (epoch offset, rank in
        # the epoch): a shard smaller than q wraps several times a round
        pos = cursor[:, None] + torch.arange(q, device=counts.device)
        d = pos // counts[:, None]
        r = pos % counts[:, None]
        # offset 0 is the carried permutation, the rest the reshuffles a
        # cursor can wrap into this round
        offs = torch.arange(1, n_off, dtype=torch.int32,
                            device=counts.device)
        new = _perms(base, epoch[None, :] + offs[:, None], counts, cap)
        stack = torch.cat([sampler_state["perm"][None], new], dim=0)
        cols = stack[d, held[:, None], r].long()                 # [m, q]
        total = cursor + q
        wraps = total // counts
        return _emit(store, cols), dict(
            perm=stack[wraps, held],
            cursor=(total % counts).to(torch.int32),
            epoch=epoch + wraps.to(torch.int32),
            key=base)

    sample.place = place
    return init_sampler_state, sample


def seed_data_keys(data_key, n_seeds):
    """Per-seed data keys of the seed-batched executor: ``[S, 2]`` with row
    ``j = fold_in(data_key, j)``, bit-equal to the reference's.  Seed
    ``j`` sees the sample stream of a single-seed run driven by that
    key."""
    return prng.fold_in(data_key, torch.arange(int(n_seeds),
                                               device=data_key.device))


def init_seed_sampler_states(init_sampler_state, store, data_keys):
    """Seed-stacked sampler carry: ``init_sampler_state(store,
    data_keys[j])`` per seed, stacked along a new leading ``[S]`` axis
    (``{}`` under uniform sampling) — bit for bit the carries the S
    single-seed runs start from."""
    from repro_torch.core.engine import stack_seeds

    return stack_seeds([init_sampler_state(store, data_keys[j])
                        for j in range(int(data_keys.shape[0]))])
