"""The port's epoch-permutation sampler
(``repro_torch.data.federated.make_device_sampler(mode="epoch")``)
against the JAX package's, from the same store and keys.

Held bit for bit: the column stream (through the gathered sample ids)
and the carry ``{perm, cursor, epoch, key}`` after every round, for
ragged shards, shards smaller than one round's draw (several epoch wraps
a round) and ``min_count > 1``.  Held within the port (as
tests/test_epoch_sampler.py holds the reference): every sample drawn
exactly once an epoch, the per-round key ignored, epochs reshuffled, and
the host loop equal to the chunked executor for FedAWE and MIFA, both
also against the reference's runs."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.data import federated as ref_fed  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data import federated as fed  # noqa: E402

from _torch_fl_small import (assert_carry_equal,  # noqa: E402,I100
                             assert_parity, assert_same_port, run)

CASES = [
    ([1, 2, 3, 5, 8], 2, 3, 1),     # shards smaller than one round's draw
    ([7, 7, 7], 3, 2, 7),           # uniform shards, min_count exact
    ([4, 9, 2, 16], 1, 5, 2),       # a draw crosses epochs mid-batch
    ([1, 1], 4, 4, 1),              # 1-sample clients: 16 wraps a round
    ([6, 11, 9, 5, 30], 2, 4, 5),   # min_count > 1 below the true minimum
]


def _owner_arrays(sizes):
    """Arrays whose ``y`` is the global sample id, sharded raggedly."""
    n = sum(sizes)
    arrays = dict(x=np.arange(n, dtype=np.float32)[:, None],
                  y=np.arange(n, dtype=np.int32))
    idx, off = [], 0
    for k in sizes:
        idx.append(np.arange(off, off + k))
        off += k
    return arrays, idx


def _port(sizes, s, b, min_count=1, seed=0):
    arrays, idx = _owner_arrays(sizes)
    store = fed.device_store(arrays, idx, "cpu")
    init, sample = fed.make_device_sampler(len(sizes), s, b, mode="epoch",
                                           min_count=min_count)
    key = prng.PRNGKey(seed, "cpu")
    return store, init(store, key), sample, key, idx


def _drain(sizes, s, b, rounds, seed=0):
    """Per-client sequences of drawn sample ids over ``rounds``."""
    m = len(sizes)
    store, ss, sample, key, idx = _port(sizes, s, b, seed=seed)
    seq = [[] for _ in range(m)]
    for t in range(rounds):
        batch, ss = sample(store, ss, prng.fold_in(key, t))
        y = batch["y"].reshape(m, -1).numpy()
        for i in range(m):
            seq[i].extend(y[i].tolist())
    return seq, idx


@pytest.mark.parametrize("sizes,s,b,min_count", CASES)
def test_stream_and_carry_bit_equal(sizes, s, b, min_count):
    """Six rounds: the gathered ids of every round and the carry after it
    equal the reference's."""
    m = len(sizes)
    arrays, idx = _owner_arrays(sizes)
    rstore = ref_fed.device_store(arrays, idx)
    rinit, rsample = ref_fed.make_device_sampler(m, s, b, mode="epoch",
                                                 min_count=min_count)
    rkey = jax.random.PRNGKey(5)
    rss = rinit(rstore, rkey)
    store, ss, sample, key, _ = _port(sizes, s, b, min_count, seed=5)
    assert_carry_equal(ss, rss)
    for t in range(6):
        want, rss = rsample(rstore, rss, jax.random.fold_in(rkey, t))
        got, ss = sample(store, ss, prng.fold_in(key, t))
        for k in ("x", "y"):
            assert got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
        assert_carry_equal(ss, rss)
        assert all(v.dtype == torch.int32 for k, v in ss.items()
                   if k != "key")


@pytest.mark.parametrize("sizes,s,b,min_count", CASES)
def test_exactly_once_per_epoch(sizes, s, b, min_count):
    rounds = max(3, (3 * max(sizes)) // (s * b) + 1)
    seq, idx = _drain(sizes, s, b, rounds)
    for i, c in enumerate(sizes):
        draws, shard = seq[i], sorted(idx[i].tolist())
        assert len(draws) >= 2 * c, "need >= 2 epochs to test the property"
        for e in range(len(draws) // c):
            assert sorted(draws[e * c:(e + 1) * c]) == shard, (i, e)


def test_stream_ignores_per_round_key():
    sizes, s, b = [3, 5, 2], 2, 2
    store, ss_a, sample, key, _ = _port(sizes, s, b, seed=3)
    ss_b = {k: v.clone() for k, v in ss_a.items()}
    for t in range(4):
        ba, ss_a = sample(store, ss_a, prng.fold_in(key, t))
        bb, ss_b = sample(store, ss_b, prng.PRNGKey(1000 + t, "cpu"))
        assert torch.equal(ba["y"], bb["y"])
    assert_carry_equal(ss_a, ss_b)


def test_epochs_reshuffle():
    sizes = [12, 12]
    seq, _ = _drain(sizes, 2, 3, rounds=8, seed=1)
    for i, c in enumerate(sizes):
        epochs = {tuple(seq[i][e * c:(e + 1) * c]) for e in range(3)}
        assert len(epochs) > 1, "identical order in every epoch"


def test_carry_owns_its_buffers_and_min_count_is_checked():
    store, ss, _, key, _ = _port([3, 4], 1, 2)
    ptrs = {v.untyped_storage().data_ptr() for v in ss.values()}
    assert len(ptrs) == len(ss)
    assert ss["key"].untyped_storage().data_ptr() != \
        key.untyped_storage().data_ptr()
    init, _ = fed.make_device_sampler(2, 1, 2, mode="epoch", min_count=4)
    with pytest.raises(ValueError, match="min_count=4 overstates"):
        init(store, key)


# ---------------------------------------------------------------------------
# the FL round through the epoch sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["fedawe", "mifa"])
def test_chunked_matches_host_loop_and_reference(strategy):
    """T = 6 at K = 4: a chunk boundary inside an epoch and a tail chunk.
    The port's executors agree exactly, sampler carry included; each is
    held against the reference's run (carry bit-equal)."""
    kw = dict(sampling="epoch", carry=True)
    host = run("port", strategy, **kw)
    chunked = run("port", strategy, chunk=True, **kw)
    assert_same_port(host, chunked)
    assert_carry_equal(host[2], chunked[2])
    for chunk, port in ((False, host), (True, chunked)):
        ref = run("ref", strategy, chunk=chunk, **kw)
        assert_parity(ref, port)
        assert_carry_equal(port[2], ref[2])
        assert port[2]["epoch"].sum() > 0   # the run crossed epochs
