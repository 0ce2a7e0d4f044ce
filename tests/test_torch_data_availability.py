"""The port's data pipeline and availability processes against the JAX
package: synthetic data and partitions equal, the uniform device sampler
bit-equal, and masks of all five availability kinds bit-equal over 200
rounds up to float-compare flips (u within an ulp of p), which are
counted and must stay rare."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import availability as ref_av  # noqa: E402
from repro.data import federated as ref_fed  # noqa: E402
from repro.data import partition as ref_part  # noqa: E402
from repro.data import synthetic as ref_syn  # noqa: E402
from repro_torch.core import availability as av  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data import federated as fed  # noqa: E402
from repro_torch.data import partition, synthetic  # noqa: E402


def _dataset(seed=0, m=8, n=600, batch=4):
    task = synthetic.make_image_classification(seed=seed, n=n)
    idx, nu = partition.dirichlet_partition(
        np.random.default_rng(seed), task.labels, m, alpha=0.1,
        min_per_client=batch)
    return task, idx, nu


def test_synthetic_and_partition_equal():
    for seed in (0, 5):
        a = synthetic.make_image_classification(seed=seed, n=500)
        b = ref_syn.make_image_classification(seed=seed, n=500)
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
        ia, nua = partition.dirichlet_partition(
            np.random.default_rng(seed), a.labels, 10, min_per_client=3)
        ib, nub = ref_part.dirichlet_partition(
            np.random.default_rng(seed), b.labels, 10, min_per_client=3)
        np.testing.assert_array_equal(nua, nub)
        for x, y in zip(ia, ib):
            np.testing.assert_array_equal(x, y)
        pa, pb = fed.padded_client_index(ia), ref_fed.padded_client_index(ib)
        for k in ("idx", "counts"):
            np.testing.assert_array_equal(pa[k], pb[k])


def test_host_round_batches_and_eval_batch_equal():
    task, idx, _ = _dataset()
    arrays = dict(images=task.images, labels=task.labels)
    a = fed.FederatedDataset(arrays, idx, seed=3)
    b = ref_fed.FederatedDataset(arrays, idx, seed=3)
    for t in range(3):
        ra, rb = a.round_batches(t, 2, 4), b.round_batches(t, 2, 4)
        for k in arrays:
            np.testing.assert_array_equal(ra[k], rb[k])
    for k in arrays:
        np.testing.assert_array_equal(a.eval_batch(64, seed=1)[k],
                                      b.eval_batch(64, seed=1)[k])


@pytest.mark.parametrize("s,b", [(2, 4), (5, 32)])
def test_uniform_device_sampler_bit_equal(s, b):
    task, idx, _ = _dataset(m=8, batch=4)
    arrays = dict(images=task.images, labels=task.labels)
    store = fed.device_store(arrays, idx, "cpu")
    ref_store = ref_fed.device_store(arrays, idx)
    init, sample = fed.make_device_sampler(8, s, b)
    ref_init, ref_sample = ref_fed.make_device_sampler(8, s, b)
    ss = init(store, prng.PRNGKey(1, "cpu"))
    rss = ref_init(ref_store, jax.random.PRNGKey(1))
    for t in range(4):
        k = jax.random.fold_in(jax.random.PRNGKey(1), t)
        want, rss = ref_sample(ref_store, rss, k)
        got, ss = sample(store, ss, prng.fold_in(prng.PRNGKey(1, "cpu"), t))
        for key in arrays:
            assert got[key].shape == want[key].shape
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))


def test_sampler_modes_not_ported_raise():
    with pytest.raises(NotImplementedError, match="epoch"):
        fed.make_device_sampler(4, 2, 2, mode="epoch")
    with pytest.raises(ValueError):
        fed.make_device_sampler(4, 2, 2, mode="bogus")


def test_base_probs_from_data_close():
    _, _, nu = _dataset(m=64, n=2000)
    want = np.asarray(ref_av.base_probs_from_data(jax.random.PRNGKey(0),
                                                  jnp.asarray(nu)))
    got = av.base_probs_from_data(prng.PRNGKey(0, "cpu"),
                                  torch.from_numpy(nu.astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


KIND_CFGS = [
    ref_av.AvailabilityCfg(kind="stationary"),
    ref_av.AvailabilityCfg(kind="staircase", period=10),
    ref_av.AvailabilityCfg(kind="sine", gamma=0.5, period=16),
    ref_av.AvailabilityCfg(kind="interleaved_sine", gamma=0.9, cutoff=0.2),
    ref_av.AvailabilityCfg(kind="markov", markov_up=0.3, markov_down=0.25,
                           delta_floor=0.05),
]


@pytest.mark.parametrize("ref_cfg", KIND_CFGS, ids=lambda c: c.kind)
def test_masks_bit_equal_over_200_rounds(ref_cfg):
    """Same base_p, same keys: every mask entry agrees unless the
    reference's uniform draw lies within a few ulp of p — a float-compare
    flip from an ulp difference in sin or in a mean.  The markov chain is
    carried from the reference's state, so a flip cannot cascade."""
    cfg = av.AvailabilityCfg(**dataclasses.asdict(ref_cfg))
    m, T = 64, 200
    _, _, nu = _dataset(m=m, n=2000)
    base_p = ref_av.base_probs_from_data(jax.random.PRNGKey(0),
                                         jnp.asarray(nu))
    tbase = torch.from_numpy(np.asarray(base_p))
    ref_sample = jax.jit(lambda k, t, st: ref_av.sample_active(
        k, ref_cfg, base_p, t, st))
    ref_probs = jax.jit(lambda t: ref_av.probs_at(ref_cfg, base_p, t))
    key = jax.random.PRNGKey(7)
    markov = jnp.ones((m,), jnp.float32)
    mismatches, flips, n_on = 0, 0, 0
    for t in range(T):
        k = jax.random.fold_in(key, t)
        tt = torch.tensor(t, dtype=torch.int32)
        want, new_markov = ref_sample(k, jnp.int32(t), markov)
        got, _ = av.sample_active(prng.fold_in(prng.PRNGKey(7, "cpu"), t), cfg,
                                  tbase, tt,
                                  torch.from_numpy(np.asarray(markov)))
        np.testing.assert_allclose(av.probs_at(cfg, tbase, tt).numpy(),
                                   np.asarray(ref_probs(jnp.int32(t))),
                                   rtol=0, atol=1e-6)
        want = np.asarray(want)
        bad = got.numpy() != want
        if bad.any():
            u = np.asarray(jax.random.uniform(k, (m,)))
            if cfg.kind == "markov":
                thr = np.where(np.asarray(markov) > 0.5, cfg.markov_down,
                               np.asarray(ref_av.markov_turn_on(ref_cfg,
                                                                base_p)))
            else:
                thr = np.asarray(ref_probs(jnp.int32(t)))
            mismatches += int(bad.sum())
            flips += int((bad & (np.abs(u - thr) < 1e-6)).sum())
        n_on += int(want.sum())
        markov = new_markov
    assert mismatches == flips, "a mask mismatch that is not a float flip"
    assert flips <= 2, f"{flips} float-compare flips in {T * m} draws"
    assert 0 < n_on < T * m
