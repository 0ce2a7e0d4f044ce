"""The port's counter-based PRNG (repro_torch/core/prng.py) against
jax.random under jax's defaults (threefry2x32, partitionable): keys,
splits, fold_in, uniform and randint bit for bit; normal within 1e-6."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch.core import prng  # noqa: E402

SEEDS = [0, 1, 42, 2 ** 31 - 1, -3]


def _np(key):
    return np.asarray(key).astype(np.int64)


def _pair(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")


def test_threefry_partitionable_default():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bit_exact(seed):
    jk, pk = _pair(seed)
    np.testing.assert_array_equal(_np(jk), pk.numpy())
    for num in (1, 2, 3, 7, 64):
        np.testing.assert_array_equal(_np(jax.random.split(jk, num)),
                                      prng.split(pk, num).numpy())
    for d in (0, 1, 17, 2 ** 31 - 1):
        np.testing.assert_array_equal(_np(jax.random.fold_in(jk, d)),
                                      prng.fold_in(pk, d).numpy())
    # a device-resident counter folds in like a Python int
    np.testing.assert_array_equal(
        _np(jax.random.fold_in(jk, 5)),
        prng.fold_in(pk, torch.tensor(5, dtype=torch.int32)).numpy())


def test_batched_split_matches_vmap():
    ks = jax.random.split(jax.random.PRNGKey(3), 6)
    got = prng.split(torch.from_numpy(_np(ks)), 3).numpy()
    want = _np(jax.vmap(lambda k: jax.random.split(k, 3))(ks))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (1,), (5,), (3, 7), (64, 33)])
def test_uniform_bit_exact(seed, shape):
    jk, pk = _pair(seed)
    want = np.asarray(jax.random.uniform(jk, shape))
    got = prng.uniform(pk, shape).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_per_row_maxval_bit_exact(seed):
    """Per-row maxval as the device sampler passes it, including
    maxval=1 and spans past 2**16 (where the uint32 multiplier wraps)."""
    jk, pk = _pair(seed)
    counts = np.array([1, 2, 3, 100, 65536, 65537, 2 ** 20 + 7,
                       2 ** 31 - 1], np.int32)
    want = np.asarray(jax.random.randint(jk, (8, 41), 0,
                                         jnp.asarray(counts)[:, None]))
    got = prng.randint(pk, (8, 41), 0, torch.from_numpy(counts)[:, None])
    np.testing.assert_array_equal(got.numpy(), want)
    for lo, hi in ((0, 1), (0, 10), (-5, 1000), (3, 3)):
        np.testing.assert_array_equal(
            prng.randint(pk, (300,), lo, hi).numpy(),
            np.asarray(jax.random.randint(jk, (300,), lo, hi)))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_tolerance(seed):
    jk, pk = _pair(seed)
    want = np.asarray(jax.random.normal(jk, (4096,)))
    got = prng.normal(pk, (4096,)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
