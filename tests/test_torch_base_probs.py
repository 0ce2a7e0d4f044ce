"""The port's gamma, log-gamma and Dirichlet draws (repro_torch/core/
prng.py) and ``base_probs`` (core/availability.py) against jax.random
under its defaults (threefry2x32, partitionable) and the JAX package's
``base_probs``, from the same keys.

The draws run jax's Marsaglia–Tsang rejection loop with its key splits,
element by element.  Its accept test compares ``log U`` with values built
from ``log`` and ``normal``, and the port's ``normal`` agrees with jax's
within 1e-6, not bitwise (tests/test_torch_prng.py): an ulp can tip an
acceptance and give that element another draw.  Such flips are counted
and bounded, as tests/test_torch_data_availability.py counts its mask
flips; every other draw is held within its bound:

- ``dirichlet`` and ``base_probs``: within 1e-6 (absolute; the values are
  in [0, 1]);
- ``gamma`` and ``loggamma``: within 1e-6 relative and 1e-6 absolute (a
  log-gamma draw reaches tens at small alpha, where one float32 ulp is
  about 4e-6)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import availability as ref_av  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core import availability as av  # noqa: E402
from repro_torch.core import prng  # noqa: E402

SEEDS = [0, 1, 42, 2 ** 31 - 1, -3]
ALPHAS = [0.05, 0.1, 0.5, 1.0, 3.0]
#: draws whose accept test an ulp tipped the other way: at most this many
#: over a test's draws
MAX_FLIPS = 2


def _pair(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")


def _flips(got, want, rtol, atol):
    """Count the draws outside the bound: each is taken as a flip."""
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    return int((~np.isclose(got, want, rtol=rtol, atol=atol)).sum())


@pytest.mark.parametrize("seed", SEEDS)
def test_gamma_and_loggamma_within_tolerance(seed):
    jk, pk = _pair(seed)
    flips = 0
    for alpha in ALPHAS:
        want = np.asarray(jax.random.loggamma(jk, alpha, (50, 10)))
        got = prng.loggamma(pk, alpha, (50, 10)).numpy()
        flips += _flips(got, want, 1e-6, 1e-6)
        want = np.asarray(jax.random.gamma(jk, alpha, (50, 10)))
        got = prng.gamma(pk, alpha, (50, 10)).numpy()
        flips += _flips(got, want, 1e-6, 1e-6)
        assert (got >= 0).all()
    assert flips <= MAX_FLIPS, f"{flips} flips in {2 * 500 * len(ALPHAS)}"


def test_gamma_per_element_alpha_and_default_shape():
    """``a`` of its own shape (one alpha per element, ``shape=None``) and
    broadcast against a larger ``shape``, row-major keys as jax's."""
    jk, pk = _pair(7)
    a = np.linspace(0.05, 4.0, 24, dtype=np.float32).reshape(4, 6)
    want = np.asarray(jax.random.gamma(jk, jnp.asarray(a)))
    got = prng.gamma(pk, torch.from_numpy(a)).numpy()
    assert _flips(got, want, 1e-6, 1e-6) <= MAX_FLIPS
    want = np.asarray(jax.random.loggamma(jk, jnp.asarray(a[0]), (3, 6)))
    got = prng.loggamma(pk, torch.from_numpy(a[0]), (3, 6)).numpy()
    assert _flips(got, want, 1e-6, 1e-6) <= MAX_FLIPS


@pytest.mark.parametrize("seed", SEEDS)
def test_dirichlet_within_1e6(seed):
    """Rows on the simplex; a flipped element changes its whole row (the
    softmax normalises), so rows are counted."""
    jk, pk = _pair(seed)
    rows = 0
    for alpha in (0.05, 0.1, 1.0):
        want = np.asarray(jax.random.dirichlet(
            jk, jnp.full((10,), alpha), (200,)))
        got = prng.dirichlet(pk, torch.full((10,), alpha), (200,)).numpy()
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=1e-5)
        bad = ~np.isclose(got, want, rtol=0, atol=1e-6)
        rows += int(bad.any(-1).sum())
    assert rows <= MAX_FLIPS
    alpha = np.array([0.2, 1.0, 3.0], np.float32)
    want = np.asarray(jax.random.dirichlet(jk, jnp.asarray(alpha)))
    got = prng.dirichlet(pk, torch.from_numpy(alpha)).numpy()
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("m", [50, 100])
def test_base_probs_within_1e6(seed, m):
    """The JAX package's ``base_probs`` (Dirichlet(0.1) over 10 classes,
    then ``base_probs_from_data``): ν and p within 1e-6, exported from
    ``repro_torch.core`` as the reference exports it."""
    assert core.base_probs is av.base_probs
    jk, pk = _pair(seed)
    want_p, want_nu = (np.asarray(x) for x in ref_av.base_probs(jk, m))
    got_p, got_nu = (x.numpy() for x in core.base_probs(pk, m))
    assert got_nu.shape == (m, 10) and got_p.shape == (m,)
    rows = ~np.isclose(got_nu, want_nu, rtol=0, atol=1e-6).all(-1)
    assert int(rows.sum()) <= MAX_FLIPS
    np.testing.assert_allclose(got_p[~rows], want_p[~rows], rtol=0,
                               atol=1e-6)
    assert (got_p >= 1e-3).all() and (got_p <= 1.0).all()


def test_base_probs_keyword_arguments():
    jk, pk = _pair(3)
    want_p, want_nu = ref_av.base_probs(jk, 16, alpha=0.5, n_classes=4)
    got_p, got_nu = av.base_probs(pk, 16, alpha=0.5, n_classes=4)
    np.testing.assert_allclose(got_nu.numpy(), np.asarray(want_nu), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0,
                               atol=1e-6)
