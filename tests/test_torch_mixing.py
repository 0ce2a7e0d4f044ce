"""The port's implicit-gossip mixing utilities (``repro_torch.core.mixing``,
a numpy copy of the reference's) against ``repro.core.mixing``:
``tests/test_mixing.py``'s four cases for the port, on masks and seeds
drawn here (the reference's property tests draw them with hypothesis).

``mixing_matrix`` and ``rho_monte_carlo`` are bit-equal to the
reference's; the port's FedAWE aggregation on a given mask equals
multiplication by W within 1e-5 (the reference's tolerance), and so does
the reference's on the same inputs; Lemma 4's bound holds."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.core import mixing as ref_mixing  # noqa: E402
from repro.core.strategies import get_strategy as ref_strategy  # noqa: E402
from repro_torch.core import mixing, tree_util  # noqa: E402
from repro_torch.core.strategies import get_strategy  # noqa: E402

MASKS = [[True], [False], [True, False], [False, False, False],
         [True, True, True, True], [True, False, True, False, False, True],
         list(np.random.default_rng(3).random(40) < 0.4),
         list(np.random.default_rng(4).random(12) < 0.7)]


@pytest.mark.parametrize("mask", MASKS, ids=range(len(MASKS)))
def test_mixing_matrix_doubly_stochastic_and_bit_equal(mask):
    a = np.array(mask, dtype=float)
    W = mixing.mixing_matrix(a)
    assert mixing.is_doubly_stochastic(W)
    np.testing.assert_array_equal(W, ref_mixing.mixing_matrix(a))
    assert mixing.is_doubly_stochastic(W) == \
        ref_mixing.is_doubly_stochastic(W)


@pytest.mark.parametrize("mask,seed", [
    ([True, False], 0), ([False, False, False], 1),
    ([True, True, False, True, False], 2),
    ([False, True, True, True, True, False, True, False, False, True,
      True, False], 3)])
def test_fedawe_round_equals_W_multiplication(mask, seed):
    """One FedAWE aggregation of the port == x^{t+1} = X† W^{(t)} (eq.
    4): active clients move to the gossip mean of the echoed models,
    inactive ones keep their state; the reference's aggregation on the
    same inputs agrees with it too."""
    m, d, eta_g, t = len(mask), 5, 1.3, 4
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(m, d)).astype(np.float32)
    G = rng.normal(size=(m, d)).astype(np.float32) * 0.1
    tau = rng.integers(-1, 3, size=m).astype(np.int32)
    maskf = np.array(mask, dtype=np.float32)

    echo = (t - tau).astype(np.float32)
    Xd = X.copy()
    for i in range(m):
        if mask[i]:
            Xd[i] = X[i] - eta_g * echo[i] * G[i]
    ref = mixing.mixing_matrix(np.array(mask, dtype=float)).T @ Xd

    got = get_strategy("fedawe").aggregate(
        global_tr={"w": torch.zeros(d)},
        clients_tr={"w": torch.from_numpy(X)}, G={"w": torch.from_numpy(G)},
        mask=torch.from_numpy(maskf), t=torch.tensor(t),
        tau=torch.from_numpy(tau.astype(np.int64)), probs=None, extra=(),
        eta_g=eta_g)
    want = ref_strategy("fedawe").aggregate(
        global_tr={"w": jnp.zeros(d)}, clients_tr={"w": jnp.asarray(X)},
        G={"w": jnp.asarray(G)}, mask=jnp.asarray(maskf),
        t=jnp.asarray(t, jnp.int32), tau=jnp.asarray(tau), probs=None,
        extra=(), eta_g=eta_g)
    for clients in (got[1]["w"].numpy(), np.asarray(want[1]["w"])):
        np.testing.assert_allclose(clients, ref, rtol=1e-5, atol=1e-5)
    if any(mask):
        active = [i for i in range(m) if mask[i]]
        np.testing.assert_allclose(got[0]["w"].numpy(), Xd[active].mean(0),
                                   rtol=1e-5, atol=1e-5)
        assert all(int(got[2][i]) == t for i in active)
    else:
        assert torch.equal(got[0]["w"], torch.zeros(d))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("delta,m", [(0.3, 5), (0.6, 8)])
def test_lemma4_rho_bound(delta, m):
    rho, M = mixing.rho_monte_carlo(lambda t: np.full(m, delta), m,
                                    n_samples=3000)
    rho_ref, M_ref = ref_mixing.rho_monte_carlo(lambda t: np.full(m, delta),
                                                m, n_samples=3000)
    assert rho == rho_ref
    np.testing.assert_array_equal(M, M_ref)
    bound = mixing.lemma4_bound(delta, m)
    assert bound == ref_mixing.lemma4_bound(delta, m)
    assert rho <= bound + 0.02, (rho, bound)
    assert rho < 1.0


def test_tree_masked_mean_matches_numpy():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 3, 2)).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0, 0], np.float32)
    out = tree_util.tree_masked_mean({"a": torch.from_numpy(x)},
                                     torch.from_numpy(mask))
    np.testing.assert_allclose(out["a"].numpy(), x[mask > 0].mean(0),
                               rtol=1e-6)
