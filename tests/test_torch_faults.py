"""The port's fault injection (repro_torch/core/faults.py and the engine's
mask / mask_upload threading) against the JAX package, on the small
problem of tests/test_faults.py from the same numpy inputs and keys.

Held exactly: compute masks, ``mask_upload``, τ, ``n_active``,
``n_dropped`` and ``n_rejected``; states and losses within 1e-4 (the
reference's kernel-vs-jnp bound, tests/test_engine_kernel_path.py).
On the CPU ``use_kernel`` takes the plain version of the upload kernel
(K2); the reference runs its Pallas kernel in interpret mode."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import availability as ref_av  # noqa: E402
from repro.core import faults as ref_faults  # noqa: E402
from repro_torch.core import availability as av  # noqa: E402
from repro_torch.core import faults, prng  # noqa: E402
from repro_torch.data import dirichlet_partition  # noqa: E402
from repro_torch.kernels.echo_aggregate import ops  # noqa: E402

from _torch_fl_small import (M, assert_parity,  # noqa: E402,I100
                             assert_same_port, run)

MIDROUND = dict(upload_survival=0.7, sanitize=True)
ALL_DROPPED = dict(upload_survival=0.0, sanitize=True)


def _ones_trace(T):
    return np.ones((T, M), np.float32)


def _g0():
    return run("port", T=0)[0].global_tr


# ---------------------------------------------------------------------------
# the fault functions alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(upload_survival=0.7),
    dict(upload_survival=0.7, sanitize=True),
    dict(sanitize=True, norm_cap=2.0),
    dict(upload_survival=0.0, sanitize=True),
], ids=["dropout", "dropout-sanitize", "norm-cap", "all-dropped"])
def test_upload_mask_bit_equal(cfg):
    """50 keys over masks and updates with NaN, inf and large rows:
    ``mask_upload`` and both counts bit-equal."""
    rcfg, pcfg = ref_faults.FaultCfg(**cfg), faults.FaultCfg(**cfg)
    ref_fn = jax.jit(lambda k, mk, g: ref_faults.upload_mask(rcfg, k, mk, g))
    rng = np.random.default_rng(3)
    m, n = 32, 10
    for i in range(50):
        mask = (rng.random(m) < 0.6).astype(np.float32)
        G = rng.normal(size=(m, n)).astype(np.float32)
        G[rng.random(m) < 0.1] *= 10.0
        G[rng.integers(m), rng.integers(n)] = np.nan
        G[rng.integers(m), rng.integers(n)] = np.inf
        want = ref_fn(jax.random.PRNGKey(i), jnp.asarray(mask),
                      jnp.asarray(G))
        got = faults.upload_mask(pcfg, prng.PRNGKey(i, "cpu"),
                                 torch.from_numpy(mask), torch.from_numpy(G))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_compute_mask_bit_equal():
    """Trace replay (rows mod T) under a recurring cluster blackout."""
    kw = dict(trace=True, blackout_start=2, blackout_len=2,
              blackout_every=5, blackout_cluster=1)
    rcfg, pcfg = ref_faults.FaultCfg(**kw), faults.FaultCfg(**kw)
    rng = np.random.default_rng(4)
    trace = (rng.random((7, M)) < 0.5).astype(np.float32)
    clusters = rng.integers(0, 3, M).astype(np.int32)
    rst = ref_faults.init_fault_state(rcfg, trace=trace, clusters=clusters)
    pst = faults.init_fault_state(pcfg, trace=trace, clusters=clusters)
    ref_fn = jax.jit(lambda mk, t: ref_faults.compute_mask(rcfg, rst, mk, t))
    for t in range(20):
        mask = (rng.random(M) < 0.5).astype(np.float32)
        want = ref_fn(jnp.asarray(mask), jnp.int32(t))
        got = faults.compute_mask(pcfg, pst, torch.from_numpy(mask),
                                  torch.tensor(t, dtype=torch.int32))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nu_helpers_match():
    _, nu = dirichlet_partition(np.random.default_rng(0),
                                np.arange(600) % 10, 16, alpha=0.1)
    for name in ("clusters_from_nu", "adversarial_probs_from_nu"):
        want = np.asarray(getattr(ref_faults, name)(jnp.asarray(nu)))
        got = getattr(faults, name)(nu).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", av.KINDS)
def test_availability_trace_matches(kind):
    """``availability_trace`` of all five kinds over 60 rounds: equal up
    to float-compare flips (an ulp of sin or a mean), at most 2."""
    m, T = 32, 60
    base = np.random.default_rng(1).uniform(0.05, 1.0, m).astype(np.float32)
    rcfg = ref_av.AvailabilityCfg(kind=kind, gamma=0.5, period=12)
    want = np.asarray(ref_av.availability_trace(
        jax.random.PRNGKey(5), rcfg, jnp.asarray(base), T))
    got = av.availability_trace(
        prng.PRNGKey(5, "cpu"), av.AvailabilityCfg(**dataclasses.asdict(rcfg)),
        torch.from_numpy(base), T).numpy()
    assert got.shape == want.shape == (T, m)
    mismatches = int((got != want).sum())
    print(f"{kind}: {mismatches} mismatches in {T * m} draws")
    assert mismatches <= 2
    assert 0 < want.sum() < T * m


def test_diurnal_trace_matches():
    base = np.random.default_rng(2).uniform(0.05, 1.0, M).astype(np.float32)
    want = np.asarray(ref_faults.diurnal_trace(jax.random.PRNGKey(2),
                                               jnp.asarray(base), 48))
    got = faults.diurnal_trace(prng.PRNGKey(2, "cpu"),
                               torch.from_numpy(base), 48).numpy()
    mismatches = int((got != want).sum())
    print(f"diurnal: {mismatches} mismatches in {want.size} draws")
    assert mismatches <= 2


# ---------------------------------------------------------------------------
# the engine under faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [False, True], ids=["host", "chunked"])
@pytest.mark.parametrize("strategy", ["fedawe", "fedawe_m"])
def test_midround_matches_reference(strategy, chunk):
    """Mid-round dropout with sanitization, T = 6: the chunked case runs
    K = 4 (a tail chunk of 2) through the upload kernel's path; the port's
    host loop and chunked executor agree exactly."""
    kw = dict(fault=MIDROUND, chunk=chunk, use_kernel=chunk)
    port = run("port", strategy, **kw)
    assert_parity(run("ref", strategy, **kw), port)
    assert sum(r["n_dropped"] for r in port[1]) > 0
    if chunk:
        assert_same_port(run("port", strategy, fault=MIDROUND,
                             use_kernel=True), port)


@pytest.mark.parametrize("strategy", ["fedawe", "fedawe_m"])
def test_all_dropped_rounds(strategy):
    """upload_survival = 0: every update is lost, every round; the state
    stays finite, n_dropped == n_active, and the global never moves."""
    kw = dict(fault=ALL_DROPPED, T=4, use_kernel=True)
    ops.echo_aggregate_flat.upload_launches = 0
    port = run("port", strategy, **kw)
    assert ops.echo_aggregate_flat.upload_launches == 0   # CPU: plain
    assert_parity(run("ref", strategy, **kw), port)
    state, hist = port
    assert torch.equal(state.global_tr, _g0())
    assert bool(torch.isfinite(state.clients_tr).all())
    for r in hist:
        assert np.isfinite([r["loss"], r["mean_echo"]]).all()
        assert r["n_dropped"] == r["n_active"]
        assert r["n_rejected"] == 0.0
    assert sum(r["n_active"] for r in hist) > 0


@pytest.mark.parametrize("sanitize", [True, False],
                         ids=["sanitize", "negative-control"])
def test_nan_client(sanitize):
    """Client 0's shard is all-NaN and an all-ones trace keeps it active:
    sanitized, it is rejected every round and the global stays finite;
    unsanitized (the negative control), the global turns non-finite, so
    the scrub and not luck keeps it finite."""
    T = 4
    kw = dict(fault=dict(trace=True, sanitize=sanitize), T=T,
              trace=_ones_trace(T), nan_client=0, use_kernel=True)
    port = run("port", **kw)
    assert_parity(run("ref", **kw), port)
    state, hist = port
    if sanitize:
        assert bool(torch.isfinite(state.global_tr).all())
        assert bool(torch.isfinite(state.clients_tr).all())
        for r in hist:
            assert r["n_active"] == M and r["n_rejected"] == 1.0
            assert np.isfinite(r["loss"])
    else:
        assert not bool(torch.isfinite(state.global_tr).all())


def test_norm_cap_rejects_everything():
    kw = dict(fault=dict(sanitize=True, norm_cap=1e-8), T=3)
    port = run("port", **kw)
    assert_parity(run("ref", **kw), port)
    assert torch.equal(port[0].global_tr, _g0())
    for r in port[1]:
        assert r["n_rejected"] == r["n_active"]


def _random_trace(T0, seed=7):
    return (np.random.default_rng(seed).random((T0, M)) < 0.5).astype(
        np.float32)


@pytest.mark.parametrize("case", ["trace", "blackout"])
def test_trace_replay_and_blackout(case):
    """A 5-row trace replayed over 7 rounds (rows mod T); an all-ones
    trace under a recurring blackout of cluster 0 (rounds 2, 3, 6, 7)."""
    if case == "trace":
        T, tr = 7, _random_trace(5)
        kw = dict(fault=dict(trace=True), trace=tr)
        want = [tr[t % 5].sum() for t in range(T)]
    else:
        T = 8
        clusters = np.array([0, 0, 0, 1, 1, 1, 1, 0], np.int32)
        kw = dict(fault=dict(trace=True, blackout_start=2, blackout_len=2,
                             blackout_every=4, blackout_cluster=0),
                  trace=_ones_trace(T), clusters=clusters)
        want = [4.0 if t in (2, 3, 6, 7) else 8.0 for t in range(T)]
    port = run("port", T=T, **kw)
    assert_parity(run("ref", T=T, **kw), port)
    assert [r["n_active"] for r in port[1]] == want


def test_metrics_keys_contract():
    base = {"loss", "n_active", "mean_echo", "t"}
    for fault, want in ((None, base),
                        (MIDROUND, base | {"n_dropped", "n_rejected"})):
        got = set(run("port", fault=fault, T=1)[1][0])
        assert got == set(run("ref", fault=fault, T=1)[1][0]) == want
