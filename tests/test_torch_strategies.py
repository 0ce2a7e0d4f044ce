"""The port's eight baseline strategies (repro_torch/core/strategies.py)
and the engine's stateless-client round against the JAX package, on the
small problem of tests/_torch_fl_small.py from the same numpy inputs and
keys.

Held against the reference: the three FedAvg variants, FedAU, F3AST,
MIFA, FedVARP and FedAR, each synchronous, under mid-round dropout with
sanitization, under geometric staleness and under both, in the host loop
and the chunked executor.  Counts, τ, keys and ring ages bit-equal;
the global, the memories and the scalar strategy state within 1e-4.
Then the memory strategies under an all-dropped round and a NaN client,
and the port's counterparts of the reference's one-round property tests
(tests/test_strategies.py)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core.strategies import REGISTRY as REF_REGISTRY  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core import engine, strategies  # noqa: E402
from repro_torch.kernels.echo_aggregate import ops  # noqa: E402

from _torch_fl_small import (M, assert_parity,  # noqa: E402,I100
                             assert_same_port, drive, run, setup)

BASELINES = ("fedavg_active", "fedavg_all", "fedavg_known_p", "fedau",
             "f3ast", "mifa", "fedvarp", "fedar")
MEMORY = ("mifa", "fedvarp", "fedar")
MIDROUND = dict(upload_survival=0.7, sanitize=True)
ALL_DROPPED = dict(upload_survival=0.0, sanitize=True)
GEOM = dict(tau_max=4, kind="geom", p_next=0.5, gamma=0.7)
SUBSTRATES = {"sync": (None, None), "midround": (MIDROUND, None),
              "geom": (None, GEOM), "both": (MIDROUND, GEOM)}


def test_registry_matches_reference():
    """All ten, in the reference's order, with its grouping flags."""
    assert list(strategies.REGISTRY) == list(REF_REGISTRY)
    for name, ref in REF_REGISTRY.items():
        got = strategies.get_strategy(name)
        assert got.aggregate_flat is not None, name
        for field in ("stateful_clients", "memory_aided", "uses_true_probs"):
            assert getattr(got, field) == getattr(ref, field), (name, field)


# ---------------------------------------------------------------------------
# the round against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [False, True], ids=["host", "chunked"])
@pytest.mark.parametrize("substrate", list(SUBSTRATES))
@pytest.mark.parametrize("strategy", BASELINES)
def test_round_matches_reference(strategy, substrate, chunk):
    """T = 6; the chunked case runs two chunks of K = 3 (one executor to
    build in each package; tails are held in test_torch_epoch_sampler.py
    and test_torch_checkpoint.py).  The port keeps no client stack, and
    its two executors agree exactly."""
    fault, stale = SUBSTRATES[substrate]
    kw = dict(fault=fault, stale=stale, chunk=chunk, K=3)
    port = run("port", strategy, **kw)
    assert_parity(run("ref", strategy, **kw), port)
    state, hist = port
    assert state.clients_tr is None
    assert bool(torch.isfinite(state.global_tr).all())
    assert sum(r["n_active"] for r in hist) > 0
    if fault is not None:
        assert sum(r["n_dropped"] for r in hist) > 0
    if stale is not None:
        assert sum(r["n_stale"] for r in hist) > 0
    if chunk:
        assert_same_port(run("port", strategy, fault=fault, stale=stale),
                         port)


@pytest.mark.parametrize("strategy", BASELINES)
def test_baselines_ignore_use_kernel(strategy):
    """``use_kernel`` launches nothing for a baseline and changes no bit
    (the kernel path is FedAWE's server update alone)."""
    ops.echo_aggregate_flat.launches = 0
    ops.echo_aggregate_flat.upload_launches = 0
    got = run("port", strategy, fault=MIDROUND, use_kernel=True)
    assert ops.echo_aggregate_flat.launches == 0
    assert ops.echo_aggregate_flat.upload_launches == 0
    assert_same_port(run("port", strategy, fault=MIDROUND), got)


@pytest.mark.parametrize("strategy", MEMORY)
def test_memory_all_dropped(strategy):
    """upload_survival = 0: nothing is delivered, so the memory stays
    zero, τ stays -1 and the global never moves."""
    kw = dict(fault=ALL_DROPPED, T=4)
    port = run("port", strategy, **kw)
    assert_parity(run("ref", strategy, **kw), port)
    state, hist = port
    assert torch.equal(state.global_tr, run("port", strategy, T=0)[0]
                       .global_tr)
    (mem,) = state.extra.values()
    assert mem.shape == (M, state.spec.size) and not mem.any()
    assert (state.tau == -1).all()
    for r in hist:
        assert r["n_dropped"] == r["n_active"]
    assert sum(r["n_active"] for r in hist) > 0


@pytest.mark.parametrize("stale", [None, GEOM], ids=["sync", "geom"])
@pytest.mark.parametrize("strategy", MEMORY)
def test_memory_nan_client(strategy, stale):
    """Client 0's shard is all-NaN and an all-ones trace keeps it
    active: sanitization rejects it every round, its memory row stays
    zero and finite, and the global stays finite."""
    T = 4
    kw = dict(fault=dict(trace=True, sanitize=True), stale=stale, T=T,
              trace=np.ones((T, M), np.float32), nan_client=0)
    port = run("port", strategy, **kw)
    assert_parity(run("ref", strategy, **kw), port)
    state, hist = port
    (mem,) = state.extra.values()
    assert bool(torch.isfinite(mem).all()) and not mem[0].any()
    assert bool(torch.isfinite(state.global_tr).all())
    assert state.tau[0] == -1
    if stale is None:
        assert all(r["n_rejected"] == 1.0 for r in hist)
    assert sum(r["n_rejected"] for r in hist) >= 1


# ---------------------------------------------------------------------------
# the stateless round's start: a broadcast view, never a copy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["fedawe"] + list(BASELINES))
def test_stateless_round_starts_from_a_view_of_the_global(strategy,
                                                          monkeypatch):
    """A stateless strategy keeps ``clients_tr = None``; local SGD gets
    stride-0 views of the flat global (no [m, N] copy), and every client
    starts from the global.  FedAWE keeps and starts from its stack."""
    seen = []
    real = engine.local_sgd

    def spy(trainable, *a, **kw):
        seen.append(trainable)
        return real(trainable, *a, **kw)

    monkeypatch.setattr(engine, "local_sgd", spy)
    parts = setup("port", strategy)
    fresh = parts["state"]
    state, _ = drive("port", parts, 1)
    stateless = not strategies.get_strategy(strategy).stateful_clients
    assert (state.clients_tr is None) == stateless
    assert (core.client_trainables(state) is None) == stateless
    leaves = [seen[0]["w"], seen[0]["b"]]
    if stateless:
        ptr = fresh.global_tr.untyped_storage().data_ptr()
        for leaf in leaves:
            assert leaf.stride(0) == 0
            assert leaf.untyped_storage().data_ptr() == ptr
    else:
        assert all(leaf.stride(0) != 0 for leaf in leaves)
    g = fresh.spec.unflatten(fresh.global_tr)
    for leaf, want in zip(leaves, (g["w"], g["b"])):
        for i in range(M):
            assert torch.equal(leaf[i], want)


# ---------------------------------------------------------------------------
# one-round properties (tests/test_strategies.py's, on the flat path)
# ---------------------------------------------------------------------------

def _aggregate(name, G, mask, extra, *, global_flat=None, probs=None, t=0,
               tau=None):
    m = G.shape[0]
    if global_flat is None:
        global_flat = torch.zeros(G.shape[1])
    return strategies.get_strategy(name).aggregate_flat(
        global_flat=global_flat, clients_flat=None, x_end=None, G=G,
        mask=mask, t=torch.tensor(t, dtype=torch.int32),
        tau=(torch.full((m,), -1, dtype=torch.int32) if tau is None
             else tau),
        probs=probs, extra=extra, eta_g=1.0)


def test_mifa_memory_updates_only_active():
    strat = strategies.get_strategy("mifa")
    m, d = 4, 3
    extra = strat.init_extra(torch.zeros(d), m)
    mask = torch.tensor([1.0, 0.0, 1.0, 0.0])
    _, clients, tau, new_extra = _aggregate("mifa", torch.ones(m, d), mask,
                                            extra)
    mem = new_extra["mem"].numpy()
    np.testing.assert_allclose(mem[0], 1.0)
    np.testing.assert_allclose(mem[1], 0.0)  # inactive keeps old memory
    assert clients is None
    assert tau.tolist() == [0, -1, 0, -1]


def test_fedvarp_uses_memory_for_inactive():
    strat = strategies.get_strategy("fedvarp")
    m = 2
    extra = strat.init_extra(torch.zeros(1), m)
    # round 0: both active, G = [1, 3]
    g, _, _, extra = _aggregate("fedvarp", torch.tensor([[1.0], [3.0]]),
                                torch.tensor([1.0, 1.0]), extra)
    np.testing.assert_allclose(g.numpy(), [-2.0])  # mean update
    # round 1: only client 0 active; the memory covers client 1 (its 99
    # is ignored)
    g, _, _, extra = _aggregate(
        "fedvarp", torch.tensor([[1.0], [99.0]]), torch.tensor([1.0, 0.0]),
        extra, global_flat=g, t=1,
        tau=torch.tensor([0, 0], dtype=torch.int32))
    # update = (G0_0 - y_0) + mean(y) = (1 - 1) + 2 = 2 -> g = -2 - 2 = -4
    np.testing.assert_allclose(g.numpy(), [-4.0])
    np.testing.assert_allclose(extra["y"].numpy(), [[1.0], [3.0]])


def test_known_p_weighting():
    g, _, _, _ = _aggregate("fedavg_known_p", torch.ones(2, 1),
                            torch.tensor([1.0, 1.0]), (),
                            probs=torch.tensor([0.5, 0.25]))
    # update = (1/m) * (G0/p0 + G1/p1) = (2 + 4)/2 = 3
    np.testing.assert_allclose(g.numpy(), [-3.0])


def test_fedau_interval_estimation_converges():
    """FedAU's interval estimate approaches 1/p for stationary clients;
    its cutoff K stays a 0-d float32 tensor."""
    strat = strategies.get_strategy("fedau")
    m = 2
    p = np.array([0.5, 0.25])
    extra = strat.init_extra(torch.zeros(1), m)
    rng = np.random.default_rng(0)
    g = torch.zeros(1)
    for t in range(600):
        mask = torch.from_numpy((rng.random(m) < p).astype(np.float32))
        g, _, _, extra = _aggregate("fedau", torch.zeros(m, 1), mask, extra,
                                    global_flat=g, t=t)
    np.testing.assert_allclose(extra["omega"].numpy(), 1.0 / p, rtol=0.2)
    assert extra["K"].shape == () and extra["K"].dtype == torch.float32
    assert float(extra["K"]) == 50.0


def test_stateless_strategies_broadcast_global():
    """After a stateless round every client starts the next from the new
    global: the client trees are the global, row for row."""
    state, _ = run("port", "fedavg_active", T=2)
    clients = state.global_tr[None].expand(M, state.spec.size)
    tree = state.spec.unflatten_stacked(clients)
    g = core.global_trainables(state)
    for i in range(M):
        for k in g:
            assert torch.equal(tree[k][i], g[k])
    assert state.clients_tr is None


def test_scalar_state_lives_on_the_device_of_the_global():
    """FedAU's K and F3AST's beta are 0-d float32 tensors beside the
    global, never Python floats (the round must not read them on the
    host, and checkpoints carry them)."""
    g = torch.zeros(5)
    for name, key, value in (("fedau", "K", 50.0), ("f3ast", "beta", 0.001),
                             ("fedawe_m", "beta", 0.9)):
        extra = strategies.get_strategy(name).init_extra(g, 3)
        leaf = extra[key]
        assert torch.is_tensor(leaf) and leaf.shape == ()
        assert leaf.dtype == torch.float32 and leaf.device == g.device
        assert float(leaf) == pytest.approx(value)
