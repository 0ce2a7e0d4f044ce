"""The tree-state placed round (``TreePlacement``, ``sharding/placement.py``;
``core/engine.py``, ``core/strategies.aggregate_placed``) on the CPU: four
``gloo`` processes (``tests/_torch_tree_placed_worker.py``, spawned once
for every case, a ``FileStore`` in tmp, no ports) on the ``(2, 2)``
('data', 'model') test mesh, ``tiny`` in float32, m = 8 (four client rows
a rank, each leaf's model dims over two 'model' ranks), 2 rounds:

  * FedAWE with and without ``use_kernel`` (on the CPU the partial form's
    plain version, the all-reduce and the finalize's), FedAWE under
    faults (dropout and sanitization, whose norms sum over 'model'),
    MIFA, a reduced Mamba2 under ``dp_client`` (the mixer's region
    over a batch split on 'model', its weights' gradients partial sums),
    and under the baseline the training splits of what would run
    replicated over 'model' (a gemma2-like config with one kv head, the
    attention over the batch; a Mamba2 with an odd tied vocab, the mixer
    over the batch and the loss over the tokens; both on a (1, 4) mesh
    too, with two kv heads: rows x head groups; a reduced gemma3-27b's
    adapters over its frozen base), against the port's
    unplaced tree round on the same inputs: the
    global and every client leaf within 1e-5, τ, markov, the key, t and
    the counts bit-equal, the client leaves' placements those of
    ``client_stack_pspecs`` after each round; FedAWE against the
    reference's unsharded tree round within 1e-4;
  * the dry run's knobs: ``dp_client`` (weights replicated over 'model',
    the batch over it) and ``zero_client`` (``tp`` storage, the ``dp``
    batch) equal the baseline's globals within 1e-5; a rank holds more
    state bytes under ``dp_client``, the same under ``zero_client``;
  * every strategy's flat aggregate is columnwise in N: on column shards
    it gives the whole aggregate's columns, so none needs a sum over
    'model' under a placement;
  * the placement checks: tree state needs a ``TreePlacement``, no
    placement takes the cohort.

The dry run's tree step (``launch/dryrun.py``) is
``tests/test_torch_dryrun_lowering.py``'s."""
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_tree_placed_worker as W  # noqa: E402,I100
from repro_torch.core.tree_util import tree_leaves  # noqa: E402

#: the spawn's hang guard: the ranks run every case (about 25 s alone,
#: 90 s beside six busy test workers)
RANKS, JOIN_S = 4, 240
ROUNDS_VS_UNPLACED = ("fedawe", "fedawe/kernel", "fedawe/faults", "mifa",
                      "mamba2/dp_client", "gemma2/kv1", "mamba2/vocab509",
                      "gemma2/kv2@1x4", "mamba2/vocab509@1x4",
                      "gemma3/lora")
KNOBS = ("fedawe/dp_client", "fedawe/zero_client")
EXACT = ("n_active", "n_dropped", "n_rejected")
STRATEGIES = ("fedawe", "fedawe_m", "fedavg_active", "fedavg_all",
              "fedavg_known_p", "fedau", "f3ast", "mifa", "fedvarp", "fedar")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread while this module runs: its operations are
    small, and with several test processes sharing the cores the threads
    of every process would wait on each other (a tiny round takes 7 s on
    eight threads beside other work, 0.2 s on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights():
    """The reference's ``tiny`` weights (its ``init_params``), as numpy."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.models import model as jm

    jp = jm.init_params(jax.random.PRNGKey(1), jget_config("tiny"))
    return jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    """The weights and every case's results, per rank; the ranks spawned
    once, each group joined within ``JOIN_S``."""
    import torch.multiprocessing as mp

    tmp = str(tmp_path_factory.mktemp("tree-placed"))
    weights = _weights()
    path = os.path.join(tmp, "weights.pt")
    torch.save(weights, path)
    ctx = mp.start_processes(
        W.run_rank, args=(RANKS, os.path.join(tmp, "store"), tmp, path,
                          list(W.CASES)),
        nprocs=RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, \
                f"ranks still running after {JOIN_S} s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                        weights_only=False) for r in range(RANKS)]
    return weights, ranks


@pytest.fixture(scope="module")
def unplaced(placed):
    done = {}

    def get(name):
        if name not in done:
            done[name] = W.run_case(name, placed[0])
        return done[name]

    return get


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _assert_matches(ranks, name, want, tol=1e-5):
    """Every rank's results of case ``name`` against ``want``, a whole
    run: globals and the rank's client rows within ``tol``, τ and markov
    rows, the key and t bit-equal, metrics (counts exact)."""
    case = W.CASES.get(name, {})
    data = case.get("mesh", (2, 2))[0]
    m, rounds = case.get("m", W.M), case.get("rounds", W.ROUNDS)
    for res in ranks:
        got = res[name]
        lo, hi = got["rows"]
        assert hi - lo == m // data
        for a, b in zip(tree_leaves(got["global_tr"]),
                        tree_leaves(want["global_tr"])):
            assert a.shape == b.shape and a.dtype == b.dtype
            _close(a, b, tol)
        for a, b in zip(tree_leaves(got["clients"]),
                        tree_leaves(want["clients"])):
            _close(a, b[lo:hi], tol)
        assert torch.equal(got["tau"], want["tau"][lo:hi])
        assert torch.equal(got["markov"], want["markov"][lo:hi])
        assert torch.equal(got["rng"], want["rng"])
        assert int(got["t"]) == int(want["t"]) == rounds
        assert len(got["history"]) == len(want["history"]) == rounds
        for g, w in zip(got["history"], want["history"]):
            assert set(g) == set(w)
            for k in w:
                if k in EXACT:
                    assert g[k] == w[k], (k, g[k], w[k])
                else:
                    _close(g[k], w[k], tol)


@pytest.mark.parametrize("name", ROUNDS_VS_UNPLACED)
def test_placed_tree_round_matches_the_unplaced_round(placed, unplaced,
                                                      name):
    ranks = placed[1]
    _assert_matches(ranks, name, unplaced(name))
    for res in ranks:
        assert res[name]["kept"] == [True] * len(res[name]["history"])


@pytest.mark.parametrize("name", KNOBS)
def test_knobs_match_the_baseline_and_hold_their_bytes(placed, name):
    """``dp_client`` and ``zero_client`` compute the baseline's round:
    globals within 1e-5 of the placed baseline's (and the unplaced
    run's); a rank's state bytes grow under ``dp_client`` (its leaves
    whole over 'model') and stay under ``zero_client``."""
    for res in placed[1]:
        got, base = res[name], res["fedawe"]
        for a, b in zip(tree_leaves(got["global_tr"]),
                        tree_leaves(base["global_tr"])):
            _close(a, b, 1e-5)
        assert got["kept"] == [True] * W.ROUNDS
        if name.endswith("dp_client"):
            assert got["state_bytes"] > base["state_bytes"]
        else:
            assert got["state_bytes"] == base["state_bytes"]


def test_placed_tree_round_matches_the_reference(placed):
    """The placed FedAWE round against the reference's unsharded tree
    round on the same weights, keys and batches: the global within
    1e-4, τ, the key and the counts equal."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.core import AvailabilityCfg as JAvailabilityCfg
    from repro.core import FLConfig as JFLConfig
    from repro.core import init_fl_state as j_init_fl_state
    from repro.core import make_round_fn as j_make_round_fn
    from repro.models import model as jm

    weights, ranks = placed
    jcfg = jget_config("tiny")
    fl = JFLConfig(s=jcfg.local_steps, **W.FL)
    jp = jax.tree.map(jnp.asarray, weights)
    state = j_init_fl_state(jax.random.PRNGKey(3), fl, jp)
    round_fn = jax.jit(j_make_round_fn(
        fl, lambda tr, fz, bb, key: jm.lm_loss(tr, jcfg, bb), {},
        JAvailabilityCfg(kind="sine", gamma=0.3, period=4),
        jnp.full((W.M,), 0.6)))
    hist = []
    for t in range(W.ROUNDS):
        state, metrics = round_fn(state, {
            k: jnp.asarray(v.numpy())
            for k, v in W.batches(jcfg, t).items()})
        hist.append({k: float(v) for k, v in metrics.items()})
    want = jax.tree.map(np.asarray, state.global_tr)
    for res in ranks:
        got = res["fedawe"]
        lo, hi = got["rows"]
        for a, b in zip(tree_leaves(got["global_tr"]), jax.tree.leaves(want)):
            _close(a, b, 1e-4)
        assert np.array_equal(got["tau"].numpy(),
                              np.asarray(state.tau)[lo:hi])
        assert np.array_equal(got["rng"].numpy(), np.asarray(state.rng))
        for g, w in zip(got["history"], hist):
            assert g["n_active"] == w["n_active"]
            _close(g["loss"], w["loss"], 1e-4)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_flat_aggregates_are_columnwise(strategy):
    """Each strategy's ``aggregate_flat`` on two column blocks gives the
    whole call's columns (the memories' and FedAWE-M's velocity too):
    ``aggregate_placed`` may run it on a rank's shards over 'model'
    without a sum over them."""
    from repro_torch.core.strategies import get_strategy

    strat = get_strategy(strategy)
    rng = np.random.default_rng(7)
    m, n, cut = 6, 40, 17

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    clients, x_end, glob = t(m, n), t(m, n), t(n)
    G = clients - x_end
    mask = torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.float32)
    extra = strat.init_extra(glob, m)
    if isinstance(extra, dict):
        extra = {k: (t(*v.shape) if v.dim() and v.shape[-1] == n else v)
                 for k, v in extra.items()}
    kw = dict(mask=mask, t=torch.tensor(5, dtype=torch.int32),
              tau=torch.tensor([0, 1, -1, 3, 2, 4], dtype=torch.int32),
              probs=torch.full((m,), 0.5), eta_g=1.0)

    def run(cols):
        ex = extra
        if isinstance(extra, dict):
            ex = {k: (v[..., cols] if v.dim() and v.shape[-1] == n else v)
                  for k, v in extra.items()}
        return strat.aggregate_flat(
            global_flat=glob[cols], clients_flat=clients[:, cols],
            x_end=x_end[:, cols], G=G[:, cols], extra=ex, **kw)

    whole = run(slice(None))
    parts = [run(slice(0, cut)), run(slice(cut, None))]
    for i, w in enumerate(whole[:2]):
        if w is None:
            assert parts[0][i] is None
            continue
        torch.testing.assert_close(
            torch.cat([p[i] for p in parts], -1), w, rtol=0, atol=1e-6)
    assert torch.equal(parts[0][2], whole[2])
    if isinstance(whole[3], dict):
        for k, w in whole[3].items():
            if w.dim() and w.shape[-1] == n:
                torch.testing.assert_close(
                    torch.cat([p[3][k] for p in parts], -1), w, rtol=0,
                    atol=1e-6)


def test_placement_checks():
    """Tree state under a placement needs a ``TreePlacement``; no
    placement takes the sparse cohort; a placement's m is the config's."""
    from repro_torch.core import FLConfig, init_fl_state, prng
    from repro_torch.sharding.placement import ClientPlacement

    place = ClientPlacement(m=8, lo=0, hi=4, group="unused")
    tr = {"w": torch.zeros(3)}
    with pytest.raises(ValueError, match="TreePlacement"):
        init_fl_state(prng.PRNGKey(0, "cpu"), FLConfig(m=8), tr, place=place)
    with pytest.raises(ValueError, match="sparse cohort"):
        init_fl_state(prng.PRNGKey(0, "cpu"),
                      FLConfig(m=8, flat_state=True, sparse_cohort=2), tr,
                      place=place)
    with pytest.raises(ValueError, match="8 clients"):
        init_fl_state(prng.PRNGKey(0, "cpu"),
                      FLConfig(m=6, flat_state=True), tr, place=place)
